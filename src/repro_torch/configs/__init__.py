"""Architecture configs: one module per assigned architecture (+ the paper's
own Table-1 workloads live in repro_torch.workload.presets).  Use
``repro_torch.configs.registry.get(name)`` / ``--arch <id>`` in the launchers."""

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell
from repro_torch.configs.registry import ARCHS, get
