"""Arch registry: ``--arch <id>`` ids → ArchConfig."""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.configs.deepseek_v3_671b import CONFIG as _deepseek
from repro_torch.configs.gemma3_27b import CONFIG as _gemma
from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba
from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.mistral_large_123b import CONFIG as _mlarge
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (
    _xlstm, _mixtral, _deepseek, _llava, _granite,
    _nemo, _mlarge, _gemma, _jamba, _whisper,
)}


def get(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise SystemExit(
            f"unknown --arch {name!r}; available: {sorted(ARCHS)}") from None


def cells():
    """All (arch, shape) dry-run cells, with skip reasons where applicable."""
    out = []
    for name, cfg in ARCHS.items():
        for sname, shape in SHAPES.items():
            skip = None
            if sname == "long_500k" and not cfg.subquadratic:
                skip = "pure full-attention (or out-of-modality): quadratic at 500k"
            out.append((name, sname, skip))
    return out
