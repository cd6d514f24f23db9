"""Flow specifications handed to the engines by the workload layer.

Copy of ``repro.net.flows.FlowSpec``; the max-min wrappers of that module
come with the analytic engine."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FlowSpec:
    fid: int
    src: int
    dst: int
    size: float                 # bytes
    start: float = 0.0          # seconds (may be rescheduled by the traffic DAG)
    cca: str = "dctcp"
    tag: str = ""               # e.g. "dp.allreduce.l3" — used for grouping in reports
    phase: int = -1             # traffic-program phase index (-1: standalone)

    def __post_init__(self) -> None:
        if not self.size > 0:
            raise ValueError(f"flow size must be positive, got {self.size}")
