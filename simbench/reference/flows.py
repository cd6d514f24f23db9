"""Flow specifications handed to the engines by the workload layer.

Frozen copy of the ``FlowSpec`` and ``FlowResult`` of ``src/repro/net/flows.py``,
the JAX package's pure-Python module, which the port's tests hold the port
to; part of the benchmark's plain reference.  The flow-level solver beside
them there is left out, the size check raises instead of asserting, and
nothing here imports the program or the JAX package."""
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


@dataclasses.dataclass
class FlowResult:
    fid: int
    start: float
    fct: float                  # flow completion time (seconds, absolute finish - start)
    bytes: float
    tag: str = ""

    @property
    def finish(self) -> float:
        return self.start + self.fct
