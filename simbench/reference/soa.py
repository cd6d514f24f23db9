"""The per-flow routing table the packet oracle fills.

Frozen copy of the admission half of ``FlowTable`` in
``src/repro/net/soa.py``, the JAX package's pure-Python module, which the
port's tests hold the port to; part of the benchmark's plain reference.
The packet oracle only adds rows, so the solver entry points there are left
out, and nothing here imports the program or the JAX package."""
from __future__ import annotations

import numpy as np


class FlowTable:
    """CSR flow→path table (admission only)."""

    __slots__ = ("_paths",)

    def __init__(self) -> None:
        self._paths: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self._paths)

    def __contains__(self, fid: int) -> bool:
        return fid in self._paths

    def add(self, fid: int, path) -> None:
        self._paths[fid] = np.asarray(path, dtype=np.int64)

    def path_links(self, fid: int) -> np.ndarray:
        return self._paths[fid]
