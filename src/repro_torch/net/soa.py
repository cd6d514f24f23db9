"""Struct-of-arrays flow paths: the face of the max-min solver.

Copy of ``repro.net.soa.FlowTable``, which the port may not import.  The
reference's ``LaneState`` (the event lanes of the partition-sharded loop)
comes with that loop, which is not ported yet.

:class:`FlowTable` holds per-flow *static* routing data in CSR form (one
int64 port-id row per flow), registered by the packet oracle and the
analytic engine alike.  Every max-min solve of the analytic engine
concatenates the rows of the active flows and calls the exact solver
(``repro_torch.kernels.maxmin``) directly, instead of rebuilding a
``{fid: [ports]}`` dict per solve.  Row order is preserved exactly as the
caller iterates fids: link first-appearance order seeds the solver's
tie-breaks, which is part of the bit-identity contract with the historical
dict solver.
"""
from __future__ import annotations

from collections.abc import Iterable, Mapping

import numpy as np

from repro_torch.hotpath import hot_path
from repro_torch.kernels.maxmin.ops import maxmin_rates_arrays


class FlowTable:
    """CSR flow→path table.

    ``add`` is called once per flow at admission; ``solve_rates`` is the
    hot entry, called per analytic event, and is bit-identical to
    ``maxmin_rates({fid: path for fid in fids}, link_bw)``.
    """

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

    @hot_path
    def csr(self, fids: Iterable[int]) -> tuple[list[int], np.ndarray, np.ndarray]:
        """(fids, path_links, path_off) over ``fids`` in iteration order."""
        fids = list(fids)
        paths = self._paths
        off = np.zeros(len(fids) + 1, dtype=np.int64)
        chunks = []
        n = 0
        for i, fid in enumerate(fids):
            p = paths[fid]
            n += len(p)
            off[i + 1] = n
            if len(p):
                chunks.append(p)
        links = (np.concatenate(chunks) if chunks
                 else np.zeros(0, dtype=np.int64))
        return fids, links, off

    @hot_path
    def solve_rates(self, fids: Iterable[int], link_bw) -> dict[int, float]:
        """Max-min fair rates for ``fids`` (iteration order preserved —
        it seeds the solver's link tie-breaks) over ``link_bw``."""
        fids, links, off = self.csr(fids)
        rates = maxmin_rates_arrays(links, off, link_bw)
        return dict(zip(fids, rates.tolist()))

    def verify_against(self, flows: Mapping[int, object]) -> None:
        """Parity guard for property tests: every registered row must
        mirror its flow object's ``path`` exactly."""
        for fid, row in self._paths.items():
            f = flows.get(fid)
            if f is None:
                continue
            assert list(row) == list(f.path), \
                f"FlowTable row for flow {fid} diverged from FlowRT.path"
