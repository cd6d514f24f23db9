"""Struct-of-arrays hot-path state shared by every fast lane.

Two small structures carry the m4-style array-native substrate the
packet/sharded/hybrid/analytic layers now share:

* :class:`FlowTable` — per-flow *static* routing data in CSR form (one
  int64 port-id row per flow).  Every max-min solve — the hybrid
  demotion lane, the analytic backend's event loop, the learned feature
  extractor — concatenates the relevant rows and calls the vectorized
  solver (``repro_torch.kernels.maxmin``) directly, instead of rebuilding a
  ``{fid: [ports]}`` dict per solve.  Row order is preserved exactly as
  the caller iterates fids: link first-appearance order seeds the
  solver's tie-breaks, which is part of the bit-identity contract with
  the historical dict solver.

* :class:`LaneState` — one partition's event lane (binary heap + lane-
  local seq counter) with *batched run draining*: :meth:`LaneState.pop_run`
  pops the maximal run of same-timestamp events at the heap top in one
  call, so the lane executors process a whole burst (a collective's
  same-instant SEND wave, an ACK-triggered send at the ACK's own
  timestamp) per guard check instead of re-validating the window bounds
  event by event — the event-loop analogue of how ``steady_scan``
  replaced the scalar steady detector.  Within a run the serial
  ``(t, seq)`` order is preserved verbatim, which is what keeps the
  sharded/hybrid loops bit-identical to the seed serial loop.

Per-flow *dynamic* state stays on :class:`~repro_torch.net.packet_sim.FlowRT`
(now ``slots=True``): CCA state machines are inherently scalar per-ACK
recursions, so vectorizing them would change the simulated events —
the hard invariant this refactor must not touch.

Copy of ``repro.net.soa``, which the port may not import.
"""
from __future__ import annotations

import heapq
from collections.abc import Iterable, Mapping

import numpy as np

from repro_torch.hotpath import hot_path
from repro_torch.kernels.maxmin.ops import maxmin_rates_arrays


class FlowTable:
    """CSR flow→path table: the struct-of-arrays face of the solver.

    ``add`` is called once per flow at admission; ``solve_rates`` is the
    hot entry — called per hybrid demotion/re-solve and per analytic
    event — and is bit-identical to
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


class LaneState:
    """One partition's event stream: a local heap + lane-local seq counter.
    Seqs only break same-timestamp ties *within* the lane; cross-lane
    ordering is irrelevant because partitions share no ports."""

    __slots__ = ("pid", "heap", "seq")

    def __init__(self, pid: int) -> None:
        self.pid = pid
        self.heap: list = []
        self.seq = 0

    @hot_path
    def push(self, t: float, kind: int, payload: tuple) -> None:
        self.seq += 1
        heapq.heappush(self.heap, (t, self.seq, kind, payload))

    @hot_path
    def pop_run(self, max_seq: int | None = None) -> list:
        """Pop the maximal same-timestamp run at the heap top, in (t, seq)
        order.  The caller has already admitted the top event against its
        window bounds; every same-``t`` follow-up passes the same ``t``
        checks by construction, so the whole run drains under one guard.
        ``max_seq`` carries the serial loop's shrunk-barrier watermark:
        events at the barrier timestamp scheduled *after* the shrink
        (seq > watermark) must rest in the lane."""
        heap = self.heap
        ev = heapq.heappop(heap)
        run = [ev]
        t0 = ev[0]
        if max_seq is None:
            while heap and heap[0][0] == t0:
                run.append(heapq.heappop(heap))
        else:
            while heap and heap[0][0] == t0 and heap[0][1] <= max_seq:
                run.append(heapq.heappop(heap))
        return run
