"""Analytic flow-level backend: progressive max-min fair sharing.

Copy of ``repro.api.analytic``, which the port may not import.  No packets,
no CCA dynamics: at every discrete event (flow arrival, flow completion,
workload timer) the active flows get their max-min fair-share rates via
water-filling over the topology's directed links, and state advances
linearly to the next event.  This is the classic flow-level abstraction the
paper benchmarks against (~20% FCT error, §2.2).

The simulator runs on the host in float64, through the exact solver
(``repro_torch.kernels.maxmin.maxmin_rates_arrays``), as the reference
does: its results are the reference's bit for bit.  The dense float32
solver on the card (``maxmin_rates_torch``) computes the same rates to
about 1e-4 relative and is not used here, since that would be a different
result.

``AnalyticSim`` provides the slice of the packet simulator the workload
layer touches (``add_flow`` / ``call_at`` / ``finish_listeners`` / ``run``
/ ``results``), so :class:`~repro_torch.workload.driver.WorkloadDriver`
drives it.
"""
from __future__ import annotations

import heapq
import itertools

from repro_torch.net.flows import FlowResult, FlowSpec, maxmin_rates
from repro_torch.net.soa import FlowTable
from repro_torch.net.topology import Topology

__all__ = ["AnalyticSim", "maxmin_rates"]   # solver lives in repro_torch.net.flows

_EPS = 1e-12


class _AFlow:
    __slots__ = ("spec", "path", "remaining", "rate", "start_actual")

    def __init__(self, spec: FlowSpec, path: list[int]) -> None:
        self.spec = spec
        self.path = path
        self.remaining = spec.size
        self.rate = 0.0
        self.start_actual = 0.0

    @property
    def fid(self) -> int:
        return self.spec.fid


class AnalyticSim:
    def __init__(self, topo: Topology, **_ignored) -> None:
        self.topo = topo
        self.now = 0.0
        self.events_processed = 0       # rate recomputations (events)
        self.flow_table = FlowTable()   # SoA paths: the solver's direct input
        self.flows: dict[int, _AFlow] = {}
        self.active: dict[int, _AFlow] = {}
        self.results: dict[int, FlowResult] = {}
        self.finish_listeners: list = []
        self._heap: list = []
        self._seq = itertools.count()

    # ------------------------------------------------------------------ #
    def add_flow(self, spec: FlowSpec) -> _AFlow:
        path = self.topo.route(spec.src, spec.dst, spec.fid)
        if not path:
            raise ValueError(f"flow {spec.fid}: src==dst ({spec.src})")
        f = _AFlow(spec, path)
        self.flows[spec.fid] = f
        self.flow_table.add(spec.fid, path)
        heapq.heappush(self._heap,
                       (max(spec.start, self.now), next(self._seq), "start", f))
        return f

    def call_at(self, t: float, fn) -> None:
        heapq.heappush(self._heap, (max(t, self.now), next(self._seq), "call", fn))

    # ------------------------------------------------------------------ #
    def _maxmin_rates(self) -> None:
        """Water-filling over the active set, via the struct-of-arrays
        :class:`~repro_torch.net.soa.FlowTable`."""
        rates = self.flow_table.solve_rates(self.active, self.topo.link_bw)
        for fid, r in rates.items():
            self.active[fid].rate = r

    def _advance(self, dt: float) -> None:
        if dt <= 0:
            return
        for f in self.active.values():
            f.remaining -= f.rate * dt

    def _finish(self, f: _AFlow, t: float) -> None:
        self.active.pop(f.fid, None)
        f.remaining = 0.0
        self.results[f.fid] = FlowResult(
            fid=f.fid, start=f.start_actual, fct=t - f.start_actual,
            bytes=f.spec.size, tag=f.spec.tag)
        for cb in self.finish_listeners:
            cb(f, t)

    # ------------------------------------------------------------------ #
    def run(self, until: float = float("inf")) -> None:
        while self._heap or self.active:
            next_t = self._heap[0][0] if self._heap else float("inf")
            if self.active:
                self._maxmin_rates()
                self.events_processed += 1
                t_fin = min(self.now + f.remaining / max(f.rate, _EPS)
                            for f in self.active.values())
                t_next = min(t_fin, next_t)
                if t_next > until:
                    self._advance(until - self.now)
                    self.now = until
                    return
                self._advance(t_next - self.now)
                self.now = t_next
                done = [f for f in self.active.values()
                        if f.remaining <= 1e-6 * f.spec.size + 1e-3]
                if done:
                    for f in done:
                        self._finish(f, self.now)
                    continue            # rates changed: recompute before events
            else:
                if next_t > until:
                    return
                self.now = next_t
            # drain every event at exactly this instant, then recompute rates
            while self._heap and self._heap[0][0] <= self.now + _EPS:
                _, _, kind, payload = heapq.heappop(self._heap)
                self.events_processed += 1
                if kind == "start":
                    payload.start_actual = self.now
                    self.active[payload.fid] = payload
                else:
                    payload(self.now)

    def all_done(self) -> bool:
        return all(fid in self.results for fid in self.flows)
