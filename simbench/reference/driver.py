"""Phase-DAG driver: injects flows into the simulator as dependencies
resolve.  From the Wormhole kernel's perspective these launches are
*real-time interrupt events* (§5.3) — they cannot be known ahead of time, so
they exercise the skip-back machinery exactly like the paper's live-digital-
twin scenario.

Frozen copy of ``src/repro/workload/driver.py``, the JAX package's pure-Python
module (no JAX in it), which the port's tests hold the port to; part of
the benchmark's plain reference: its imports are rewritten to stay inside
``simbench``, and it imports neither the program nor the JAX package."""
from __future__ import annotations

import dataclasses

from simbench.reference.packet_sim import PacketSim
from simbench.reference.traffic import Phase


class WorkloadDriver:
    def __init__(self, sim: PacketSim, phases: list[Phase], t0: float = 0.0) -> None:
        self.sim = sim
        self.phases = phases
        self.remaining = [len(p.flows) for p in phases]
        self.done_t: list[float | None] = [None] * len(phases)
        self.launched = [False] * len(phases)
        self.pending_deps = [len(set(p.deps)) for p in phases]
        self.dependents: list[list[int]] = [[] for _ in phases]
        for j, p in enumerate(phases):
            for d in sorted(set(p.deps)):
                self.dependents[d].append(j)
        self.fid2phase: dict[int, int] = {}
        sim.finish_listeners.append(self._on_finish)
        self._t0 = t0
        for i, p in enumerate(phases):
            if not p.deps:
                self._launch(i, t0)

    # ------------------------------------------------------------------ #
    def _launch(self, i: int, t: float) -> None:
        if self.launched[i]:
            return
        self.launched[i] = True
        p = self.phases[i]
        start = t + p.compute
        if not p.flows:
            self.sim.call_at(start, lambda now, i=i: self._complete(i, now))
            return
        for fl in p.flows:
            self.fid2phase[fl.fid] = i
            self.sim.add_flow(dataclasses.replace(fl, start=start, phase=i))

    def _on_finish(self, flow, t: float) -> None:
        i = self.fid2phase.get(flow.fid)
        if i is None:
            return
        self.remaining[i] -= 1
        if self.remaining[i] == 0:
            self._complete(i, t)

    def _complete(self, i: int, t: float) -> None:
        self.done_t[i] = t
        for j in self.dependents[i]:
            self.pending_deps[j] -= 1
            if self.pending_deps[j] == 0:
                ready_t = max(self.done_t[d] for d in set(self.phases[j].deps))
                self._launch(j, ready_t)

    # ------------------------------------------------------------------ #
    @property
    def finished(self) -> bool:
        return all(d is not None for d in self.done_t)

    @property
    def iteration_time(self) -> float:
        assert self.finished, "program still running"
        return max(t for t in self.done_t if t is not None) - self._t0
