"""A plain DCTCP fluid model and the phase-DAG schedule, in NumPy.

The reference for the fluid backend, written from its equations and not
from its code.  For each phase with flows: route every flow by the frozen
ECMP rule, take the flow x link incidence M of the links they cross, and
run ``steps`` control intervals of dt = the median base RTT from line-rate
windows, alpha 1 and empty queues:

    link marks      p_l = clip((q - K) / 2K, 0, 1)
    flow signals    p_f = max over the flow's links of p_l
    RTT             rtt = rtt0 + M (q / C)
    DCTCP           alpha <- (1 - g n) alpha + g n p_f,    n = dt / rtt
                    W <- min(max(W + mss n (1 - p_f) - p_f alpha W n / 2, mss), 2 line rtt0)
    rate            R = min(W / rtt, line)
    queues          q <- clip(q + (R M - C) dt, 0, 64 K)

Flows are unbounded in the transient solve, so a flow's rate is the mean
of its last ``max(8, steps // 10)`` rates and its FCT is size / max(rate,
1e3).  A phase starts when its dependencies are done plus its compute time
and ends with its slowest flow; the iteration is the last phase's end.

Everything is float64.  ``rounding="bfloat16"`` rounds every intermediate
to bfloat16 instead: the control that has to fail the comparison.
"""
from __future__ import annotations

import numpy as np

from simbench.reference.topology import Topology
from simbench.reference.traffic import Phase


def to_bfloat16(x) -> np.ndarray:
    """Round to the nearest bfloat16 (ties to even), returned as float64."""
    x = np.asarray(x, np.float64)
    b = np.ascontiguousarray(x.astype(np.float32)).view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    return b.astype(np.uint32).view(np.float32).astype(np.float64).reshape(x.shape)


def _exact(x):
    return x


class FluidReference:
    """Per-phase rates (computed once per distinct set of flows) and the
    schedule of any number of iterations over one fabric."""

    def __init__(self, topo: Topology, fluid: dict, rounding: str | None = None) -> None:
        if rounding not in (None, "bfloat16"):
            raise ValueError(f"unknown rounding {rounding!r}")
        self.topo = topo
        self.steps = int(fluid["steps"])
        self.g = float(fluid["g"])
        self.ecn_k = float(fluid["ecn_k"])
        self.mss = float(fluid["mss"])
        self.r = to_bfloat16 if rounding else _exact
        self._phases: dict[tuple, tuple[np.ndarray, tuple[int, int, int]]] = {}

    def phase(self, flows) -> tuple[np.ndarray, tuple[int, int, int]]:
        """A phase's converged rates and its scan's (flows, links, set bits)."""
        key = tuple((f.fid, f.src, f.dst) for f in flows)
        if key not in self._phases:
            self._phases[key] = self._solve(key)
        return self._phases[key]

    def _solve(self, key: tuple) -> tuple[np.ndarray, tuple[int, int, int]]:
        topo, r = self.topo, self.r
        paths = [sorted(set(topo.route(src, dst, fid))) for fid, src, dst in key]
        links = sorted({l for p in paths for l in p})
        lix = {l: i for i, l in enumerate(links)}
        F, L = len(paths), len(links)
        fi = np.repeat(np.arange(F), [len(p) for p in paths])
        li = np.array([lix[l] for p in paths for l in p], np.int64)
        bw = r(topo.link_bw[links].astype(np.float64))
        line = r(np.array([topo.link_bw[p].min() for p in paths], np.float64))
        prop = np.array([topo.link_delay[p].sum() for p in paths], np.float64)
        hops = np.array([len(p) for p in paths], np.float64)
        rtt0 = r(2 * prop + (hops + 1) * self.mss / line)
        dt = float(r(np.median(rtt0)))
        g, K, mss = self.g, self.ecn_k, self.mss
        W, alpha, q = r(line * rtt0), np.ones(F), np.zeros(L)
        w_cap = r(2 * line * rtt0)
        w = max(8, self.steps // 10)
        hist = np.empty((self.steps, F))
        for t in range(self.steps):
            p_l = r(np.clip(r(r(q - K) / (2 * K)), 0.0, 1.0))
            qd = r(np.bincount(fi, weights=r(q / bw)[li], minlength=F))
            rtt = r(rtt0 + qd)
            p_f = np.zeros(F)
            np.maximum.at(p_f, fi, p_l[li])
            n = r(dt / rtt)
            alpha2 = r(r(r(1 - r(g * n)) * alpha) + r(r(g * n) * p_f))
            grow = r(r(mss * n) * r(1 - p_f))
            cut = r(r(r(r(p_f * alpha) * W) / 2) * n)
            W = np.minimum(np.maximum(r(r(W + grow) - cut), mss), w_cap)
            R = np.minimum(r(W / rtt), line)
            arrivals = r(np.bincount(li, weights=R[fi], minlength=L))
            q = np.clip(r(q + r(r(arrivals - bw) * dt)), 0.0, 64 * K)
            alpha = alpha2
            hist[t] = R
        return r(hist[-w:].mean(axis=0)), (F, L, len(li))

    def iteration(self, phases: list[Phase]) -> tuple[dict[int, float], float, list]:
        """Per-flow FCTs and the iteration time of one phase DAG, with the
        (flows, links, set bits) of each phase's scan."""
        fcts: dict[int, float] = {}
        shapes = []
        done = [0.0] * len(phases)
        for i, ph in enumerate(phases):
            start = max((done[d] for d in set(ph.deps)), default=0.0) + ph.compute
            end = start
            if ph.flows:
                rates, shape = self.phase(ph.flows)
                shapes.append(shape)
                for f, rate in zip(ph.flows, rates.tolist()):
                    fct = f.size / max(rate, 1e3)
                    fcts[f.fid] = fct
                    end = max(end, start + fct)
            done[i] = end
        return fcts, max(done) if done else 0.0, shapes
