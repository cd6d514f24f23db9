"""DCTCP fluid rate dynamics in PyTorch: the counterpart of
``repro.net.fluid_jax``.

A partition's contention math is dense linear algebra over the flow x link
incidence M:

    link arrivals   a = R @ M
    queueing        q <- clip(q + (a - C) dt, 0, 64 K)
    path signals    p_f = max_l M * p_l      (ECN mark fraction)
    queue delay     d_f = M @ (q / C)
    CCA fluid step  (the DCTCP form)

A run goes through the ``fluid_scan`` kernel wrapper, which also takes the
converged rates (the steady detector over the last window of the rate
history): on a CUDA device that is the hand-written kernel (every control
step of a run and the detector in one launch), on the CPU its plain
version (a Python loop over ``cca_step_plain``, then ``steady_scan_plain``).
The reference's ``lax.scan`` is that scan here, and its ``vmap`` a leading
batch dimension.  All math is float32, as the reference runs with x64 off.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.kernels.cca_step import fluid_scan
from repro_torch.net.topology import Topology


@dataclasses.dataclass
class FluidPaths:
    """A phase's flows routed, in compact form: the set entries of its
    [F, L] incidence (a flow's row, a column for each of the phase's links
    in ascending link id), with the line rates, base RTTs, sizes and link
    bandwidths.  ``scenario`` builds the dense incidence from it.

    ``key`` holds every input of a phase's solve but the flow sizes, which
    ``fluid_converged_rates`` lifts to inf: phases with equal keys have
    equal solves, bit for bit, on one device."""
    cells: np.ndarray          # [nnz] int64 flat indices row * L + column, ascending
    line_rate: np.ndarray      # [F] bytes/s
    base_rtt: np.ndarray       # [F] s
    size: np.ndarray           # [F] bytes
    link_bw: np.ndarray        # [L] bytes/s
    ecn_k: float = 64_000.0
    mss: float = 1000.0

    @classmethod
    def from_flows(cls, topo: Topology, flows: list[tuple[int, int, int, float]],
                   mtu: float = 1000.0, ecn_k: float = 64_000.0) -> FluidPaths:
        """flows: (fid, src, dst, size)."""
        with obs.span("fluid.route"):
            # the paths as one flat array of link ids, flow after flow
            fid, src, dst, size = zip(*flows) if flows else ((),) * 4
            flat, hops = topo.routes(fid, src, dst)
        with obs.span("fluid.incidence"):
            if (hops == 0).any():
                raise ValueError("a flow from a host to itself has no path")
            starts = np.cumsum(hops) - hops
            links, col = np.unique(flat, return_inverse=True)    # ascending link ids
            # sorted, the set entries do not depend on the order of the links
            # along a path, so phases that differ only in that share a key
            cells = np.sort(np.repeat(np.arange(len(flows)), hops) * len(links) + col)
            bw = topo.link_bw[links].astype(np.float64)
            line = np.minimum.reduceat(topo.link_bw[flat], starts)
            # each path's delays summed as one row, in the order numpy sums a
            # path alone (reduceat would add them in another order)
            delay = topo.link_delay[flat]
            prop = np.empty(len(flows))
            for k in np.unique(hops):
                rows = np.flatnonzero(hops == k)
                prop[rows] = delay[starts[rows, None] + np.arange(k)].sum(axis=1)
            rtt = 2 * prop + (hops + 1) * mtu / line
            return cls(cells=cells, line_rate=line, base_rtt=rtt,
                       size=np.array(size, np.float64), link_bw=bw, ecn_k=ecn_k, mss=mtu)

    def key(self) -> tuple:
        """The solve's inputs but the sizes; F and L are the lengths of
        ``line_rate`` and ``link_bw``."""
        return (self.ecn_k, self.mss) + tuple(
            a.tobytes() for a in (self.cells, self.line_rate, self.base_rtt, self.link_bw))

    def scenario(self) -> FluidScenario:
        M = np.zeros(len(self.line_rate) * len(self.link_bw), np.float32)
        M[self.cells] = 1.0
        return FluidScenario(incidence=M.reshape(len(self.line_rate), len(self.link_bw)),
                             line_rate=self.line_rate, base_rtt=self.base_rtt,
                             size=self.size, link_bw=self.link_bw, ecn_k=self.ecn_k,
                             mss=self.mss)


@dataclasses.dataclass
class FluidScenario:
    """Dense numpy arrays describing one partition (or a padded batch slot);
    the reference's ``FluidScenario`` arrays fit as they are."""
    incidence: np.ndarray      # [F, L] float32 0/1
    line_rate: np.ndarray      # [F] bytes/s
    base_rtt: np.ndarray       # [F] s
    size: np.ndarray           # [F] bytes
    link_bw: np.ndarray        # [L] bytes/s
    ecn_k: float = 64_000.0
    mss: float = 1000.0

    @classmethod
    def from_flows(cls, topo: Topology, flows: list[tuple[int, int, int, float]],
                   mtu: float = 1000.0, ecn_k: float = 64_000.0) -> FluidScenario:
        """flows: (fid, src, dst, size)."""
        return FluidPaths.from_flows(topo, flows, mtu, ecn_k).scenario()


def _f32(x, device: torch.device) -> torch.Tensor:
    """float64 numpy in, float32 tensor on ``device`` out (the cast the
    reference's ``jnp.asarray`` makes with x64 off).  A copy to the card
    from pageable memory waits on the stream: one of ``fluid.syncs``."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    if t.is_cuda:
        obs.count("fluid.syncs")
    return t


def fluid_run(M, line, rtt0, size, bw, dt: float, steps: int,
              ecn_k: float = 64_000.0, mss: float = 1000.0, g: float = 1 / 16,
              window: int | None = None):
    """Advance DCTCP fluid dynamics ``steps`` control intervals.

    Float32 tensors on one device: M [F, L], flow vectors [F], link vectors
    [L], or all with a leading batch dimension B.  Returns a dict with the
    final ``rates``, ``delivered`` and ``queues``, the rate history
    ``rate_hist`` [steps, F] and the queue history ``queue_hist``
    [steps, L] (with the batch dimension first when given); with a
    ``window``, also the steady detector over the last ``window`` rates,
    ``win_mean`` and ``win_fluct`` [F].  The whole run is one
    ``fluid_scan`` call: one kernel launch on the card."""
    # the reference's initial state (fluid_jax.fluid_run)
    out = fluid_scan(M, line, rtt0, size, bw, line * rtt0, torch.ones_like(line),
                     torch.zeros_like(line), torch.zeros_like(bw),
                     dt=dt, steps=steps, g=g, ecn_k=ecn_k, mss=mss, window=window)
    keys = ("rates", "delivered", "queues", "rate_hist", "queue_hist")
    return {k: out[k] for k in keys + (("win_mean", "win_fluct") if window else ())}


def _t_conv(hist: torch.Tensor, w: int, dt: float, steps: int) -> float:
    """First step t >= w whose trailing window hist[t-w:t] is within 5% for
    every flow (``fluid_jax.fluid_converged_rates``'s loop, all windows at
    once); ``steps * dt`` when none is."""
    n = steps - w
    if n <= 0:
        return steps * dt
    win = hist.unfold(0, w, 1)[:n]                     # [n, F, w]: window k = hist[k:k+w]
    m = win.mean(-1)
    fl = torch.where(m > 0, (win.amax(-1) - win.amin(-1)) / m.clamp_min(1e-9), torch.inf)
    ok = (fl < 0.05).all(-1).cpu().numpy()
    if hist.is_cuda:
        obs.count("fluid.syncs")
    return float(w + int(ok.argmax())) * dt if ok.any() else steps * dt


def fluid_converged_rates(scn: FluidScenario, dt: float | None = None,
                          steps: int = 400, device: str | torch.device | None = None):
    """Converged per-flow rates + convergence time estimate via the steady
    detector over the simulated rate history.

    Returns ``rates`` (the trailing-window means) and ``fluct`` as [F]
    tensors and ``hist`` [steps, F] on the run's device, and ``t_conv`` in
    seconds.  ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    dt = dt if dt is not None else float(np.median(scn.base_rtt))
    # transient solve: rates are the question, so flows are unbounded here
    # (completion handling stays with the caller)
    unbounded = np.full_like(scn.size, np.inf)
    w = max(8, steps // 10)
    # atol=0 and positive rates (R2 >= mss/rtt for unbounded flows): the
    # detector's 1e-30 clamp and zero-row rule never differ from the
    # reference's numpy (1e-9 clamp, inf for a zero row) here
    with obs.span("fluid.upload"):
        args = [_f32(x, dev) for x in (scn.incidence, scn.line_rate, scn.base_rtt,
                                       unbounded, scn.link_bw)]
    with obs.span("fluid.scan"):
        out = fluid_run(*args, dt, steps, ecn_k=scn.ecn_k, mss=scn.mss, window=w)
        if out["rate_hist"].is_cuda:                   # the scan's 0/1 check of M waits
            obs.count("fluid.syncs")
    del args                                          # the inputs go before _t_conv's windows
    hist = out["rate_hist"]                            # [steps, F]
    with obs.span("fluid.t_conv"):
        t_conv = _t_conv(hist, w, dt, steps)
    return {"rates": out["win_mean"], "fluct": out["win_fluct"],
            "t_conv": t_conv, "hist": hist}


def sweep(scenarios: list[FluidScenario], dt: float, steps: int,
          device: str | torch.device | None = None, window: int | None = None):
    """Multi-experiment parallelism: one batched run over the scenarios,
    padded to a common [F, L] (padded flows idle at size 0, padded links
    carry 1e12 B/s).  Uses the default ``ecn_k``/``mss``, as the
    reference's vmapped sweep does; ``window`` as in :func:`fluid_run`."""
    dev = resolve_device(device)
    F = max(s.incidence.shape[0] for s in scenarios)
    L = max(s.incidence.shape[1] for s in scenarios)

    def pad(s: FluidScenario):
        M = np.zeros((F, L), np.float32)
        M[:s.incidence.shape[0], :s.incidence.shape[1]] = s.incidence

        def p1(x, n, fill):
            out = np.full(n, fill, np.float64)
            out[:len(x)] = x
            return out
        return (M, p1(s.line_rate, F, 1.0), p1(s.base_rtt, F, 1e-5),
                p1(s.size, F, 0.0), p1(s.link_bw, L, 1e12))

    Ms, lines, rtts, sizes, bws = (_f32(np.stack(x), dev) for x in
                                   zip(*[pad(s) for s in scenarios]))
    return fluid_run(Ms, lines, rtts, sizes, bws, dt, steps, window=window)


def sweep_converged_rates(scenarios: list[FluidScenario], dt: float = 1e-5,
                          steps: int = 200, window: int | None = None,
                          bounded: bool = False,
                          device: str | torch.device | None = None) -> list[torch.Tensor]:
    """One batched sweep -> per-scenario converged rates (trailing-window
    means), unpadded back to each scenario's true flow count, as CPU
    tensors.  With ``bounded=False`` (the default) flow sizes are lifted to
    inf so the answer is the contention equilibrium, not a completion
    artifact."""
    if not bounded:
        scenarios = [dataclasses.replace(
            s, size=np.full_like(np.asarray(s.size, np.float64), np.inf))
            for s in scenarios]
    w = window if window is not None else max(8, steps // 10)
    out = sweep(scenarios, dt=dt, steps=steps, device=device, window=w)
    # padded rows are all-zero series, sliced off below
    means = out["win_mean"].cpu()                                  # [B, F]
    return [means[i, :s.incidence.shape[0]] for i, s in enumerate(scenarios)]
