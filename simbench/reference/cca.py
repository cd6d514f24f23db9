"""Congestion-control algorithms for the packet-level oracle.

Four mainstream DC CCAs (the paper's set, §1/§7): DCTCP [SIGCOMM'10],
DCQCN [SIGCOMM'15], TIMELY [SIGCOMM'15], HPCC [SIGCOMM'19].

Unified sender model: every flow paces packets at ``rate()`` bytes/s subject
to ``inflight < cwnd()``.  Window CCAs derive the pacing rate as cwnd/srtt;
rate CCAs keep a large window and control the rate directly.  Each CCA's
``on_ack`` consumes (ecn_mark, rtt, int_info) and updates internal state.
``rate()`` is the unified metric R the steady-state detector monitors (§5.1.1).

Frozen copy of ``src/repro/net/cca.py``, the JAX package's pure-Python
module (no JAX in it), which the port's tests hold the port to; part of
the benchmark's plain reference: its imports are rewritten to stay inside
``simbench``, and it imports neither the program nor the JAX package.
"""
from __future__ import annotations

import dataclasses

MTU = 1000.0  # bytes per packet in the scaled oracle


@dataclasses.dataclass(slots=True)
class INTInfo:
    """In-network telemetry carried by HPCC packets: max per-hop 'inflight'
    utilisation along the path (queue + BDP share)."""
    max_util: float = 0.0


class CCA:
    """Base class.  Subclasses mutate self.r (bytes/s) and self.w (bytes).

    One instance lives per flow and its attributes churn on every ACK, so
    the whole hierarchy is slotted — no per-instance ``__dict__``, smaller
    objects, faster attribute access on the hot ``on_ack`` path."""

    __slots__ = ("line_rate", "base_rtt", "r", "w", "srtt")

    name = "base"
    uses_int = False
    # window-based CCAs control via self.w (rate derived as w/srtt); rate
    # CCAs control self.r directly and keep w as a loose in-flight cap —
    # state restoration after a memo replay must respect the difference
    window_based = True
    # steady-state relative rate-fluctuation hint for the detector's θ
    # guidance (None -> use the paper's DCTCP sawtooth formula, Eq. 11)
    steady_eps_hint: float | None = None

    def __init__(self, line_rate: float, base_rtt: float) -> None:
        self.line_rate = line_rate
        self.base_rtt = base_rtt
        self.r = line_rate            # current pacing rate (bytes/s)
        self.w = line_rate * base_rtt  # window (bytes)
        self.srtt = base_rtt

    # -- sender interface ------------------------------------------------ #
    def rate(self) -> float:
        r = self.r
        return r if r >= MTU else MTU  # floor: 1 pkt/s

    def cwnd(self) -> float:
        w = self.w
        return w if w >= MTU else MTU

    def on_ack(self, now: float, acked: float, ecn: bool, rtt: float,
               int_info: INTInfo | None = None) -> None:
        self.srtt = 0.875 * self.srtt + 0.125 * rtt
        self._update(now, acked, ecn, rtt, int_info)

    def _update(self, now, acked, ecn, rtt, int_info) -> None:  # pragma: no cover
        raise NotImplementedError


class DCTCP(CCA):
    """Window-based; ECN fraction alpha, multiplicative cut once per RTT."""

    name = "dctcp"
    __slots__ = ("g", "alpha", "_acked", "_ecn_acked", "_win_end_bytes",
                 "_total_acked")

    def __init__(self, line_rate: float, base_rtt: float, g: float = 1 / 16) -> None:
        super().__init__(line_rate, base_rtt)
        self.g = g
        self.alpha = 1.0
        self._acked = 0.0
        self._ecn_acked = 0.0
        self._win_end_bytes = self.w  # next alpha-update boundary (in acked bytes)
        self._total_acked = 0.0

    def _update(self, now, acked, ecn, rtt, int_info) -> None:
        self._acked += acked
        self._total_acked += acked
        if ecn:
            self._ecn_acked += acked
        if self._total_acked >= self._win_end_bytes:
            frac = self._ecn_acked / max(self._acked, 1.0)
            self.alpha = (1 - self.g) * self.alpha + self.g * frac
            if frac > 0:
                self.w = max(MTU, self.w * (1 - self.alpha / 2))
            else:
                self.w = min(self.line_rate * self.base_rtt * 1.2, self.w + MTU)
            self._acked = 0.0
            self._ecn_acked = 0.0
            self._win_end_bytes = self._total_acked + self.w
        s = self.srtt
        self.r = self.w / (s if s >= 1e-9 else 1e-9)


class DCQCN(CCA):
    """Rate-based; ECN-driven alpha with multiplicative decrease and
    fast-recovery/additive-increase stages (simplified NP/RP model)."""

    name = "dcqcn"
    __slots__ = ("g", "alpha", "rt", "_last_cut", "_last_inc", "_inc_stage",
                 "timer", "rai")
    window_based = False
    steady_eps_hint = 0.10   # cut/recover sawtooth amplitude

    def __init__(self, line_rate: float, base_rtt: float, g: float = 1 / 16) -> None:
        super().__init__(line_rate, base_rtt)
        self.g = g
        self.alpha = 1.0
        self.rt = line_rate           # target rate
        self._last_cut = -1.0
        self._last_inc = 0.0
        self._inc_stage = 0
        # rate-increase timer scaled to the simulated RTT (real DCQCN uses
        # 55us against ~50us fabric RTTs; keep the same ratio)
        self.timer = max(4 * base_rtt, 8e-6)
        self.rai = line_rate / 100.0  # additive increase step

    def _update(self, now, acked, ecn, rtt, int_info) -> None:
        if ecn:
            self.alpha = (1 - self.g) * self.alpha + self.g
            if now - self._last_cut > self.base_rtt:  # at most one cut per RTT
                self.rt = self.r
                self.r = max(self.r * (1 - self.alpha / 2), self.line_rate / 1000)
                self._last_cut = now
                self._inc_stage = 0
                self._last_inc = now
        else:
            self.alpha = (1 - self.g) * self.alpha
            if now - self._last_inc > self.timer:
                self._last_inc = now
                self._inc_stage += 1
                if self._inc_stage <= 5:          # fast recovery toward rt
                    self.r = (self.r + self.rt) / 2
                else:                             # additive increase
                    self.rt = min(self.line_rate, self.rt + self.rai)
                    self.r = (self.r + self.rt) / 2
            self.r = min(self.r, self.line_rate)
        self.w = 1.5 * self.line_rate * self.base_rtt  # loose cap; rate-controlled


class TIMELY(CCA):
    """Rate-based on RTT gradient [SIGCOMM'15] (no HAI mode)."""

    name = "timely"
    __slots__ = ("beta", "delta", "_prev_rtt", "t_low", "t_high",
                 "_ewma_grad")
    window_based = False
    steady_eps_hint = 0.05

    def __init__(self, line_rate: float, base_rtt: float,
                 beta: float = 0.45, delta_frac: float = 1 / 150) -> None:
        super().__init__(line_rate, base_rtt)
        self.beta = beta
        self.delta = line_rate * delta_frac
        self._prev_rtt = base_rtt
        self.t_low = base_rtt * 1.1
        self.t_high = base_rtt * 3.0
        self._ewma_grad = 0.0

    def _update(self, now, acked, ecn, rtt, int_info) -> None:
        grad = (rtt - self._prev_rtt) / max(self.base_rtt, 1e-9)
        self._prev_rtt = rtt
        self._ewma_grad = 0.875 * self._ewma_grad + 0.125 * grad
        if rtt < self.t_low:
            self.r = min(self.line_rate, self.r + self.delta)
        elif rtt > self.t_high:
            self.r = max(self.line_rate / 1000, self.r * (1 - self.beta * (1 - self.t_high / rtt)))
        elif self._ewma_grad <= 0:
            self.r = min(self.line_rate, self.r + self.delta)
        else:
            self.r = max(self.line_rate / 1000, self.r * (1 - self.beta * self._ewma_grad))
        self.w = 1.5 * self.line_rate * self.base_rtt


class HPCC(CCA):
    """INT-based [Li et al., SIGCOMM'19, Algorithm 1]: per-ACK
    ``W = Wc/(U/η) + W_AI`` against a reference window Wc updated once per
    RTT; U is the EWMA (α = ack-interval/T) of the max per-hop utilisation
    ``min(qlen, qlen_prev)/(B·T) + txRate/B`` carried back by telemetry."""

    name = "hpcc"
    __slots__ = ("eta", "w_ref", "w_ai", "max_stage", "_stage", "_u_ewma",
                 "_last_ack_t", "_total_acked", "_update_seq", "_w_cap")
    uses_int = True
    # window-based with a DCTCP-like sawtooth: use the Eq.11 guidance
    # (steady_eps_hint=None); the drift guard handles convergence ramps

    def __init__(self, line_rate: float, base_rtt: float,
                 eta: float = 0.95, max_stage: int = 5) -> None:
        super().__init__(line_rate, base_rtt)
        self.eta = eta
        self.w_ref = self.w
        self.w_ai = MTU / 2
        self.max_stage = max_stage
        self._stage = 0
        self._u_ewma = eta
        self._last_ack_t = 0.0
        self._total_acked = 0.0
        self._update_seq = 0.0          # snd_nxt proxy at last Wc update
        self._w_cap = 1.05 * line_rate * base_rtt + max_stage * self.w_ai

    def _update(self, now, acked, ecn, rtt, int_info) -> None:
        # hot per-ACK recursion: min/max spelled as conditionals (identical
        # values, including ties) — builtin-call overhead is measurable here
        self._total_acked += acked
        u = int_info.max_util if int_info is not None else (1.5 if ecn else self.eta)
        dt = now - self._last_ack_t
        if dt < 1e-12:
            dt = 1e-12
        tau = dt / self.base_rtt
        if tau > 1.0:
            tau = 1.0
        self._last_ack_t = now
        self._u_ewma = (1 - tau) * self._u_ewma + tau * u
        update_wc = self._total_acked >= self._update_seq
        if self._u_ewma >= self.eta or self._stage >= self.max_stage:
            d = self._u_ewma / self.eta
            w = self.w_ref / (d if d >= 0.2 else 0.2) + self.w_ai
            if update_wc:
                self._stage = 0
        else:
            w = self.w_ref + self.w_ai
            if update_wc:
                self._stage += 1
        if w < MTU:
            w = MTU
        cap = self._w_cap
        self.w = w = w if w <= cap else cap
        if update_wc:
            self.w_ref = w
            self._update_seq = self._total_acked + w  # ≈ snd_nxt
        s = self.srtt
        self.r = w / (s if s >= 1e-9 else 1e-9)


CCA_REGISTRY: dict[str, type[CCA]] = {
    c.name: c for c in (DCTCP, DCQCN, TIMELY, HPCC)
}


def make_cca(name: str, line_rate: float, base_rtt: float) -> CCA:
    try:
        return CCA_REGISTRY[name](line_rate, base_rtt)
    except KeyError:
        raise ValueError(f"unknown CCA {name!r}; have {sorted(CCA_REGISTRY)}") from None
