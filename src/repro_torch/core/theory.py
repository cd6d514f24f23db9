"""Error bounds and hyper-parameter guidance (paper §5.2, Appendix B-D).

Theorem 2:  |R̂ - R̄|/R̄        <  θ/(1-θ)   when ΔR_l(t) < θ
Theorem 3:  |T̂ - T̄|/T̄        <  θ
Eq. 11:     θ  ≳ sqrt(7N / (16·C·RTT))       (DCTCP sawtooth amplitude)
Eq. 13:     Δt(l) ≥ T_C = sqrt((C·RTT+K)/(2N)) RTTs   (cover ≥1 sawtooth)

C·RTT and K are in packets (MSS units) in the DCTCP fluid model.

Copy of ``repro.core.theory``, which the port may not import.
"""
from __future__ import annotations

import math


def rate_error_bound(theta: float) -> float:
    """Theorem 2: upper bound on steady-rate estimation error."""
    assert 0 < theta < 1
    return theta / (1 - theta)


def duration_error_bound(theta: float) -> float:
    """Theorem 3: upper bound on steady-duration estimation error."""
    assert 0 < theta < 1
    return theta


def dctcp_relative_fluctuation(n_flows: int, bw_Bps: float, rtt_s: float,
                               mss: float = 1000.0) -> float:
    """ε_relative ≈ sqrt(7N/(16·C·RTT)) with C·RTT in packets (Eq. 11)."""
    c_rtt_pkts = bw_Bps * rtt_s / mss
    return math.sqrt(7 * n_flows / (16 * max(c_rtt_pkts, 1e-9)))


def theta_guidance(n_flows: int, bw_Bps: float, rtt_s: float,
                   mss: float = 1000.0, slack: float = 1.5) -> float:
    """θ slightly above the steady-state's own sawtooth fluctuation: below it
    the detector never fires (no acceleration), far above it transients get
    misclassified (rate error)."""
    return slack * dctcp_relative_fluctuation(n_flows, bw_Bps, rtt_s, mss)


def sawtooth_period_rtts(n_flows: int, bw_Bps: float, rtt_s: float,
                         ecn_k_bytes: float, mss: float = 1000.0) -> float:
    """T_C = sqrt((C·RTT + K)/(2N)) in RTTs (DCTCP batch-drain period)."""
    c_rtt = bw_Bps * rtt_s / mss
    k = ecn_k_bytes / mss
    return math.sqrt((c_rtt + k) / (2 * max(n_flows, 1)))


def l_guidance(n_flows: int, bw_Bps: float, rtt_s: float, ecn_k_bytes: float,
               sample_interval_s: float, mss: float = 1000.0,
               periods: float = 2.0) -> int:
    """Smallest window length l whose span Δt(l) covers ``periods`` sawtooth
    periods (Eq. 13; below T_C the fluctuation estimate is biased)."""
    t_c = sawtooth_period_rtts(n_flows, bw_Bps, rtt_s, ecn_k_bytes, mss) * rtt_s
    return max(4, int(math.ceil(periods * t_c / max(sample_interval_s, 1e-12))) + 1)
