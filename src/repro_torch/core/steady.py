"""Steady-state identification (paper §5.1).

A flow is steady when the *relative* fluctuation of the monitored metric over
the last ``l`` samples is below θ (Eq. 6); the steady rate estimate is the
window mean (Eq. 7).  Theorem 1 licenses using any of {R, inflight I, queue
Q} as the single monitored metric — all are exposed (Fig 13a sensitivity).

Scalar forms are used by the event-driven oracle (the Wormhole kernel runs
them in float64, inside the event loop); the ``*_batch`` numpy forms are the
oracle for the ``steady_scan`` kernel and the fluid engine.

Copy of ``repro.core.steady``, which the port may not import.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np


def fluctuation(hist: Sequence[float], atol: float = 0.0) -> float:
    """ΔR_l(t) = (max - min) / mean over the window (Eq. 6).  ``atol``:
    metrics pinned near zero (e.g. an empty queue under HPCC) are steady by
    definition even though their relative fluctuation is 0/0."""
    if not len(hist):
        return float("inf")
    mx = max(hist)
    mn = min(hist)
    if mx <= atol:
        return 0.0
    mean = sum(hist) / len(hist)
    if mean <= 0:
        return float("inf")
    return (mx - mn) / mean


def is_steady(hist: Sequence[float], l: int, theta: float,
              atol: float = 0.0) -> bool:
    if len(hist) < l:
        return False
    return fluctuation(list(hist)[-l:], atol) < theta


def rate_estimate(hist: Sequence[float], l: int) -> float:
    """R̂ = window mean (Eq. 7) — *not* max-min fair allocation: converged
    rates can deviate from max-min fairness in multi-hop congestion
    [Poseidon, NSDI'23], so we estimate from the simulated samples."""
    w = list(hist)[-l:]
    return sum(w) / max(len(w), 1)


# ---------------------------------------------------------------------- #
# Vectorised forms (numpy oracle for kernels/steady_scan and fluid engine)
# ---------------------------------------------------------------------- #
def fluctuation_batch(hist: np.ndarray, atol: float = 0.0) -> np.ndarray:
    """hist: [flows, l] -> ΔR_l per flow.  ``atol`` is the same dead-band the
    scalar ``fluctuation`` applies: a metric pinned at (or below) ``atol`` —
    e.g. a zero qlen under HPCC — is steady by definition, not 0/0-unsteady."""
    mx = hist.max(axis=-1)
    mn = hist.min(axis=-1)
    mean = hist.mean(axis=-1)
    out = np.where(mean > 0, (mx - mn) / np.where(mean > 0, mean, 1.0), np.inf)
    return np.where(mx <= atol, 0.0, out)


def steady_mask_batch(hist: np.ndarray, theta: float,
                      atol: float = 0.0) -> np.ndarray:
    return fluctuation_batch(hist, atol) < theta


def rate_estimate_batch(hist: np.ndarray) -> np.ndarray:
    return hist.mean(axis=-1)
