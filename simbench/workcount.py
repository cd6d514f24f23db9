"""The work a fluid scan has to do, counted from its shapes, and the chip's
peaks: the least time any kernel could take for it.

A scan is one phase's transient solve: F flows over L links with nnz set
bits in the 0/1 incidence, ``steps`` control steps.  Each step does
3 operations a set bit (the queue-delay product, the worst-hop mark, the
arrival product), about 25 a flow (the DCTCP update, the rate, the
delivered bytes) and 10 a link (marks, queues).  The bytes count each
input read once and each output written once, whatever a kernel rereads:
the incidence as float32, six flow vectors and two link vectors in, the
final state (four flow vectors, queues and arrivals) out, with the rate
and queue histories of every step and the steady detector's window mean
and fluctuation.  Nothing here names a kernel, so the count stays right
for whatever kernel a later change runs.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
H100_PEAKS = {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}

OPS_PER_SET_BIT = 3
OPS_PER_FLOW = 25
OPS_PER_LINK = 10
F32 = 4


def scan_ops(F: int, L: int, nnz: int, steps: int) -> float:
    return float(steps * (OPS_PER_SET_BIT * nnz + OPS_PER_FLOW * F + OPS_PER_LINK * L))


def scan_bytes(F: int, L: int, steps: int, history: bool = True, window: bool = True) -> float:
    n = F * L + 6 * F + 2 * L          # incidence, flow and link state in
    n += 4 * F + 2 * L                 # final state out
    if history:
        n += steps * (F + L)           # rate and queue histories
    if window:
        n += 2 * F                     # the detector's mean and fluctuation
    return float(F32 * n)


def least_seconds(F: int, L: int, nnz: int, steps: int, history: bool = True,
                  window: bool = True, peaks: dict = H100_PEAKS) -> tuple[float, str]:
    """The least time of one scan and what bounds it ("bytes" or "ops")."""
    by_ops = scan_ops(F, L, nnz, steps) / peaks["f32_flops"]
    by_bytes = scan_bytes(F, L, steps, history, window) / peaks["hbm_bytes_per_s"]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "ops")
