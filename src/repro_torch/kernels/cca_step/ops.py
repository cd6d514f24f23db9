"""The fused DCTCP fluid step: wrapper, launch count and plain version.

The CUDA kernel (``repro_torch/csrc/cca_step.cu``) replaces the Pallas
kernel ``_cca_step_kernel`` of ``repro/kernels/cca_step/kernel.py``; its
source note says what bounds it on Hopper and how it is laid out.  The
plain version below is the same function in PyTorch, line for line with
the reference's oracle ``repro.kernels.cca_step.ref.cca_step_ref``.

Every tensor may carry a leading batch dimension B (independent
partitions, the fluid sweep's padded batch): M is [F, L] or [B, F, L],
the flow vectors [F] or [B, F], the link vectors [L] or [B, L].
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import float32_input, same_device
from repro_torch.kernels.build import load

_FLOW = ("R", "W", "alpha", "delivered", "size", "line", "rtt0")
_LINK = ("q", "bw")


def cca_step_plain(R, W, alpha, delivered, size, line, rtt0, M, q, bw, *,
                   dt: float, g: float = 1 / 16, ecn_k: float = 64_000.0,
                   mss: float = 1000.0):
    """Returns ``(R2, W2, alpha2, delivered2, arrivals)``.  ``R`` is carried
    state the step does not read (as in the reference)."""
    del R
    p_l = ((q - ecn_k) / (2 * ecn_k)).clamp(0.0, 1.0)
    qd = (M @ (q / bw).unsqueeze(-1)).squeeze(-1)          # [.., F] queue delay
    rtt = rtt0 + qd
    p_f = (M * p_l.unsqueeze(-2)).amax(-1)                 # worst hop marks
    # round-trips this step; a true division (``dt / rtt`` on a tensor
    # multiplies by the reciprocal, one more rounding than the reference)
    dtn = torch.full_like(rtt, dt) / rtt
    alpha2 = (1 - g * dtn) * alpha + g * dtn * p_f
    grow = mss * dtn * (1 - p_f)
    cut = p_f * alpha * W / 2 * dtn
    W2 = torch.minimum((W + grow - cut).clamp_min(mss), 2 * line * rtt0)
    active = delivered < size
    R2 = torch.where(active, torch.minimum(W2 / rtt, line), 0.0)
    delivered2 = torch.minimum(delivered + R2 * dt, size)
    arrivals = (R2.unsqueeze(-2) @ M).squeeze(-2)          # [.., L]
    return R2, W2, alpha2, delivered2, arrivals


@functools.cache
def _launcher():
    fn = load("cca_step")["cca_step"].cdll.cca_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def cca_step(R, W, alpha, delivered, size, line, rtt0, M, q, bw, *,
             dt: float, g: float = 1 / 16, ecn_k: float = 64_000.0,
             mss: float = 1000.0):
    """One DCTCP fluid step; returns ``(R2, W2, alpha2, delivered2,
    arrivals)``.  Inputs are upcast to float32.  On CUDA tensors this
    launches the kernel (and counts one launch in ``cca_step.launches``);
    on CPU tensors it runs :func:`cca_step_plain`."""
    named = dict(zip(_FLOW, (R, W, alpha, delivered, size, line, rtt0)))
    named.update(M=M, q=q, bw=bw)
    t = {k: float32_input(v, k) for k, v in named.items()}
    dev = same_device(t)
    Mt = t["M"]
    if Mt.dim() not in (2, 3):
        raise ValueError(f"M must be [F, L] or [B, F, L], got {tuple(Mt.shape)}")
    *batch, F, L = Mt.shape
    for k in _FLOW:
        if tuple(t[k].shape) != (*batch, F):
            raise ValueError(f"{k} must have shape {(*batch, F)}, got {tuple(t[k].shape)}")
    for k in _LINK:
        if tuple(t[k].shape) != (*batch, L):
            raise ValueError(f"{k} must have shape {(*batch, L)}, got {tuple(t[k].shape)}")
    if F < 1 or L < 1:
        raise ValueError(f"cca_step needs at least one flow and one link, got F={F}, L={L}")
    consts = dict(dt=dt, g=g, ecn_k=ecn_k, mss=mss)
    if dev.type == "cpu":
        return cca_step_plain(*(t[k] for k in (*_FLOW, "M", *_LINK)), **consts)

    for k, v in t.items():
        if not v.is_contiguous():
            raise ValueError(f"cca_step: {k} must be contiguous")
    B = batch[0] if batch else 1
    if B * F * L >= 2**31:
        raise ValueError(f"cca_step: B*F*L = {B * F * L} overflows the kernel's indexing")
    outs = [torch.empty_like(t["W"]) for _ in range(4)] + [torch.empty_like(t["q"])]
    with torch.cuda.device(dev):
        err = _launcher()(
            *(t[k].data_ptr() for k in ("W", "alpha", "delivered", "size", "line",
                                        "rtt0", "M", "q", "bw")),
            *(o.data_ptr() for o in outs), B, F, L,
            dt, g, ecn_k, 2 * ecn_k, mss, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cca_step kernel launch failed: CUDA error {err}")
    cca_step.launches += 1
    return tuple(outs)


cca_step.launches = 0
