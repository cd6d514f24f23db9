"""Trailing-window fluctuation of rate series: wrapper, launch count and
plain version.

The CUDA kernel (``repro_torch/csrc/steady_scan.cu``) replaces the Pallas
kernel ``_steady_kernel`` of ``repro/kernels/steady_scan/kernel.py``; its
source note says what bounds it on Hopper and how it is laid out.  The
plain version below is the same function in PyTorch, line for line with
the reference's oracle ``repro.kernels.steady_scan.ref.steady_scan_ref``.

``hist`` is ``[F, H]`` or ``[B, F, H]`` (series by time, most recent
last) with any strides: the fluid engine hands over the transpose of its
time-major ``[steps, F]`` history, which the kernel reads in place.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import float32_input, same_device
from repro_torch.kernels.build import load


def steady_scan_plain(hist: torch.Tensor, window: int, atol: float = 0.0):
    """Returns ``(fluct, mean)`` over the trailing ``window`` samples of
    every series.  ``atol`` is the dead band: a series whose window max is
    ``<= atol`` is steady by definition (fluct 0)."""
    w = hist[..., hist.shape[-1] - window:]
    mx = w.amax(-1)
    mn = w.amin(-1)
    mean = w.sum(-1) / window
    fluct = torch.where(mean > 0, (mx - mn) / mean.clamp_min(1e-30), torch.inf)
    return torch.where(mx <= atol, 0.0, fluct), mean


@functools.cache
def _launcher():
    fn = load("steady_scan")["steady_scan"].cdll.steady_scan_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3
                   + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def steady_scan(hist: torch.Tensor, window: int, atol: float = 0.0):
    """``(fluct, mean)`` of each series over its trailing ``window`` samples
    (paper Eq. 6 / Eq. 7).  The input is upcast to float32.  On a CUDA
    tensor this launches the kernel (and counts one launch in
    ``steady_scan.launches``); on a CPU tensor it runs
    :func:`steady_scan_plain`."""
    hist = float32_input(hist, "hist")
    dev = same_device({"hist": hist})
    if hist.dim() not in (2, 3):
        raise ValueError(f"hist must be [F, H] or [B, F, H], got {tuple(hist.shape)}")
    H = hist.shape[-1]
    if not 0 < window <= H:
        raise ValueError(f"window must be in 1..{H}, got {window}")
    if dev.type == "cpu":
        return steady_scan_plain(hist, window, atol)

    h3 = hist if hist.dim() == 3 else hist.unsqueeze(0)
    B, F, _ = h3.shape
    if F < 1:
        raise ValueError("steady_scan needs at least one series")
    if B * F >= 2**31:
        raise ValueError(f"steady_scan: {B * F} series overflow the kernel's indexing")
    fluct = torch.empty((B, F), dtype=torch.float32, device=dev)
    mean = torch.empty_like(fluct)
    with torch.cuda.device(dev):
        err = _launcher()(h3.data_ptr(), B, F, H, *h3.stride(), window, atol,
                          fluct.data_ptr(), mean.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"steady_scan kernel launch failed: CUDA error {err}")
    steady_scan.launches += 1
    if hist.dim() == 2:
        return fluct[0], mean[0]
    return fluct, mean


steady_scan.launches = 0
