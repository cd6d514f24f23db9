"""The DCTCP fluid step and the fluid scan: wrappers, launch counts and
plain versions.

The CUDA kernel (``repro_torch/csrc/cca_step.cu``) replaces the Pallas
kernel ``_cca_step_kernel`` of ``repro/kernels/cca_step/kernel.py`` and the
reference's ``lax.scan`` over it: one launch runs every control step of a
fluid run, one thread block per partition with the partition's state in
shared memory; its source note says what bounds it on Hopper and how it is
laid out.  :func:`fluid_scan` is that scan; :func:`cca_step` is the same
kernel at one step.  The plain versions below are the same functions in
PyTorch: :func:`cca_step_plain` line for line with the reference's oracle
``repro.kernels.cca_step.ref.cca_step_ref``, :func:`fluid_scan_plain` the
loop of ``repro.net.fluid_jax.fluid_run`` over it.  With a ``window``
the scan also returns the steady detector over its last ``window`` rates
(``win_mean``, ``win_fluct``): the kernel computes it in its epilogue,
bit-equal to ``steady_scan`` over the same history, and the plain scan
takes it with ``steady_scan_plain`` over its own history.

Every tensor may carry a leading batch dimension B (independent
partitions, the fluid sweep's padded batch): M is [F, L] or [B, F, L],
the flow vectors [F] or [B, F], the link vectors [L] or [B, L].  M must be
a 0/1 incidence: the kernel holds it as bitmasks, and both devices refuse
anything else.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import float32_input, same_device
from repro_torch.kernels.build import load
from repro_torch.kernels.steady_scan import steady_scan_plain

_STEP_FLOW = ("R", "W", "alpha", "delivered", "size", "line", "rtt0")
_SCAN_FLOW = ("line", "rtt0", "size", "W", "alpha", "delivered")
_LINK = ("bw", "q")
_STATE = ("rates", "W", "alpha", "delivered", "queues", "arrivals")


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


def _check_window(window: int | None, steps: int) -> None:
    if window is not None and not 1 <= window <= steps:
        raise ValueError(f"fluid_scan: window must be in 1..{steps} (the steps), got {window}")


def fluid_scan_plain(M, line, rtt0, size, bw, W, alpha, delivered, q, *,
                     dt: float, steps: int, g: float = 1 / 16,
                     ecn_k: float = 64_000.0, mss: float = 1000.0,
                     history: bool = True, window: int | None = None,
                     atol: float = 0.0) -> dict:
    """``steps`` control steps from the state (W, alpha, delivered, q): a
    :func:`cca_step_plain` and the queue update each.  Returns the final
    ``rates``, ``W``, ``alpha``, ``delivered`` and ``queues``, the last
    step's ``arrivals``, and the histories ``rate_hist`` [.., steps, F] and
    ``queue_hist`` [.., steps, L] (None with ``history=False``).  With no
    step, ``rates`` is ``line`` (where a fluid run starts) and ``arrivals``
    zero.  With a ``window`` (1..steps) it also returns ``win_mean`` and
    ``win_fluct`` [.., F]: :func:`steady_scan_plain` over the last
    ``window`` rates of each flow, with ``atol`` its dead band."""
    _check_window(window, steps)
    keep = history or window is not None
    R, arrivals = line, torch.zeros_like(bw)
    rate_hist = queue_hist = None
    if keep:
        rate_hist = line.new_empty((*line.shape[:-1], steps, line.shape[-1]))
        queue_hist = bw.new_empty((*bw.shape[:-1], steps, bw.shape[-1]))
    for t in range(steps):
        R, W, alpha, delivered, arrivals = cca_step_plain(
            R, W, alpha, delivered, size, line, rtt0, M, q, bw,
            dt=dt, g=g, ecn_k=ecn_k, mss=mss)
        q = (q + (arrivals - bw) * dt).clamp_(0.0, 64 * ecn_k)
        if keep:
            rate_hist[..., t, :] = R
            queue_hist[..., t, :] = q
    out = dict(zip(_STATE, (R, W, alpha, delivered, q, arrivals)))
    if window is not None:
        out["win_fluct"], out["win_mean"] = steady_scan_plain(
            rate_hist.transpose(-1, -2), window, atol)
    if not history:
        rate_hist = queue_hist = None
    return {**out, "rate_hist": rate_hist, "queue_hist": queue_hist}


def _checked(named: dict, flow: tuple[str, ...], who: str):
    """Float32 inputs on one device with consistent shapes and a 0/1 M;
    returns them with the device and whether they carry a batch dimension."""
    t = {k: float32_input(v, k) for k, v in named.items()}
    dev = same_device(t)
    M = t["M"]
    if M.dim() not in (2, 3):
        raise ValueError(f"M must be [F, L] or [B, F, L], got {tuple(M.shape)}")
    *batch, F, L = M.shape
    for k in flow:
        if tuple(t[k].shape) != (*batch, F):
            raise ValueError(f"{k} must have shape {(*batch, F)}, got {tuple(t[k].shape)}")
    for k in _LINK:
        if tuple(t[k].shape) != (*batch, L):
            raise ValueError(f"{k} must have shape {(*batch, L)}, got {tuple(t[k].shape)}")
    if F < 1 or L < 1:
        raise ValueError(f"{who} needs at least one flow and one link, got F={F}, L={L}")
    if bool(((M != 0) & (M != 1)).any()):       # one reduction; syncs on the card
        raise ValueError(f"{who}: M must be a 0/1 incidence")
    return t, dev, bool(batch)


@functools.cache
def _library():
    cdll = load("cca_step")["cca_step"].cdll
    cdll.fluid_scan_launch.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 5
                                       + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    cdll.fluid_scan_launch.restype = ctypes.c_int
    for fn, args in ((cdll.fluid_scan_scratch_bytes, [ctypes.c_int] * 3),
                     (cdll.fluid_scan_workspace_bytes, [ctypes.c_int] * 2)):
        fn.argtypes = args
        fn.restype = ctypes.c_longlong
    return cdll


def workspace_bytes(F: int, L: int) -> int:
    """Bytes of one partition's workspace in the kernel (bitmasks and
    vectors): shared memory where it fits the block's limit."""
    return int(_library().fluid_scan_workspace_bytes(F, L))


def fluid_scan_kernel(t: dict, *, dt: float, steps: int, g: float, ecn_k: float,
                      mss: float, history: bool, window: int | None = None,
                      atol: float = 0.0) -> dict:
    """The kernel's launch alone, on float32 CUDA inputs of shape [B, ..]
    that :func:`fluid_scan` has checked (``steps >= 1``, the window in
    ``1..steps`` or None); it counts nothing.  The wrappers call it after
    their checks, and a timing loop may call it to time the device's work
    without the checks' sync."""
    M = t["M"]
    dev = M.device
    for k, v in t.items():
        if not v.is_contiguous():
            raise ValueError(f"fluid_scan: {k} must be contiguous")
    B, F, L = M.shape
    if B * F * L >= 2**31:
        raise ValueError(f"fluid_scan: B*F*L = {B * F * L} overflows the kernel's indexing")
    flow = [torch.empty_like(t["W"]) for _ in range(4)]
    link = [torch.empty_like(t["q"]) for _ in range(2)]
    hist = [M.new_empty((B, steps, F)), M.new_empty((B, steps, L))] if history else [None, None]
    win = [M.new_empty((B, F)), M.new_empty((B, F))] if window else [None, None]
    lib = _library()
    with torch.cuda.device(dev):
        n = lib.fluid_scan_scratch_bytes(B, F, L)
        if n < 0:
            raise RuntimeError(f"fluid_scan: CUDA error {-n} sizing the workspace")
        scratch = torch.empty(n, dtype=torch.uint8, device=dev) if n else None
        err = lib.fluid_scan_launch(
            *(t[k].data_ptr() for k in ("M", "line", "rtt0", "size", "bw", "W", "alpha",
                                        "delivered", "q")),
            *(o.data_ptr() for o in flow + link),
            *(h.data_ptr() if h is not None else None for h in hist + win),
            scratch.data_ptr() if scratch is not None else None,
            B, F, L, steps, window or 0, dt, g, ecn_k, mss, atol,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fluid_scan kernel launch failed: CUDA error {err}")
    out = dict(zip(_STATE, flow + link), rate_hist=hist[0], queue_hist=hist[1])
    if window:
        out.update(win_mean=win[0], win_fluct=win[1])
    return out


def fluid_scan(M, line, rtt0, size, bw, W, alpha, delivered, q, *, dt: float,
               steps: int, g: float = 1 / 16, ecn_k: float = 64_000.0,
               mss: float = 1000.0, history: bool = True, window: int | None = None,
               atol: float = 0.0) -> dict:
    """``steps`` DCTCP control steps from the state (W, alpha, delivered,
    q), each with its queue update; returns what :func:`fluid_scan_plain`
    returns, with ``win_mean`` and ``win_fluct`` when a ``window`` (1..steps)
    is given.  Inputs are upcast to float32.  On CUDA tensors this is one
    launch of the kernel (counted in ``fluid_scan.launches``) whatever
    ``steps`` is, and none for ``steps == 0``; on CPU tensors it runs
    :func:`fluid_scan_plain`."""
    if steps < 0:
        raise ValueError(f"fluid_scan: steps must be >= 0, got {steps}")
    _check_window(window, steps)
    named = dict(M=M, line=line, rtt0=rtt0, size=size, W=W, alpha=alpha,
                 delivered=delivered, bw=bw, q=q)
    t, dev, batched = _checked(named, _SCAN_FLOW, "fluid_scan")
    consts = dict(dt=dt, steps=steps, g=g, ecn_k=ecn_k, mss=mss, history=history,
                  window=window, atol=atol)
    if dev.type == "cpu" or steps == 0:
        return fluid_scan_plain(*(t[k] for k in ("M", "line", "rtt0", "size", "bw", "W",
                                                 "alpha", "delivered", "q")), **consts)
    if not batched:
        t = {k: v.unsqueeze(0) for k, v in t.items()}
    out = fluid_scan_kernel(t, **consts)
    fluid_scan.launches += 1
    if not batched:
        out = {k: v[0] if v is not None else None for k, v in out.items()}
    return out


fluid_scan.launches = 0


def cca_step(R, W, alpha, delivered, size, line, rtt0, M, q, bw, *,
             dt: float, g: float = 1 / 16, ecn_k: float = 64_000.0,
             mss: float = 1000.0):
    """One DCTCP fluid step; returns ``(R2, W2, alpha2, delivered2,
    arrivals)``.  Inputs are upcast to float32.  On CUDA tensors this
    launches the scan kernel at one step with no histories (and counts one
    launch in ``cca_step.launches``); on CPU tensors it runs
    :func:`cca_step_plain`."""
    named = dict(zip(_STEP_FLOW, (R, W, alpha, delivered, size, line, rtt0)))
    named.update(M=M, q=q, bw=bw)
    t, dev, batched = _checked(named, _STEP_FLOW, "cca_step")
    consts = dict(dt=dt, g=g, ecn_k=ecn_k, mss=mss)
    if dev.type == "cpu":
        return cca_step_plain(*(t[k] for k in (*_STEP_FLOW, "M", "q", "bw")), **consts)
    del t["R"]
    if not batched:
        t = {k: v.unsqueeze(0) for k, v in t.items()}
    out = fluid_scan_kernel(t, steps=1, history=False, **consts)
    cca_step.launches += 1
    res = tuple(out[k] for k in ("rates", "W", "alpha", "delivered", "arrivals"))
    return res if batched else tuple(r[0] for r in res)


cca_step.launches = 0
