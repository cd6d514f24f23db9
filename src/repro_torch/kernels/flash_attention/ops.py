"""Causal / sliding-window attention with grouped KV heads: wrappers, launch
counts and plain versions of the forward and of its gradient.

The CUDA kernels (``repro_torch/csrc/flash_attention.cu``: bf16 on the
tensor cores with ``wgmma`` and a TMA ring, float32 one thread per query
row) replace the Pallas kernel ``_flash_kernel`` of
``repro/kernels/flash_attention/kernel.py``; the source note says what
bounds them on Hopper and how they are laid out.  The
plain version below is the same function in PyTorch, line for line with the
reference's oracle ``repro.kernels.flash_attention.ref.attention_ref``.

Gradients: when grad is enabled and an input requires it,
:func:`flash_attention`'s operator (``repro_torch::flash_attention``, a
``torch.library.custom_op`` with a fake implementation and a DTensor
sharding rule) also keeps each row's log-sum-exp, and its backward is
:func:`flash_attention_backward` (``repro_torch/csrc/flash_attention_bwd.cu``
on the card: bf16 on the tensor cores, a pre-pass and the ``wgmma`` + TMA
kernels ``dq_kernel`` and ``dkv_kernel``; float32 two SIMT kernels;
:func:`attention_backward_plain` on the CPU).  The Pallas kernel is forward
only; the reference trains through autodiff of its plain ``_sdpa``.

Layout as in the reference: q is ``[B, Hq, S, D]``, k and v ``[B, Hk, S, D]``
with ``Hq % Hk == 0``; query head h reads KV head ``h // (Hq // Hk)``.  The
kernel takes any element strides along B, H and S (unit stride along D), so
a caller holding ``[B, S, H, D]`` passes ``x.transpose(1, 2)`` without a
copy.  No padding: the kernel masks the ragged edge of the sequence.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import same_device
from repro_torch.kernels.build import load

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def _mask(S: int, causal: bool, window: int | None, device) -> torch.Tensor:
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _masked_logits(q, k, causal, window, scale):
    """float32 scaled logits ``[B, Hq, S, S]``, -inf outside the mask, and
    the mask."""
    S, D = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    kk = k.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    mask = _mask(S, causal, window, q.device)
    return torch.where(mask, logits, -torch.inf), mask


def attention_plain(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None):
    """Softmax attention in float32 from the inputs, returned in the input
    dtype.  A row with no valid key (only with ``window < 1``, which
    :func:`flash_attention` refuses) gives 0, as in the reference's oracle."""
    g = q.shape[1] // k.shape[1]
    logits, mask = _masked_logits(q, k, causal, window, scale)
    vv = v.float().repeat_interleave(g, dim=1)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def attention_lse_plain(q, k, *, causal: bool = True, window: int | None = None,
                        scale: float | None = None):
    """Each row's log-sum-exp of the scaled logits over its valid keys,
    float32 ``[B, Hq, S]``: what the kernels write beside the output when a
    gradient is wanted.  +inf for a row with no valid key, so that the
    backward's ``exp(s - lse)`` is 0 there."""
    lse = torch.logsumexp(_masked_logits(q, k, causal, window, scale)[0], dim=-1)
    return torch.where(torch.isneginf(lse), torch.inf, lse)


def attention_backward_plain(q, k, v, o, dout, lse, *, causal: bool = True,
                             window: int | None = None, scale: float | None = None):
    """(dq, dk, dv) of :func:`attention_plain` at output ``o`` with upstream
    gradient ``dout``, recomputing the probabilities from ``lse``, in
    float32 and returned in the inputs' dtypes: ``P = exp(s - lse)``,
    ``dS = P * (dO v^T - rowsum(dO * o))``, ``dq = scale dS k``,
    ``dk = scale dS^T q`` and ``dv = P^T dO`` summed over the query heads
    that share a KV head.  The same arithmetic as the CUDA backward, whose
    bf16 kernels also round P and dS to bf16 before the products."""
    B, Hq, S, D = q.shape
    Hk = k.shape[1]
    g = Hq // Hk
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    logits, mask = _masked_logits(q, k, causal, window, scale)
    p = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
    do = dout.float()
    vv = v.float().repeat_interleave(g, dim=1)
    kk = k.float().repeat_interleave(g, dim=1)
    delta = (do * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vv) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()).view(B, Hk, g, S, D).sum(2) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do).view(B, Hk, g, S, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _launcher():
    fn = load("flash_attention")["flash_attention"].cdll.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_launcher():
    fn = load("flash_attention_bwd")["flash_attention_bwd"].cdll.flash_attention_backward_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels can read it in place, else a contiguous
    copy.  In place means unit stride along D, a 16-byte aligned base and
    positive B/H/S strides in whole 16 bytes (multiples of 8 elements in
    bf16, of 4 in float32): what the bf16 kernel's TMA tensor maps demand,
    and the float32 kernel's 16-byte loads."""
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s > 0 and s * x.element_size() % 16 == 0 for s in x.stride()[:3])):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check_inputs(q, k, v, window):
    """(device, B, Hq, Hk, S, D) of valid operands; raises on anything the
    kernels do not take."""
    dev = same_device({"q": q, "k": k, "v": v})
    if q.dim() != 4:
        raise ValueError(f"q must be [B, Hq, S, D], got {tuple(q.shape)}")
    B, Hq, S, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[2:] != (S, D) or v.shape != k.shape:
        raise ValueError(f"k and v must be [{B}, Hk, {S}, {D}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    Hk = k.shape[1]
    if Hk < 1 or Hq % Hk:
        raise ValueError(f"query heads {Hq} are not a multiple of KV heads {Hk}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16 inputs of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, got {D}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if S < 1:
        raise ValueError("flash_attention needs at least one position")
    return dev, B, Hq, Hk, S, D


def _forward(q, k, v, causal: bool, window: int | None, scale: float, want_lse: bool):
    """(output, the rows' log-sum-exp or None): the kernel on CUDA tensors
    (one launch), the plain versions on CPU tensors."""
    dev, B, Hq, Hk, S, D = _check_inputs(q, k, v, window)
    if dev.type == "cpu":
        out = attention_plain(q, k, v, causal=causal, window=window, scale=scale)
        lse = (attention_lse_plain(q, k, causal=causal, window=window, scale=scale)
               if want_lse else None)
        return out, lse
    bf16 = q.dtype == torch.bfloat16
    if (-(-S // 128) if bf16 else B * Hq) > 65535:
        raise ValueError(f"flash_attention: B*Hq = {B * Hq}, S = {S} exceed the kernel's grid")
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    out = torch.empty((B, Hq, S, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev) if want_lse else None
    with torch.cuda.device(dev):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if want_lse else None,
            B, Hq, Hk, S, D, int(bf16),
            *(s for x in (q, k, v, out) for s in x.stride()[:3]),
            scale, int(causal), window or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int,
              scale: float, want_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(output, lse): :func:`_forward` as an operator that fake tensors and
    DTensor can carry.  ``window`` 0 is no window; without ``want_lse`` the
    lse is an empty ``[B, Hq, 0]``."""
    out, lse = _forward(q, k, v, causal, window or None, scale, want_lse)
    return out, (lse if want_lse else q.new_empty((q.shape[0], q.shape[1], 0),
                                                  dtype=torch.float32))


@_flash_op.register_fake
def _(q, k, v, causal, window, scale, want_lse):
    _check_inputs(q, k, v, window or None)
    B, Hq, S, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, Hq, S if want_lse else 0), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_backward", mutates_args=())
def _flash_backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                       dout: torch.Tensor, lse: torch.Tensor, causal: bool, window: int,
                       scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_backward` as an operator."""
    return flash_attention_backward(q, k, v, o, dout, lse, causal=causal,
                                    window=window or None, scale=scale)


@_flash_backward_op.register_fake
def _(q, k, v, o, dout, lse, causal, window, scale):
    _check_inputs(q, k, v, window or None)
    return tuple(torch.empty_like(x, memory_format=torch.contiguous_format) for x in (q, k, v))


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, scale, want_lse = inputs
    if want_lse:                           # only a forward that a gradient wants keeps lse
        ctx.save_for_backward(q, k, v, *output)
    ctx.mask = (causal, window, scale)


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors       # unpacked once: remat recomputes them
    dq, dk, dv = torch.ops.repro_torch.flash_attention_backward(q, k, v, out, dout, lse,
                                                                *ctx.mask)
    return dq, dk, dv, None, None, None, None


_flash_op.register_autograd(_backward, setup_context=_setup_context)


def _strategies(q, k, n_out: int, n_in: int, n_other: int) -> list:
    """DTensor strategies of both operators, for one mesh dim (outputs'
    placements, then the inputs'): all replicated; every tensor sharded on
    batch (dim 0); or on heads (dim 1), only where the query and the KV
    heads both divide the whole mesh, so each shard keeps the grouping
    ``h // (Hq // Hk)`` whichever mesh dims shard the heads.  Never a shard
    of q's heads beside replicated KV: DTensor redistributes to one of
    these instead."""
    from torch.distributed.tensor import Replicate, Shard
    n = q.mesh.size()
    heads = (Shard(1),) if q.shape[1] % n == 0 and k.shape[1] % n == 0 else ()
    return [([p] * n_out, [p] * n_in + [None] * n_other)
            for p in (Replicate(), Shard(0), *heads)]


def _register_sharding() -> None:
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _(q, k, v, causal, window, scale, want_lse):
        return _strategies(q, k, 2, 3, 4)

    @register_sharding(torch.ops.repro_torch.flash_attention_backward.default)
    def _(q, k, v, o, dout, lse, causal, window, scale):
        return _strategies(q, k, 3, 6, 3)


_register_sharding()


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None):
    """``[B, Hq, S, D]`` attention output, in the input dtype.  ``window``
    keeps the keys ``kpos > qpos - window`` (``None``: no window);
    ``scale`` defaults to ``1/sqrt(D)``.  Takes float32 or bfloat16 and head
    dims 32, 64 and 128 and raises on anything else.  On CUDA tensors this
    launches the kernel (and counts one launch in
    ``flash_attention.launches``); on CPU tensors it runs
    :func:`attention_plain`.  It runs as the operator
    ``torch.ops.repro_torch.flash_attention``, so fake tensors (their
    shapes) and DTensors (by the strategies of :func:`_sharding`) go
    through it too.  Where grad is enabled and an input requires it, the
    forward also keeps the rows' log-sum-exp and the output carries the
    backward (``torch.ops.repro_torch.flash_attention_backward``)."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    want_lse = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window or 0, scale,
                                                 want_lse)[0]


flash_attention.launches = 0


def flash_attention_backward(q, k, v, o, dout, lse, *, causal: bool = True,
                             window: int | None = None, scale: float | None = None):
    """(dq, dk, dv) of :func:`flash_attention` at its output ``o`` and
    log-sum-exp ``lse`` (float32 ``[B, Hq, S]``), for the upstream gradient
    ``dout``, in the inputs' dtype.  On CUDA tensors this launches the
    backward kernels and counts the call as one in
    ``flash_attention_backward.launches``: the counter counts backward
    calls.  A bf16 call launches three kernels (``delta_kernel``, the
    pre-pass, then the tensor-core ``dq_kernel`` and ``dkv_kernel``), a
    float32 call two (the SIMT ``dq_kernel``, which also computes delta,
    then ``dkv_kernel``).  On CPU tensors it runs
    :func:`attention_backward_plain`."""
    dev, B, Hq, Hk, S, D = _check_inputs(q, k, v, window)
    same_device({"q": q, "o": o, "dout": dout, "lse": lse})
    if o.shape != q.shape or dout.shape != q.shape or not o.dtype == dout.dtype == q.dtype:
        raise ValueError(f"o and dout must be {q.dtype} {tuple(q.shape)}, got "
                         f"{o.dtype} {tuple(o.shape)} and {dout.dtype} {tuple(dout.shape)}")
    if lse.shape != (B, Hq, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{B}, {Hq}, {S}], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if dev.type == "cpu":
        return attention_backward_plain(q, k, v, o, dout, lse, causal=causal, window=window,
                                        scale=scale)
    if B * Hq > 65535:
        raise ValueError(f"flash_attention_backward: B*Hq = {B * Hq} exceeds the kernel's grid")
    q, k, v, o, dout = (_kernel_operand(x) for x in (q, k, v, o, dout))
    lse = lse.contiguous()
    bf16 = q.dtype == torch.bfloat16
    # float32: delta; bf16: lse * log2(e) and delta, rows padded to whole 128-row blocks
    scratch = torch.empty((2, B, Hq, -(-S // 128) * 128) if bf16 else (B, Hq, S),
                          dtype=torch.float32, device=dev)
    dq = torch.empty((B, Hq, S, D), dtype=q.dtype, device=dev)
    dk, dv = (torch.empty((B, Hk, S, D), dtype=q.dtype, device=dev) for _ in range(2))
    strides = (ctypes.c_longlong * 24)(*(s for x in (q, k, v, o, dout, dq, dk, dv)
                                         for s in x.stride()[:3]))
    with torch.cuda.device(dev):
        err = _backward_launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Hq, Hk, S, D, int(bf16), strides,
            scale, int(causal), window or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA error {err}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
