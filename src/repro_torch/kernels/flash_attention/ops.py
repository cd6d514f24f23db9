"""Causal / sliding-window attention with grouped KV heads: wrapper, launch
count and plain version.

The CUDA kernels (``repro_torch/csrc/flash_attention.cu``: bf16 on the
tensor cores with ``wgmma`` and a TMA ring, float32 one thread per query
row) replace the Pallas kernel ``_flash_kernel`` of
``repro/kernels/flash_attention/kernel.py``; the source note says what
bounds them on Hopper and how they are laid out.  The
plain version below is the same function in PyTorch, line for line with the
reference's oracle ``repro.kernels.flash_attention.ref.attention_ref``.

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


def attention_plain(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None):
    """Softmax attention in float32 from the inputs, returned in the input
    dtype.  A row with no valid key (only with ``window < 1``, which
    :func:`flash_attention` refuses) gives 0, as in the reference's oracle."""
    B, Hq, S, D = q.shape
    g = Hq // k.shape[1]
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, -torch.inf)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


@functools.cache
def _launcher():
    fn = load("flash_attention")["flash_attention"].cdll.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
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


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None):
    """``[B, Hq, S, D]`` attention output, in the input dtype.  ``window``
    keeps the keys ``kpos > qpos - window`` (``None``: no window);
    ``scale`` defaults to ``1/sqrt(D)``.  Takes float32 or bfloat16 and head
    dims 32, 64 and 128 and raises on anything else.  On CUDA tensors this
    launches the kernel (and counts one launch in
    ``flash_attention.launches``); on CPU tensors it runs
    :func:`attention_plain`."""
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
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    if dev.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window, scale=scale)

    bf16 = q.dtype == torch.bfloat16
    if (-(-S // 128) if bf16 else B * Hq) > 65535:
        raise ValueError(f"flash_attention: B*Hq = {B * Hq}, S = {S} exceed the kernel's grid")
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    out = torch.empty((B, Hq, S, D), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hk, S, D, int(bf16),
            *(s for x in (q, k, v, out) for s in x.stride()[:3]),
            scale, int(causal), window or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
