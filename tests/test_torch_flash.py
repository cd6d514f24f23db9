"""The port's attention (K4) module against the JAX package's.

On the CPU ``flash_attention`` runs its plain PyTorch version, which is held
to the reference's Pallas kernel (in interpret mode, as
``tests/test_kernels.py`` runs it) and to its oracle ``attention_ref`` at the
reference test's shapes and tolerances.  The hand-written CUDA kernel is
held to the plain version by the ``gpu``-marked tests in
``tests/test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import attention_plain, flash_attention

RNG = np.random.default_rng(13)


@pytest.fixture(autouse=True)
def _reseed():
    """Each test draws the same inputs whatever ran before it in the worker."""
    global RNG
    RNG = np.random.default_rng(13)


# tests/test_kernels.py:136-143
CASES = [
    (1, 2, 2, 128, 64, True, None),
    (2, 4, 2, 256, 64, True, None),     # GQA 2:1
    (1, 8, 1, 128, 128, True, None),    # MQA
    (1, 4, 4, 200, 64, True, None),     # ragged (the reference pads, the port masks)
    (1, 4, 2, 256, 64, True, 128),      # sliding window
    (1, 2, 2, 256, 64, False, None),    # bidirectional (encoder)
]


def _qkv(B, Hq, Hk, S, D):
    return (RNG.normal(size=(B, Hq, S, D)).astype(np.float32),
            RNG.normal(size=(B, Hk, S, D)).astype(np.float32),
            RNG.normal(size=(B, Hk, S, D)).astype(np.float32))


@pytest.mark.parametrize("B,Hq,Hk,S,D,causal,window", CASES)
def test_plain_matches_reference_kernel_and_oracle(B, Hq, Hk, S, D, causal, window):
    q, k, v = _qkv(B, Hq, Hk, S, D)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    assert out.dtype == torch.float32 and out.shape == (B, Hq, S, D)
    kw = dict(causal=causal, window=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_flash(jq, jk, jv, **kw)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(attention_ref(jq, jk, jv, **kw)),
                               rtol=2e-5, atol=2e-5)


def test_plain_bf16():
    """tests/test_kernels.py:157-165: bf16 inputs against the float32 oracle."""
    q, k, v = _qkv(1, 4, 2, 128, 64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    # the oracle sees the same bf16-rounded inputs, widened exactly
    ref = attention_ref(*(jnp.asarray(x.float().numpy()) for x in (tq, tk, tv)))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref), rtol=2e-2, atol=2e-2)
    jout = jax_flash(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (tq, tk, tv)))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_plain_rows_are_convex_combinations():
    """tests/test_kernels.py:168-176: every output row lies in the convex
    hull of V's rows."""
    q, k, v = _qkv(1, 2, 2, 128, 64)
    out = flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    assert out.max() <= float(v.max()) + 1e-4
    assert out.min() >= float(v.min()) - 1e-4


def test_plain_takes_strided_head_major_views():
    """The layers hand over ``[B, S, H, D]`` tensors transposed to
    ``[B, H, S, D]``; the result equals that of contiguous inputs."""
    q, k, v = _qkv(2, 4, 2, 64, 32)
    t = [torch.from_numpy(x).transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    assert not t[0].is_contiguous()
    torch.testing.assert_close(flash_attention(*t, window=16),
                               attention_plain(*map(torch.from_numpy, (q, k, v)), window=16),
                               rtol=0, atol=0)


def test_plain_gives_zero_for_a_row_with_no_key():
    """ref.py:27-29: a fully masked row gives 0 (``_sdpa`` would give the
    mean of v).  Only a window below 1 masks a whole row, and the wrapper
    refuses it, so the plain version is called directly."""
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 2, 16, 32))
    out = attention_plain(q, k, v, causal=True, window=0)
    assert torch.count_nonzero(out) == 0
    ref = attention_ref(*(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True, window=0)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())


def test_cpu_tensors_count_no_launch():
    launches = flash_attention.launches
    flash_attention(*map(torch.from_numpy, _qkv(1, 2, 1, 8, 32)))
    assert flash_attention.launches == launches


@pytest.mark.parametrize("change,error", [
    (dict(D=48), ValueError),                  # head dim outside 32/64/128
    (dict(dtype=torch.float16), TypeError),
    (dict(Hk=3), ValueError),                  # 4 query heads over 3 KV heads
    (dict(window=0), ValueError),
    (dict(k_len=8), ValueError),               # k shorter than q
])
def test_wrapper_refuses_what_the_kernel_does_not_take(change, error):
    D, Hk = change.get("D", 32), change.get("Hk", 2)
    dtype = change.get("dtype", torch.float32)
    q = torch.zeros(1, 4, 16, D, dtype=dtype)
    k = torch.zeros(1, Hk, change.get("k_len", 16), D, dtype=dtype)
    with pytest.raises(error):
        flash_attention(q, k, k.clone(), window=change.get("window"))


def test_kernel_operand_passes_aligned_views_and_copies_the_rest():
    """The bf16 kernel's TMA maps need a 16-byte aligned base and B/H/S
    strides in whole 16 bytes (multiples of 8 in bf16): a ``[B, S, H, D]``
    tensor transposed to ``[B, H, S, D]`` goes through as it is; a view at
    a 2-byte offset, or with a sequence stride of 68 elements, is copied."""
    from repro_torch.kernels.flash_attention.ops import _kernel_operand
    x = torch.zeros(2, 48, 4, 32, dtype=torch.bfloat16).transpose(1, 2)
    assert _kernel_operand(x) is x
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    odd = flat[1:].view(2, 48, 4, 32).transpose(1, 2)          # 2-byte offset
    padded = torch.zeros(2, 48, 2 * 32 + 4, dtype=torch.bfloat16)
    strided = padded[..., :64].unflatten(-1, (2, 32)).transpose(1, 2)   # S stride 68
    assert strided.stride()[:3] == (48 * 68, 32, 68)
    for y in (odd, strided):
        got = _kernel_operand(y)
        assert got is not y and got.is_contiguous() and torch.equal(got, y)
        assert got.data_ptr() % 16 == 0
    # 68 float32 elements are 272 bytes, whole 16 bytes: read in place
    strided32 = torch.zeros(2, 48, 68)[..., :64].unflatten(-1, (2, 32)).transpose(1, 2)
    assert _kernel_operand(strided32) is strided32


def _attention_bf16_p(q, k, v, *, causal, window):
    """The bf16 kernel's arithmetic on the CPU: float32 logits and p, l the
    sum of the float32 p, p rounded to bf16 before p . v (``_sdpa``'s
    rounding), output acc / max(l, 1e-30) in bf16."""
    S, D = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / D ** 0.5
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    mask = (j <= i) if causal else torch.ones(S, S, dtype=torch.bool)
    if window is not None:
        mask &= j > i - window
    logits = torch.where(mask, logits, -torch.inf)
    p = torch.where(mask, torch.exp(logits - logits.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vv)
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("window", [None, 128])
def test_p_rounded_to_bf16_stays_inside_the_bf16_bar(window):
    """Rounding p to bf16 before p . v (the tensor-core kernel's numerics)
    at a granite-like head dim over 300 positions, causal and windowed, is
    within the bf16 bar of the reference's oracle and of the plain version."""
    q, k, v = _qkv(1, 8, 2, 300, 64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = _attention_bf16_p(tq, tk, tv, causal=True, window=window).float()
    ref = attention_ref(*(jnp.asarray(x.float().numpy()) for x in (tq, tk, tv)),
                        causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-2, atol=2e-2)
    plain = attention_plain(tq, tk, tv, causal=True, window=window).float()
    torch.testing.assert_close(got, plain, rtol=2e-2, atol=2e-2)
    assert not torch.equal(got, plain)    # the rounding is there, and small
