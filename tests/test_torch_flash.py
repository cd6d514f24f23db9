"""The port's attention (K4) module against the JAX package's.

On the CPU ``flash_attention`` runs its plain PyTorch version, which is held
to the reference's Pallas kernel (in interpret mode, as
``tests/test_kernels.py`` runs it) and to its oracle ``attention_ref`` at the
reference test's shapes and tolerances.  Its gradient (the autograd
Function over ``attention_lse_plain`` and ``attention_backward_plain`` on
the CPU) is held to autograd of ``attention_plain`` and to ``jax.grad`` of
``attention_ref``, and so is a CPU emulation of the bf16 backward kernels'
arithmetic (P and dS rounded to bf16 before the products).  The
hand-written CUDA kernels are held to the plain versions by the
``gpu``-marked tests in ``tests/test_torch_gpu.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import (attention_backward_plain,
                                                 attention_lse_plain, attention_plain,
                                                 flash_attention, flash_attention_backward)

RNG = np.random.default_rng(13)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its tensors are small, and
    under ``pytest -n`` a worker whose threads wait at each op's barrier
    for cores the other workers hold runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# --------------------------------------------------------------------- #
# the gradient
# --------------------------------------------------------------------- #
GRAD_NORMWISE = {"float32": 1e-5, "bfloat16": 2e-2}   # max|port - ref| over max|ref|
GRAD_CASES = CASES + [
    (1, 4, 2, 96, 32, True, None),      # D 32
    (1, 4, 2, 100, 128, True, 16),      # D 128, window, ragged
    (2, 6, 3, 77, 64, False, None),     # bidirectional, GQA 2, ragged
]


def _normwise(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jax_grads(q, k, v, do, **kw):
    """jax.grad of sum(attention_ref(q, k, v) * do) with respect to q, k, v."""
    return jax.grad(lambda q, k, v: jnp.sum(attention_ref(q, k, v, **kw) * do),
                    argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hk,S,D,causal,window", GRAD_CASES)
def test_backward_plain_matches_autograd_and_jax_grad(B, Hq, Hk, S, D, causal, window,
                                                      dtype):
    """``attention_backward_plain`` from the saved output and log-sum-exp
    equals autograd of ``attention_plain`` (float32 rounding apart), the
    wrapper's autograd Function gives exactly ``attention_backward_plain``,
    and all of them match ``jax.grad`` of the reference's oracle on the same
    (bf16-rounded) inputs; the log-sum-exp matches ``jax.nn.logsumexp`` of
    the oracle's masked logits."""
    kw = dict(causal=causal, window=window)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(tdt).requires_grad_() for x in _qkv(B, Hq, Hk, S, D))
    do = torch.from_numpy(RNG.normal(size=(B, Hq, S, D)).astype(np.float32)).to(tdt)
    out = attention_plain(q, k, v, **kw)
    auto = torch.autograd.grad(out, (q, k, v), do)
    lse = attention_lse_plain(q.detach(), k.detach(), **kw)
    plain = attention_backward_plain(q.detach(), k.detach(), v.detach(), out.detach(), do,
                                     lse, **kw)
    via = flash_attention(q, k, v, **kw)
    assert "repro_torch_flash_attention" in type(via.grad_fn).__name__
    via = torch.autograd.grad(via, (q, k, v), do)
    wide = [x.detach().float().numpy() for x in (q, k, v, do)]
    jgrads = _jax_grads(*wide, **kw)
    logits = np.einsum("bhqd,bhkd->bhqk", wide[0], np.repeat(wide[1], Hq // Hk, 1)) * D ** -0.5
    i = np.arange(S)
    mask = np.ones((S, S), bool) if not causal else i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    want_lse = jax.nn.logsumexp(jnp.where(mask, logits, -jnp.inf), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5, atol=1e-5)
    tol = GRAD_NORMWISE[dtype]
    for name, p, a, w, j in zip("qkv", plain, auto, via, jgrads):
        assert p.dtype == tdt and p.shape == a.shape
        assert torch.equal(w, p), name
        assert _normwise(p.float(), a.float()) <= tol, name
        for got in (p, a):
            assert _normwise(got.float(), j) <= tol, name


def _backward_bf16_tensor_cores(q, k, v, o, dout, lse, *, causal, window):
    """The bf16 backward kernels' arithmetic on the CPU: float32 logits from
    the bf16 inputs, ``P = exp(s - lse)`` and ``delta = rowsum(dO * O)``
    (from the bf16 O and dO) in float32, ``dS = P (dO V^T - delta)``; P and
    dS rounded to bf16 before the four products ``dV = P^T dO``,
    ``dK = scale dS^T Q`` and ``dQ = scale dS K``, which accumulate in
    float32; the gradients in bf16."""
    B, Hq, S, D = q.shape
    Hk = k.shape[1]
    g = Hq // Hk
    scale = D ** -0.5
    kk, vv = (x.float().repeat_interleave(g, dim=1) for x in (k, v))
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    mask = (j <= i) if causal else torch.ones(S, S, dtype=torch.bool)
    if window is not None:
        mask &= j > i - window
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    p = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
    do = dout.float()
    delta = (do * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vv) - delta)
    p, ds = (x.to(torch.bfloat16).float() for x in (p, ds))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do).view(B, Hk, g, S, D).sum(2)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()).view(B, Hk, g, S, D).sum(2) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


@pytest.mark.parametrize("B,Hq,Hk,S,D,causal,window", GRAD_CASES + [
    (1, 8, 2, 256, 64, True, None),     # granite-3-2b's head layout (32/8 heads of 64)
])
def test_p_and_ds_rounded_to_bf16_stay_inside_the_bf16_bar(B, Hq, Hk, S, D, causal, window):
    """The tensor-core backward's numerics (P and dS rounded to bf16 before
    the products) are within the bf16 gradient bar of
    ``attention_backward_plain`` and of ``jax.grad`` of the reference's
    oracle on the same bf16-rounded inputs."""
    kw = dict(causal=causal, window=window)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(B, Hq, Hk, S, D))
    do = torch.from_numpy(RNG.normal(size=(B, Hq, S, D)).astype(np.float32)).to(torch.bfloat16)
    o = attention_plain(q, k, v, **kw)
    lse = attention_lse_plain(q, k, **kw)
    got = _backward_bf16_tensor_cores(q, k, v, o, do, lse, **kw)
    plain = attention_backward_plain(q, k, v, o, do, lse, **kw)
    jgrads = _jax_grads(*(x.float().numpy() for x in (q, k, v, do)), **kw)
    tol = GRAD_NORMWISE["bfloat16"]
    for name, a, p, j in zip("qkv", got, plain, jgrads):
        assert a.dtype == torch.bfloat16 and a.shape == p.shape, name
        assert _normwise(a.float(), p.float()) <= tol, name
        assert _normwise(a.float(), j) <= tol, name
    assert not all(torch.equal(a, p) for a, p in zip(got, plain))   # the rounding is there


def test_gradient_path_only_where_a_gradient_is_wanted():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 1, 16, 32))
    assert flash_attention(q, k, v).grad_fn is None
    with torch.no_grad():
        assert flash_attention(q, k, v.requires_grad_()).grad_fn is None
    n = flash_attention.launches, flash_attention_backward.launches
    flash_attention(q, k, v).sum().backward()
    assert v.grad is not None and q.grad is None
    assert (flash_attention.launches, flash_attention_backward.launches) == n   # CPU


def test_backward_wrapper_refuses_mismatched_saved_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 1, 16, 32))
    o, lse = attention_plain(q, k, v), attention_lse_plain(q, k)
    for args in ((o[:, :, :8], o, lse), (o, o.double(), lse), (o, o, lse[:, :1]),
                 (o, o, lse.double())):
        with pytest.raises(ValueError):
            flash_attention_backward(q, k, v, *args)
