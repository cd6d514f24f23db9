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
