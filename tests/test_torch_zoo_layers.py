"""The rest of the architecture zoo, layer by layer, against the JAX
package's functions: MoE (both dispatches, the fp8 wire, top-k ties,
capacity in decode), MLA (full sequence and the compressed-cache decode),
cross-attention and bidirectional attention, the sliding-window ring
decode, Mamba, mLSTM and sLSTM.

Weights are the reference's own (its ``init_params`` over the layer's
specs in the reduced config, carried across by ``params_from_numpy``),
inputs numpy draws from a seed, everything float32 on the CPU unless a test says otherwise.
Tolerances: MoE outputs rtol 1e-5 with routing equal; MLA, attention and
the ring decode norm-wise 1e-5 (``max|port - ref| <= tol * max|ref|``:
``tests/test_torch_models.py`` says why norm-wise through a softmax);
Mamba over a sequence rtol 1e-4 (a log-step scan against XLA's associative
scan: the summation order differs), Mamba decode 1e-5; mLSTM and a single
sLSTM step 1e-5, sLSTM over a sequence 1e-4 (the scan carries rounding).
Elementwise bars take atol = rtol x max|ref| for entries near zero."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models import encdec as JE
from repro.models import ssm as JS
from repro.models.params import init_params
from repro_torch.configs.registry import ARCHS
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.params import params_from_numpy

RNG = np.random.default_rng(23)


@pytest.fixture(autouse=True)
def _reseed():
    """Each test draws the same inputs whatever ran before it in the worker."""
    global RNG
    RNG = np.random.default_rng(23)


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * float(np.abs(b).max()))


def _close_normwise(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    err, size = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * size, f"max abs error {err} > {tol} x max |ref| {size}"


SPECS = {"moe": JL.moe_specs, "mla": JL.mla_specs, "attn": JL.attn_specs,
         "xattn": JE._xattn_specs, "mamba": JS.mamba_specs, "mlstm": JS.mlstm_specs,
         "slstm": JS.slstm_specs}


@functools.cache
def _ref_layer(name: str, kind: str):
    """One layer's parameters, drawn by the reference's initialiser."""
    specs = SPECS[kind](JAX_ARCHS[name].reduced(), 1)
    return _layer0(jax.device_get(init_params(specs, jax.random.PRNGKey(0), jnp.float32)))


def _cfgs(name, **over):
    return (dataclasses.replace(ARCHS[name].reduced(), **over),
            dataclasses.replace(JAX_ARCHS[name].reduced(), **over))


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def _ref(fn, jcfg, *args, **static):
    """The reference's ``fn(args[0], args[1], jcfg, *args[2:], **static)``
    under ``jax.jit``: XLA compiles it once instead of op by op."""
    return jax.device_get(jax.jit(lambda *a: fn(a[0], a[1], jcfg, *a[2:], **static))(*args))


def _t(tree):
    if isinstance(tree, dict):
        return params_from_numpy(tree, "cpu", torch.float32)
    return torch.from_numpy(np.array(tree, np.float32))


def _x(cfg, B, S, scale=1.0):
    return (RNG.normal(size=(B, S, cfg.d_model)) * scale).astype(np.float32)


# --------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------- #
MOE_ARCHS = ["mixtral-8x22b", "deepseek-v3-671b", "jamba-v0.1-52b"]


def _moe_params(name):
    """A MoE feed-forward of the reduced model (deepseek's has the shared
    expert)."""
    return _ref_layer(name, "moe")


def _jax_routing(x, p, jcfg):
    """The reference's top-k and its sort-based slots (layers.py:245-266)."""
    B, S, d = x.shape
    T, E, k = B * S, jcfg.moe_experts, jcfg.moe_top_k
    cap = max(1, int(jcfg.capacity_factor * T * k / E))

    def route(x, p):
        h = JL.rms_norm(x, p["ln"]).reshape(T, d)
        gates = jax.nn.softmax(jnp.einsum("td,de->te", h, p["router"]).astype(jnp.float32), -1)
        _, topi = jax.lax.top_k(gates, k)
        e_pair = topi.reshape(T * k)
        order = jnp.argsort(e_pair)
        e_s = e_pair[order]
        pos = jnp.arange(T * k) - jnp.searchsorted(e_s, e_s, side="left")
        return topi, order, jnp.where(pos < cap, e_s * cap + pos, E * cap)
    return (*jax.device_get(jax.jit(route)(x, p)), cap)


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_matches_the_reference(name, capacity_factor, dispatch):
    """Routing equal (experts, sort order, slots and drops); outputs rtol
    1e-5.  A capacity factor of 0.5 drops about half the pairs."""
    cfg, jcfg = _cfgs(name, capacity_factor=capacity_factor, moe_dispatch=dispatch)
    p = _moe_params(name)
    x = _x(cfg, 2, 24)
    got = L.moe(_t(x), _t(p), cfg)
    want = _ref(JL.moe, jcfg, x, p)
    _close(got, want, 1e-5)

    topi, order, slot, cap = _jax_routing(x, p, jcfg)
    h = L.rms_norm(_t(x), _t(p)["ln"]).reshape(-1, cfg.d_model)
    _, t_topi = L.moe_route(h, _t(p), cfg)
    np.testing.assert_array_equal(t_topi.numpy(), topi)
    t_order, t_slot, t_keep = L.moe_slots(t_topi, cfg.moe_experts, cap)
    np.testing.assert_array_equal(t_order.numpy(), order)
    np.testing.assert_array_equal(t_slot.numpy(), slot)
    if capacity_factor < 1:
        assert not bool(t_keep.all())                    # the drops are exercised


def test_moe_top_k_ties_take_the_lower_expert():
    """A router of zeros ties every expert: the reference's ``lax.top_k``
    takes experts 0 and 1, and so does the port (``torch.topk`` promises
    no order among ties)."""
    cfg, jcfg = _cfgs("mixtral-8x22b")
    p = dict(_moe_params("mixtral-8x22b"))
    p["router"] = np.zeros_like(p["router"])
    x = _x(cfg, 2, 8)
    _, topi = L.moe_route(torch.from_numpy(x).reshape(16, -1), _t(p), cfg)
    assert topi.tolist() == [[0, 1]] * 16
    np.testing.assert_array_equal(topi.numpy(), _jax_routing(x, p, jcfg)[0])
    _close(L.moe(_t(x), _t(p), cfg), _ref(JL.moe, jcfg, x, p), 1e-5)


def test_moe_capacity_in_decode_drops_as_the_reference():
    """One decode token at batch 2: capacity 1 a expert.  Two identical
    tokens choose the same two experts, so the second is dropped from both,
    and its feed-forward adds nothing, in the reference and the port."""
    cfg, jcfg = _cfgs("mixtral-8x22b")
    p = _moe_params("mixtral-8x22b")
    assert L.moe_capacity(cfg, 2) == 1
    x = np.repeat(_x(cfg, 1, 1), 2, axis=0)                     # [2, 1, d]
    for dispatch in ("gather", "einsum"):
        c, jc = (dataclasses.replace(a, moe_dispatch=dispatch) for a in (cfg, jcfg))
        got = L.moe(_t(x), _t(p), c)
        want = _ref(JL.moe, jc, x, p)
        _close(got, want, 1e-5)
        np.testing.assert_array_equal(got[1].numpy(), x[1])        # dropped: residual only
        assert not np.allclose(got[0].numpy(), x[0])


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_fp8_wire_is_non_finite_where_xla_is(dtype):
    """XLA converts |x| > 464 and non-finite values to e4m3fn's NaN, torch
    saturates them to ±448: the port reproduces the reference's wire
    (464 itself rounds to 448, ties to even), and agrees everywhere else."""
    vals = np.concatenate([RNG.normal(size=200) * 300, [448, 463.9, 464, 464.5, 465, 1e4,
                                                        -464, -470, np.inf, -np.inf, np.nan]])
    jx = jnp.asarray(vals.astype(np.float32)).astype(jnp.bfloat16 if dtype == "bfloat16"
                                                     else jnp.float32)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32)))
    if dtype == "bfloat16":
        tx = tx.bfloat16()
    want = np.asarray(jx.astype(jnp.float8_e4m3fn).astype(jnp.float32))
    got = L.fp8_wire(tx, "float8_e4m3fn").float().numpy()
    np.testing.assert_array_equal(got, want)                     # NaN where NaN
    assert np.isnan(want).sum() >= 6 and not np.isnan(want[:200][np.abs(vals[:200]) <= 464]).any()


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_moe_with_the_fp8_wire_matches_the_reference(name):
    cfg, jcfg = _cfgs(name, moe_a2a_dtype="float8_e4m3fn")
    p = _moe_params(name)
    x = _x(cfg, 2, 24)
    _close(L.moe(_t(x), _t(p), cfg), _ref(JL.moe, jcfg, x, p), 1e-5)


def test_moe_einsum_counts_slots_in_integers_where_the_reference_miscounts_in_bf16():
    """The reference's ``moe_einsum`` takes slot positions from a cumsum in
    the activation dtype (layers.py:307): in bf16 it reads 256, 256, 258,
    260, 260, ... past 256 pairs an expert, so two tokens share a slot and
    its einsum dispatch stops equalling its gather dispatch.  The port
    counts in integers: its two dispatches agree to bf16 rounding."""
    over = dict(dtype="bfloat16", param_dtype="bfloat16", capacity_factor=2.0)
    cfg, jcfg = _cfgs("mixtral-8x22b", **over)
    p = _moe_params("mixtral-8x22b")
    x = _x(cfg, 1, 600)                      # 1200 pairs over 4 experts, all kept (cap 600)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p)
    counts = np.bincount(_jax_routing(x, p, jcfg)[0].ravel(), minlength=4)
    assert counts.max() > 300 and L.moe_capacity(cfg, 600) >= counts.max()

    def rel(a, b):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return float(np.abs(a - b).max() / np.abs(b).max())
    ref_gap = rel(_ref(JL.moe_einsum, jcfg, jx, jp), _ref(JL.moe_gather, jcfg, jx, jp))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).bfloat16()
    tp = params_from_numpy(jax.device_get(jp), "cpu", torch.bfloat16)
    port_gap = rel(L.moe_einsum(tx, tp, cfg).float(), L.moe_gather(tx, tp, cfg).float())
    assert ref_gap > 0.1, ref_gap
    assert port_gap < 2e-2, port_gap


# --------------------------------------------------------------------- #
# MLA
# --------------------------------------------------------------------- #
def _mla_params():
    return _ref_layer("deepseek-v3-671b", "mla")


def test_mla_attention_matches_the_reference():
    cfg, jcfg = _cfgs("deepseek-v3-671b")
    p = _mla_params()
    x = _x(cfg, 2, 24)
    pos = np.tile(np.arange(24), (2, 1))
    for t, j in zip(L.mla_qkv(_t(x), _t(p), cfg, torch.from_numpy(pos)),
                    _ref(JL._mla_qkv, jcfg, x, p, pos)):
        _close(t, j.reshape(t.shape), 1e-5)                     # k_rope: the head axis dropped
    _close_normwise(L.mla_attention(_t(x), _t(p), cfg, torch.from_numpy(pos)),
                    _ref(JL.mla_attention, jcfg, x, p, pos), 1e-5)


def test_mla_decode_matches_the_reference():
    cfg, jcfg = _cfgs("deepseek-v3-671b")
    p = _mla_params()
    x = _x(cfg, 2, 1)
    cache = {"c_kv": RNG.normal(size=(2, 20, cfg.kv_lora)).astype(np.float32),
             "k_rope": RNG.normal(size=(2, 20, cfg.rope_dim)).astype(np.float32)}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, gcache = L.mla_decode(_t(x), _t(p), cfg, tcache, 9)
    want, wcache = _ref(JL.mla_decode, jcfg, x, p, cache, 9)
    _close_normwise(got, want, 1e-5)
    assert gcache is tcache                                    # written in place
    for k in cache:
        _close(gcache[k], wcache[k], 1e-5)
    with pytest.raises(IndexError):
        L.mla_decode(_t(x), _t(p), cfg, tcache, 20)


# --------------------------------------------------------------------- #
# attention: cross, bidirectional, the ring decode
# --------------------------------------------------------------------- #
def test_cross_attention_matches_the_reference():
    """Whisper's decoder over encoder states of another length."""
    cfg, jcfg = _cfgs("whisper-large-v3")
    p = _ref_layer("whisper-large-v3", "xattn")
    x, enc = _x(cfg, 2, 12), _x(cfg, 2, 40)
    pos = np.tile(np.arange(12), (2, 1))
    got = L.attention(_t(x), _t(p), cfg, torch.from_numpy(pos), 0, causal=False, kv_x=_t(enc))
    want = _ref(JL.attention, jcfg, x, p, pos, 0, causal=False, kv_x=jnp.asarray(enc))
    _close_normwise(got, want, 1e-5)


def test_bidirectional_attention_matches_the_reference():
    """Whisper's encoder layer: every key, through the kernel's plain version."""
    cfg, jcfg = _cfgs("whisper-large-v3")
    p = _ref_layer("whisper-large-v3", "attn")
    x = _x(cfg, 2, 40)
    pos = np.tile(np.arange(40), (2, 1))
    _close_normwise(L.attention(_t(x), _t(p), cfg, torch.from_numpy(pos), 0, causal=False),
                    _ref(JL.attention, jcfg, x, p, pos, 0, causal=False),
                    1e-5)


@pytest.mark.parametrize("tbuf,pos", [(64, 10), (64, 63), (64, 64), (64, 100), (64, 200),
                                      (32, 20), (32, 50)])
def test_ring_decode_matches_the_reference(tbuf, pos):
    """gemma3's local layer (window 64 in the reduced config) over a ring
    of 64 slots, before and after it wraps, and over a ring shorter than
    the window (a cache capacity below it)."""
    cfg, jcfg = _cfgs("gemma3-27b")
    w = cfg.window
    p = _ref_layer("gemma3-27b", "attn")
    x = _x(cfg, 2, 1)
    cache = {n: RNG.normal(size=(2, tbuf, cfg.n_kv, cfg.hd)).astype(np.float32) for n in "kv"}
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    got, gcache = L.ring_decode(_t(x), _t(p), cfg, tcache, pos, w)
    want, wcache = _ref(JLM._decode_ring, jcfg, x, p, cache, pos, w)
    _close_normwise(got, want, 1e-5)
    for n in "kv":
        _close(gcache[n], wcache[n], 1e-5)


# --------------------------------------------------------------------- #
# Mamba, mLSTM, sLSTM
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seq", [24, 300, 512])
def test_mamba_matches_the_reference(seq):
    """One chunk (S <= 256), 300 one-step chunks (256 does not divide S),
    two chunks of 256: output, the last state and the conv tail."""
    cfg, jcfg = _cfgs("jamba-v0.1-52b")
    p = _ref_layer("jamba-v0.1-52b", "mamba")
    x = _x(cfg, 2, seq)
    got, state = SSM.mamba_prefill(_t(x), _t(p), cfg)
    _close(got, _ref(JS.mamba, jcfg, x, p), 1e-4)
    assert torch.equal(SSM.mamba(_t(x), _t(p), cfg), got)
    xz = jnp.einsum("bsd,de->bse", JL.rms_norm(jnp.asarray(x), p["ln"]), p["in_proj"])
    _, h_last, conv_last = _ref(JS._mamba_core, jcfg, xz, p)
    _close(state["h"], h_last, 1e-4)
    _close(state["conv"], conv_last, 1e-5)


def test_mamba_decode_matches_the_reference():
    cfg, jcfg = _cfgs("jamba-v0.1-52b")
    p = _ref_layer("jamba-v0.1-52b", "mamba")
    di = cfg.expand * cfg.d_model
    x = _x(cfg, 2, 1)
    cache = {"h": RNG.normal(size=(2, di, cfg.d_state)).astype(np.float32),
             "conv": RNG.normal(size=(2, cfg.conv_kernel - 1, di)).astype(np.float32)}
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, gcache = SSM.mamba_decode(_t(x), _t(p), cfg, tcache, 5)
    want, wcache = _ref(JS.mamba_decode, jcfg, x, p, cache, 5)
    _close(got, want, 1e-5)
    assert gcache is tcache
    for k in cache:
        _close(gcache[k], wcache[k], 1e-5)


def test_mlstm_parallel_form_matches_the_reference():
    cfg, jcfg = _cfgs("xlstm-125m")
    p = _ref_layer("xlstm-125m", "mlstm")
    x = _x(cfg, 2, 48)
    _close(SSM.mlstm(_t(x), _t(p), cfg), _ref(JS.mlstm, jcfg, x, p), 1e-5)


def _mlstm_cache(cfg):
    H = cfg.n_heads
    hd = cfg.expand * cfg.d_model // H
    return {"C": RNG.normal(size=(2, H, hd, hd)).astype(np.float32),
            "n": RNG.normal(size=(2, H, hd)).astype(np.float32),
            "m": RNG.normal(size=(2, H)).astype(np.float32)}


def _slstm_cache(cfg):
    H = cfg.n_heads
    hd = cfg.expand * cfg.d_model // H
    c = {k: RNG.normal(size=(2, H, hd)).astype(np.float32) for k in ("c", "h", "m")}
    c["n"] = RNG.uniform(0.5, 2.0, size=(2, H, hd)).astype(np.float32)
    return c


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_recurrent_decode_matches_the_reference(kind):
    """One step from a random state, and from the start state (the
    stabiliser at -1e30), written in place."""
    cfg, jcfg = _cfgs("xlstm-125m")
    p = _ref_layer("xlstm-125m", kind)
    port_fn, ref_fn = ((SSM.mlstm_decode, JS.mlstm_decode) if kind == "mlstm"
                       else (SSM.slstm_decode, JS.slstm_decode))
    start = (SSM.mlstm_state if kind == "mlstm" else SSM.slstm_state)(2, cfg, "cpu")
    for cache in ((_mlstm_cache if kind == "mlstm" else _slstm_cache)(cfg),
                  {k: v.numpy().copy() for k, v in start.items()}):
        x = _x(cfg, 2, 1)
        tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        got, gcache = port_fn(_t(x), _t(p), cfg, tcache, 3)
        want, wcache = _ref(ref_fn, jcfg, x, p, cache, 3)
        _close(got, want, 1e-5)
        assert gcache is tcache
        for k in cache:
            _close(gcache[k], wcache[k], 1e-5)


def test_slstm_sequence_matches_the_reference():
    cfg, jcfg = _cfgs("xlstm-125m")
    p = _ref_layer("xlstm-125m", "slstm")
    x = _x(cfg, 2, 48)
    _close(SSM.slstm(_t(x), _t(p), cfg), _ref(JS.slstm, jcfg, x, p), 1e-4)
