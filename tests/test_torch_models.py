"""The port's architecture zoo (configs, parameters, layers, prefill,
decode, the serving entry point) against the JAX package's.

Weights are the reference's own, drawn by ``Model.init`` in JAX and carried
across by ``params_from_numpy``; inputs are made with numpy.  Everything
runs in float32 on the CPU, where the port's attention is the plain version
of its kernel (the kernel itself is held to it in ``tests/test_torch_gpu.py``).
Tolerances: rms_norm, rope, the q/k/v projections, the attention core on
the reference's own q/k/v, and the MLP elementwise at rtol 1e-5 (atol 1e-5
for entries near zero); the whole attention layer norm-wise at 1e-5, and
prefill and decode norm-wise at 1e-4 (``max|port - ref| <= tol * max|ref|``);
the decode-after-prefill continuation 2e-2 (the bar of
``tests/test_archs.py:125``); greedy tokens exact.

Why norm-wise through the softmax: the reference's initialiser takes the
heads axis of ``wq``/``wk`` as fan-in, so the reduced model's logits reach
about 230 and its softmax is nearly one-hot.  A float32 rounding of q (about
6e-6 at |q| = 22) then moves a logit by about 1e-5 and a near-tied output by
up to 2.5e-4 at entries of 1e-2, while the largest entries (about 30) agree
to 3.5e-6 of their size; the pieces on identical inputs agree elementwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models.api import build_model as jax_build_model
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.api import build_model
from repro_torch.models.params import P, init_params, params_from_numpy

RNG = np.random.default_rng(17)


@pytest.fixture(autouse=True)
def _reseed():
    """Each test draws the same inputs whatever ran before it in the worker."""
    global RNG
    RNG = np.random.default_rng(17)
ALL = sorted(ARCHS)
DENSE = ["granite-3-2b", "llava-next-34b", "mistral-nemo-12b", "mistral-large-123b"]
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LAYER_NORMWISE = 1e-5
MODEL_NORMWISE = 1e-4


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), **tol)


def _close_normwise(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    err, size = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * size, f"max abs error {err} > {tol} x max |ref| {size}"


def _pair(name, seed=0):
    """(port model, JAX model, the JAX model's params as numpy) for the
    reduced config."""
    jm = jax_build_model(JAX_ARCHS[name].reduced())
    return build_model(ARCHS[name].reduced()), jm, jax.device_get(jm.init(jax.random.PRNGKey(seed)))


def _torch_tree(tree):
    return params_from_numpy(tree, "cpu", torch.float32)


def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def _tokens(cfg, B, S):
    return RNG.integers(0, cfg.vocab, (B, S)).astype(np.int32)


# --------------------------------------------------------------------- #
# configs and parameter counts
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ALL)
def test_config_equals_the_reference(name):
    port, ref = ARCHS[name], JAX_ARCHS[name]
    for cfg, jcfg in ((port, ref), (port.reduced(), ref.reduced())):
        fields = [f.name for f in dataclasses.fields(cfg)]
        assert fields == [f.name for f in dataclasses.fields(jcfg)]
        assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
        assert [(tuple(dataclasses.astuple(b) for b in s.blocks), s.repeat)
                for s in cfg.stages()] == [(tuple(dataclasses.astuple(b) for b in s.blocks),
                                            s.repeat) for s in jcfg.stages()]
        assert cfg.layer_windows() == jcfg.layer_windows()
        assert dataclasses.asdict(cfg.traffic_spec()) == dataclasses.asdict(jcfg.traffic_spec())
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("name", ALL)
def test_n_params_equals_the_reference(name):
    """Full configs; counting walks the specs and allocates nothing."""
    assert build_model(ARCHS[name]).n_params == jax_build_model(JAX_ARCHS[name]).n_params


@pytest.mark.parametrize("name", ALL)
def test_cache_specs_equal_the_reference(name):
    got = build_model(ARCHS[name]).cache_specs(4, 2088)
    ref = jax_build_model(JAX_ARCHS[name]).cache_specs(4, 2088)
    shapes = lambda t: {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) else t[0]
    assert shapes(got) == shapes(ref)


def test_params_match_the_reference_tree():
    """Same keys, shapes and stacked layer axis; ones and zeros where the
    reference has them; normal leaves at std scale/sqrt(fan_in)."""
    port, jm, ref = _pair("granite-3-2b")
    got = port.init(0, device="cpu")
    flat = lambda t, pre="": ({f"{pre}{k}/{kk}": vv for k, v in t.items()
                               for kk, vv in flat(v, "").items()}
                              if isinstance(t, dict) else {"": t})
    g, r = flat(got), flat(ref)
    assert g.keys() == r.keys()
    for key in g:
        assert tuple(g[key].shape) == r[key].shape, key
        assert g[key].dtype == torch.float32
    assert torch.equal(got["final_ln"], torch.ones(port.cfg.d_model))
    wi = got["stage0"]["b0"]["ffn"]["wi"]                      # fan_in = d_model
    assert abs(float(wi.std()) * port.cfg.d_model ** 0.5 - 1) < 0.02
    again = port.init(0, device="cpu")
    assert torch.equal(again["embed"], got["embed"])
    assert not torch.equal(port.init(1, device="cpu")["embed"], got["embed"])


def test_init_params_casts_after_drawing_in_float32():
    spec = {"w": P((64, 32), (None, None), scale=2.0), "z": P((3,), (None,), "zeros")}
    a = init_params(spec, torch.Generator().manual_seed(5), torch.bfloat16)
    b = init_params(spec, torch.Generator().manual_seed(5), torch.float32)
    assert a["w"].dtype == torch.bfloat16 and torch.equal(a["w"], b["w"].to(torch.bfloat16))
    assert torch.equal(a["z"], torch.zeros(3, dtype=torch.bfloat16))


def test_params_from_numpy_takes_bfloat16_arrays():
    jm = jax_build_model(dataclasses.replace(JAX_ARCHS["granite-3-2b"].reduced(),
                                             param_dtype="bfloat16"))
    ref = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    got = params_from_numpy(ref, "cpu", torch.bfloat16)
    w = ref["stage0"]["b0"]["mixer"]["wq"]
    assert got["stage0"]["b0"]["mixer"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["stage0"]["b0"]["mixer"]["wq"].float().numpy(),
                                  w.astype(np.float32))


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = build_model(ARCHS["granite-3-2b"].reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "granite-3-2b", "--reduced"])
    assert m.init_cache(1, 8, device="cpu")["stage0"]["b0"]["k"].device.type == "cpu"


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
def test_rms_norm_and_rope_match_the_reference():
    x = RNG.normal(size=(2, 16, 4, 32)).astype(np.float32)
    scale = RNG.normal(size=(32,)).astype(np.float32)
    pos = np.tile(np.arange(100, 116, dtype=np.int32), (2, 1))
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)), **LAYER_TOL)
    _close(L.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e4), **LAYER_TOL)


def test_rms_norm_and_rope_promote_bf16_as_the_reference():
    x = torch.randn(2, 8, 4, 32, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    scale = torch.ones(32, dtype=torch.bfloat16)
    pos = torch.arange(8).expand(2, 8)
    assert L.rms_norm(x, scale).dtype == torch.bfloat16
    assert L.rope(x, pos, 1e4).dtype == torch.bfloat16
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    _close(L.rope(x, pos, 1e4).float(), JL.rope(jx, jnp.asarray(pos.numpy()), 1e4),
           rtol=0, atol=0)


@pytest.mark.parametrize("window", [0, 8])
def test_attention_matches_the_reference(window):
    port, jm, ref = _pair("granite-3-2b")
    cfg = port.cfg
    p = _layer0(ref["stage0"]["b0"]["mixer"])
    x = RNG.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(32), (2, 1))
    tx, tp, tpos = torch.from_numpy(x), _torch_tree(p), torch.from_numpy(pos)
    got = L.attention(tx, tp, cfg, tpos, window)
    want = JL.attention(jnp.asarray(x), p, jm.cfg, jnp.asarray(pos), window)
    _close_normwise(got, want, LAYER_NORMWISE)
    # the pieces: projections, then the attention core on the reference's q, k, v
    h = JL.rms_norm(jnp.asarray(x), p["ln"])
    jq, jk = (JL.rope(jnp.einsum("bsd,dhk->bshk", h, p[w]), jnp.asarray(pos), cfg.rope_theta)
              for w in ("wq", "wk"))
    jv = jnp.einsum("bsd,dhk->bshk", h, p["wv"])
    for t, j in zip(L.project_qkv(tx, tp, cfg, tpos), (jq, jk, jv)):
        _close(t, j, **LAYER_TOL)
    B, S, H, hd = jq.shape
    o = JL._sdpa(jq.reshape(B, S, cfg.n_kv, H // cfg.n_kv, hd), jk, jv, jnp.arange(S),
                 jnp.arange(S), window, True).reshape(B, S, H, hd)
    core = jnp.asarray(x) + jnp.einsum("bshk,hkd->bsd", o, p["wo"])
    _close(L.attend(tx, *(torch.tensor(np.asarray(a)) for a in (jq, jk, jv)), tp, window),
           core, **LAYER_TOL)


def test_attention_decode_matches_the_reference():
    port, jm, ref = _pair("granite-3-2b")
    cfg = port.cfg
    p = _layer0(ref["stage0"]["b0"]["mixer"])
    x = RNG.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    cache = {n: RNG.normal(size=(2, 24, cfg.n_kv, cfg.hd)).astype(np.float32) for n in "kv"}
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    got, gcache = L.attention_decode(torch.from_numpy(x), _torch_tree(p), cfg, tcache, 9, 0)
    want, wcache = JL.attention_decode(jnp.asarray(x), p, jm.cfg,
                                       {n: jnp.asarray(c) for n, c in cache.items()}, 9, 0)
    _close_normwise(got, want, LAYER_NORMWISE)
    assert gcache is tcache                              # updated in place
    for n in "kv":
        _close(gcache[n], wcache[n], **LAYER_TOL)
    with pytest.raises(IndexError):                      # the reference would clamp
        L.attention_decode(torch.from_numpy(x), _torch_tree(p), cfg, tcache, 24, 0)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_the_reference(kind):
    port, jm, ref = _pair("granite-3-2b")
    p = _layer0(ref["stage0"]["b0"]["ffn"])
    if kind == "gelu":
        p = {k: v for k, v in p.items() if k != "wg"}
    x = RNG.normal(size=(2, 16, port.cfg.d_model)).astype(np.float32)
    _close(L.mlp(torch.from_numpy(x), _torch_tree(p)), JL.mlp(jnp.asarray(x), p), **LAYER_TOL)


# --------------------------------------------------------------------- #
# prefill and decode
# --------------------------------------------------------------------- #
def _prefill_batch(cfg, B, S, torch_side: bool):
    batch = {"tokens": _tokens(cfg, B, S)}
    if cfg.frontend == "vision_patches":
        batch["prefix_embeds"] = RNG.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    conv = torch.from_numpy if torch_side else jnp.asarray
    return {k: conv(v) for k, v in batch.items()}, batch


@pytest.mark.parametrize("window", [0, 8])
def test_forward_hidden_matches_the_reference(window):
    """The whole stack, full causal and sliding-window ("swa") attention."""
    swa = dict(attn_kind="swa", window=window) if window else {}
    cfg = dataclasses.replace(ARCHS["granite-3-2b"].reduced(), **swa)
    jcfg = dataclasses.replace(JAX_ARCHS["granite-3-2b"].reduced(), **swa)
    ref = jax.device_get(jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    x = RNG.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(24), (2, 1))
    got = lm.forward_hidden(cfg, _torch_tree(ref), torch.from_numpy(x), torch.from_numpy(pos))
    want = JLM.forward_hidden(jcfg, ref, jnp.asarray(x), jnp.asarray(pos))
    _close_normwise(got, want, MODEL_NORMWISE)
    if window:          # a window shorter than the prompt: prefill lays the cache out as a ring
        tok = _tokens(cfg, 1, 24)
        logits, cache = build_model(cfg).prefill(_torch_tree(ref),
                                                 {"tokens": torch.from_numpy(tok)})
        jlogits, jcache = jax_build_model(jcfg).prefill(ref, {"tokens": jnp.asarray(tok)})
        _close_normwise(logits, jlogits, MODEL_NORMWISE)
        assert cache["stage0"]["b0"]["k"].shape[2] == window
        _close_normwise(cache["stage0"]["b0"]["k"], jcache["stage0"]["b0"]["k"], MODEL_NORMWISE)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_matches_the_reference(name):
    port, jm, ref = _pair(name)
    tb, nb = _prefill_batch(port.cfg, 2, 24, torch_side=True)
    logits, cache = port.prefill(_torch_tree(ref), tb)
    jlogits, jcache = jm.prefill(ref, {k: jnp.asarray(v) for k, v in nb.items()})
    _close_normwise(logits, jlogits, MODEL_NORMWISE)
    assert cache.keys() == jcache.keys()
    for si in cache:
        for n in ("k", "v"):
            _close_normwise(cache[si]["b0"][n], jcache[si]["b0"][n], MODEL_NORMWISE)


def test_decode_step_matches_the_reference():
    port, jm, ref = _pair("granite-3-2b")
    cfg = port.cfg
    B, S = 2, 20
    specs = port.cache_specs(B, S)
    cache = {si: {"b0": {n: RNG.normal(size=sd[0]).astype(np.float32) for n, sd in
                         st["b0"].items()}} for si, st in specs.items()}
    tcache = {si: {"b0": {n: torch.from_numpy(c.copy()) for n, c in st["b0"].items()}}
              for si, st in cache.items()}
    tok = _tokens(cfg, B, 1)
    logits, gcache = port.decode_step(_torch_tree(ref), tcache, torch.from_numpy(tok), 11)
    jlogits, jcache = jm.decode_step(ref, jax.tree.map(jnp.asarray, cache), jnp.asarray(tok), 11)
    assert logits.shape == (B, cfg.vocab)
    _close_normwise(logits, jlogits, MODEL_NORMWISE)
    for n in ("k", "v"):
        _close_normwise(gcache["stage0"]["b0"][n], jcache["stage0"]["b0"][n], MODEL_NORMWISE)


def test_decode_matches_prefill_continuation():
    """tests/test_archs.py:105-128 on the port's own weights: decode after
    prefill gives the next-token logits of a prefill over one more token."""
    m = build_model(ARCHS["granite-3-2b"].reduced())
    params = m.init(1, device="cpu")
    B, S = 1, 16
    toks = torch.from_numpy(_tokens(m.cfg, B, S + 1))
    ref_logits, _ = m.prefill(params, {"tokens": toks})
    _, cache = m.prefill(params, {"tokens": toks[:, :S]})
    cache = serve.grow_cache(m, cache, B, S + 8)
    logits, _ = m.decode_step(params, cache, toks[:, S:S + 1], S)
    _close(logits, ref_logits, rtol=2e-2, atol=2e-2)


def _continuation_err(prefill, decode_step, grow, toks, S):
    ref, _ = prefill({"tokens": toks})
    _, cache = prefill({"tokens": toks[:, :S]})
    logits, _ = decode_step(grow(cache), toks[:, S:S + 1], S)
    a, b = np.asarray(logits, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_deep_continuation_is_chaotic_on_the_reference_init():
    """Why ``chip_smoke.py`` gates its full-depth continuation on tamed
    weights.  The reference's initialiser takes the heads axis as fan-in for
    wq and wk, so deep stacks amplify rounding: at 24 reduced layers the
    JAX package's own decode-after-prefill misses its 2e-2 bar (by 5x or
    more on each of 8 prompts tried).  With wq and wk scaled to a fan-in of
    d_model the port's continuation holds 1e-5."""
    S = 64
    jcfg = dataclasses.replace(JAX_ARCHS["granite-3-2b"].reduced(), n_layers=24)
    jm = jax_build_model(jcfg)
    ref = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (1, S + 1)).astype(np.int32)

    def jgrow(cache):
        full = jm.init_cache(1, S + 8)
        return jax.tree.map(lambda d, c: jax.lax.dynamic_update_slice(
            d, c.astype(d.dtype), (0,) * d.ndim), full, cache)
    jref = jax.tree.map(jnp.asarray, ref)
    jax_err = _continuation_err(jax.jit(lambda b: jm.prefill(jref, b)),
                                jax.jit(lambda c, t, pos: jm.decode_step(jref, c, t, pos)),
                                jgrow, jnp.asarray(toks), S)
    assert jax_err > 2e-2

    m = build_model(dataclasses.replace(ARCHS["granite-3-2b"].reduced(), n_layers=24))
    params = _torch_tree(ref)
    mixer = params["stage0"]["b0"]["mixer"]
    mixer["wq"] *= (m.cfg.n_heads / m.cfg.d_model) ** 0.5
    mixer["wk"] *= (m.cfg.n_kv / m.cfg.d_model) ** 0.5
    tame_err = _continuation_err(lambda b: m.prefill(params, b),
                                 lambda c, t, pos: m.decode_step(params, c, t, pos),
                                 lambda c: serve.grow_cache(m, c, 1, S + 8),
                                 torch.from_numpy(toks), S)
    assert tame_err < 1e-5


# --------------------------------------------------------------------- #
# serving entry point
# --------------------------------------------------------------------- #
def test_serve_tokens_match_the_reference_serve_loop():
    """The reference's serving loop (``repro/launch/serve.py:35-46``: the
    prompt through decode steps, then greedy decode) on the same weights and
    prompt gives the same tokens as the port's prefill-then-decode loop."""
    port, jm, ref = _pair("granite-3-2b")
    B, P, N = 2, 12, 6
    prompt = _tokens(port.cfg, B, P)
    S = P + N + serve.EXTRA_POSITIONS
    decode = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos))
    cache = jm.init_cache(B, S)
    for i in range(P):
        logits, cache = decode(ref, cache, jnp.asarray(prompt[:, i:i + 1]), i)
    tok = jnp.argmax(logits, -1)[:, None]
    want = []
    for i in range(N):
        logits, cache = decode(ref, cache, tok, P + i)
        tok = jnp.argmax(logits, -1)[:, None]
        want.append(tok)
    res = serve.generate(port, _torch_tree(ref), {"tokens": torch.from_numpy(prompt).long()}, N)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(jnp.concatenate(want, 1)))
    assert res.all_finite
    assert res.kernel_launches == {"prefill": 0, "decode": 0}    # plain versions on the CPU


def test_serve_main_runs_on_the_cpu(capsys):
    serve.main(["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "granite-3-2b-smoke: 22 tokens" in out and "on cpu" in out
    assert "logits finite: True" in out
