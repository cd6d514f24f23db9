"""Every registered architecture's serving path against the JAX package:
``forward_hidden`` (the encoder-decoder's encoder and decoder), ``prefill``
(logits and every cache leaf) and one ``decode_step`` from the same cache,
then decode after prefill against a prefill over one more token, and the
serving loop with the frontend stubs.

Setup: the reduced configs in float32 on the CPU, weights from the
reference's ``Model.init`` carried across by ``params_from_numpy``, inputs
numpy draws from a seed.  The attention layers' ``wq`` and ``wk`` are
scaled to a fan-in of d_model before either package sees them: the
reference's initialiser takes the heads axis as fan-in, so its logits have
a std near 16 at these widths and a deep stack is chaotic (gemma3's 62
reduced layers amplify a float32 rounding about 100x every 6 layers, and
``tests/test_torch_models.py::test_deep_continuation_is_chaotic_on_the_reference_init``
shows the JAX package missing its own continuation bar).  The layer tests
(``tests/test_torch_zoo_layers.py``) hold each layer on the untouched
initialiser.

Tolerances: prefill, decode and the forward passes norm-wise 1e-4
(``max|port - ref| <= tol * max|ref|``); decode after prefill at the bars
of ``tests/test_archs.py:152-189``: 5e-2, and for MoE architectures the
argmax equal and max abs error under 0.25, at a capacity that drops
nothing (the test says why).  The prompt (80 tokens) is longer than the
reduced sliding windows (64), so the ring caches wrap."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models.api import build_model as jax_build_model
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import serve
from repro_torch.models import encdec, lm
from repro_torch.models.api import build_model
from repro_torch.models.crosscheck import card_vs_cpu, flatten, tame
from repro_torch.models.params import params_from_numpy

ALL = sorted(ARCHS)
LM_ARCHS = [n for n in ALL if not ARCHS[n].enc_dec]
NORMWISE = 1e-4
CONTINUATION_TOL = 5e-2                 # tests/test_archs.py:189
MOE_CONTINUATION_MAX_ABS = 0.25         # tests/test_archs.py:186
NO_DROP_CAPACITY = 4.0                  # top-2 of 4 experts: every pair gets a slot
PROMPT = 80                             # > the reduced windows (64): the rings wrap
ENC_FRAMES = 40
RNG = np.random.default_rng(29)


@pytest.fixture(autouse=True)
def _reseed():
    """Each test draws the same inputs whatever ran before it in the worker."""
    global RNG
    RNG = np.random.default_rng(29)


def _normwise_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _close_normwise(a, b, tol=NORMWISE, what=""):
    err = _normwise_err(a, b)
    assert err <= tol, f"{what}: norm-wise error {err} > {tol}"


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.strip("/").split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


@functools.cache
def _setup(name):
    """(port model, JAX model, the reference's weights as numpy, tamed)."""
    jm = jax_build_model(JAX_ARCHS[name].reduced())
    ref = tame(jax.device_get(jm.init(jax.random.PRNGKey(0))))
    return build_model(ARCHS[name].reduced()), jm, ref


def _torch(tree):
    return params_from_numpy(tree, "cpu", torch.float32)


def _batch(cfg, B, S):
    """numpy prefill batch: tokens, and the frontend stub's embeddings."""
    batch = {"tokens": RNG.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend:
        n = ENC_FRAMES if cfg.enc_dec else cfg.n_patches
        batch["prefix_embeds"] = RNG.normal(size=(B, n, cfg.d_model)).astype(np.float32)
    return batch


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


@functools.cache
def _jit_steps(name):
    _, jm, _ = _setup(name)
    return jax.jit(jm.prefill), jax.jit(jm.decode_step)


def _jax_decoder_self_kv(jcfg, ref, tokens, enc_out):
    """The self-attention k/v of every decoder layer, from the reference's
    own layers (its ``prefill`` does not return them)."""
    x = JE._pos_add(ref["embed"][tokens] * (jcfg.d_model ** 0.5), ref["dec_pos"])
    B, T, _ = x.shape
    positions = jnp.broadcast_to(jnp.arange(T), (B, T))
    ks, vs = [], []
    for r in range(jcfg.n_layers):
        lp = jax.tree.map(lambda a: a[r], ref["dec"])
        h = JL.rms_norm(x, lp["self"]["ln"])
        ks.append(jnp.einsum("btd,dhk->bthk", h, lp["self"]["wk"]))
        vs.append(jnp.einsum("btd,dhk->bthk", h, lp["self"]["wv"]))
        x = JL.attention(x, lp["self"], jcfg, positions, window=0)
        x = JL.attention(x, lp["cross"], jcfg, positions, window=0, causal=False, kv_x=enc_out)
        x = JL.mlp(x, lp["mlp"])
    return {"k": jnp.stack(ks), "v": jnp.stack(vs)}


# --------------------------------------------------------------------- #
# forward passes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", LM_ARCHS)
def test_forward_hidden_matches_the_reference(name):
    port, jm, ref = _setup(name)
    x = RNG.normal(size=(2, 24, port.cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(24), (2, 1))
    got = lm.forward_hidden(port.cfg, _torch(ref), torch.from_numpy(x), torch.from_numpy(pos))
    want = jax.jit(lambda p, x, pos: JLM.forward_hidden(jm.cfg, p, x, pos))(ref, x, pos)
    _close_normwise(got, want, what=name)


def test_encoder_and_decoder_match_the_reference():
    port, jm, ref = _setup("whisper-large-v3")
    cfg = port.cfg
    frames = RNG.normal(size=(2, ENC_FRAMES, cfg.d_model)).astype(np.float32)
    tokens = RNG.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    params = _torch(ref)
    enc = encdec.encode(cfg, params, torch.from_numpy(frames))
    want_enc = jax.jit(lambda p, f: JE.encode(jm.cfg, p, f))(ref, frames)
    _close_normwise(enc, want_enc, what="encode")
    h, self_kv = encdec._decoder(cfg, params, torch.from_numpy(tokens).long(),
                                 torch.from_numpy(np.array(want_enc)))
    _close_normwise(h, jax.jit(lambda p, t, e: JE._decoder(jm.cfg, p, t, e))(
        ref, tokens, want_enc), what="decoder")
    want_kv = jax.jit(lambda p, t, e: _jax_decoder_self_kv(jm.cfg, p, t, e))(
        ref, tokens, want_enc)
    for n in "kv":
        _close_normwise(self_kv[n], want_kv[n], what=f"self {n}")


# --------------------------------------------------------------------- #
# prefill, then one decode step from the same cache
# --------------------------------------------------------------------- #
def _jax_grow(jm, cache, B, S):
    """The reference test's ``blend`` (tests/test_archs.py:170-176): each
    leaf in a zero cache of capacity S at its leading positions; the
    encoder-decoder's cross cache as prefill made it."""
    full = jax.device_get(jm.init_cache(B, S))
    if jm.is_encdec:
        full = {"self": full["self"], "cross": cache["cross"]}

    def blend(dst, src):
        out = np.zeros(dst.shape, np.float32)
        out[tuple(slice(0, n) for n in src.shape)] = src
        return out
    return {k: blend(full_leaf, flatten(cache).get(k, full_leaf))
            for k, full_leaf in flatten(full).items()}


@pytest.mark.parametrize("name", ALL)
def test_prefill_and_decode_match_the_reference(name):
    """Prefill over 80 tokens: logits and every cache leaf (ring layouts,
    the compressed MLA cache, Mamba/mLSTM/sLSTM state, Whisper's cross
    cache; Whisper's self cache against the reference's own layers).  Then
    one decode step of both packages from the reference's grown cache:
    logits and every cache leaf, the port's written in place."""
    port, jm, ref = _setup(name)
    cfg = port.cfg
    B, S = 2, PROMPT
    batch = _batch(cfg, B, S)
    jprefill, jdecode = _jit_steps(name)
    logits, cache = port.prefill(_torch(ref), _tbatch(batch))
    jlogits, jcache = jax.device_get(jprefill(ref, batch))
    _close_normwise(logits, jlogits, what="prefill logits")
    got, want = flatten(cache), flatten(jcache)
    if port.is_encdec:
        assert got.keys() == {"/self/k", "/self/v", "/cross/k", "/cross/v"}
        self_kv = jax.jit(lambda p, t, f: _jax_decoder_self_kv(
            jm.cfg, p, t, JE.encode(jm.cfg, p, f)))(ref, batch["tokens"], batch["prefix_embeds"])
        want.update({f"/self/{n}": a for n, a in jax.device_get(self_kv).items()})
        jcache = _unflat(want)
    assert got.keys() == want.keys()
    for k in got:
        _close_normwise(got[k], want[k], what=f"prefill cache {k}")

    P = serve.prompt_positions(port, batch)
    grown = _jax_grow(jm, jcache, B, P + 8)
    tcache = _unflat({k: torch.from_numpy(v.copy()) for k, v in grown.items()})
    tok = RNG.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    logits, gcache = port.decode_step(_torch(ref), tcache, torch.from_numpy(tok).long(), P)
    jlogits, jcache = jax.device_get(jdecode(ref, _unflat(grown), tok, P))
    assert gcache is tcache
    _close_normwise(logits, jlogits, what="decode logits")
    got, want = flatten(gcache), flatten(jcache)
    assert got.keys() == want.keys()
    for k in got:
        _close_normwise(got[k], want[k], what=f"decode cache {k}")


# --------------------------------------------------------------------- #
# decode after prefill, and the serving loop
# --------------------------------------------------------------------- #
def _continuation(port, params, batch, S):
    """(logits of a prefill over S + 1 tokens, logits of a prefill over S
    then a decode step of token S)."""
    full = _tbatch(batch)
    short = {**full, "tokens": full["tokens"][:, :S]}
    want, _ = port.prefill(params, full)
    _, cache = port.prefill(params, short)
    P = serve.prompt_positions(port, short)
    cache = serve.grow_cache(port, cache, full["tokens"].shape[0], P + 8)
    got, _ = port.decode_step(params, cache, full["tokens"][:, S:S + 1], P)
    return want.numpy(), got.numpy()


@pytest.mark.parametrize("name", ALL)
def test_decode_after_prefill_continues_the_prefill(name):
    """tests/test_archs.py:152-189 on every architecture, with prompts past
    the reduced windows; Whisper after a 16-token decoder prompt.  A MoE
    model drops a prompt token whose expert is over capacity in prefill
    but not in a one-token decode step, in both packages alike (jamba's
    reduced model here misses the MoE bar by 0.39 in the reference as in
    the port; the drops themselves are held to the reference in
    ``test_prefill_and_decode_match_the_reference`` and the layer tests).
    So the MoE models continue at a capacity factor that drops nothing,
    and are held to the MoE bar and to the dense one."""
    port, _, ref = _setup(name)
    if port.cfg.moe_experts:
        port = build_model(dataclasses.replace(port.cfg, capacity_factor=NO_DROP_CAPACITY))
    S = 16 if port.is_encdec else PROMPT
    want, got = _continuation(port, _torch(ref), _batch(port.cfg, 1, S + 1), S)
    if port.cfg.moe_experts:
        assert np.argmax(got) == np.argmax(want)
        assert np.abs(got - want).max() < MOE_CONTINUATION_MAX_ABS
    np.testing.assert_allclose(got, want, rtol=CONTINUATION_TOL, atol=CONTINUATION_TOL)


def test_whisper_prefill_keeps_the_decoder_prompt_cache():
    """The reference's ``encdec.prefill`` returns only the cross cache, so
    its decode after a 16-token decoder prompt attends to zeros where the
    prompt's keys belong and misses the continuation bar; the port's
    prefill returns the prompt's self cache and meets it
    (``test_decode_after_prefill_continues_the_prefill[whisper-large-v3]``)."""
    _, jm, ref = _setup("whisper-large-v3")
    S = 16
    batch = _batch(jm.cfg, 1, S + 1)
    jprefill, jdecode = _jit_steps("whisper-large-v3")
    want, _ = jprefill(ref, batch)
    _, jcache = jprefill(ref, {**batch, "tokens": batch["tokens"][:, :S]})
    assert set(jcache) == {"cross"}
    cache = _unflat(_jax_grow(jm, jax.device_get(jcache), 1, S + 8))
    got, _ = jdecode(ref, cache, batch["tokens"][:, S:S + 1], S)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err > CONTINUATION_TOL * (1 + float(np.abs(np.asarray(want)).max())), err


@pytest.mark.parametrize("name", ALL)
def test_generate_serves_every_architecture(name):
    """``serve.generate`` from the CLI's seeded batch (the frontend stubs'
    embeddings included): finite logits, tokens in the vocabulary, no
    kernel launch on the CPU, and the grown cache as ``cache_specs`` says
    but for the windowed layers' rings and Whisper's cross cache."""
    port, _, ref = _setup(name)
    cfg = port.cfg
    batch = serve.seeded_batch(cfg, 2, PROMPT, "cpu")
    assert ("prefix_embeds" in batch) == bool(cfg.frontend)
    res = serve.generate(port, _torch(ref), batch, 3)
    assert res.all_finite and tuple(res.tokens.shape) == (2, 3)
    assert bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all())
    assert res.kernel_launches == {"prefill": 0, "decode": 0}
    _, cache = port.prefill(_torch(ref), batch)
    P = serve.prompt_positions(port, batch)
    grown = flatten(serve.grow_cache(port, cache, 2, P + 11))
    specs = flatten(port.cache_specs(2, P + 11))
    for k, leaf in grown.items():
        if k.startswith("/cross"):
            assert leaf.shape[2] == serve.AUDIO_FRAMES
        else:
            assert tuple(leaf.shape) == specs[k][0] and leaf.dtype == specs[k][1], k


def test_grow_cache_keeps_rings_and_recurrent_state():
    """A windowed layer grows only to min(capacity, window): a prompt past
    the window keeps its ring as prefill laid it out, a shorter one is
    padded; recurrent state is kept as it is."""
    gemma = build_model(ARCHS["gemma3-27b"].reduced())
    w = gemma.cfg.window
    params = gemma.init(0, device="cpu")
    for P in (w + 16, w - 16):
        _, cache = gemma.prefill(params, {"tokens": torch.zeros(1, P, dtype=torch.long)})
        grown = serve.grow_cache(gemma, cache, 1, P + 8)
        local, glob = grown["stage0"]["b0"]["k"], grown["stage0"]["b5"]["k"]
        assert local.shape[2] == min(P + 8, w) and glob.shape[2] == P + 8
        assert torch.equal(local[:, :, :min(P, w)], cache["stage0"]["b0"]["k"])
        if P > w:                       # slot j holds the last token t = j (mod w)
            assert lm.ring_order(P, w, "cpu")[0].item() == (P - 1) // w * w
    xl = build_model(ARCHS["xlstm-125m"].reduced())
    _, cache = xl.prefill(xl.init(0, device="cpu"), {"tokens": torch.zeros(1, 8, dtype=torch.long)})
    grown = serve.grow_cache(xl, cache, 1, 16)
    assert grown["stage0"]["b0"]["C"] is cache["stage0"]["b0"]["C"]
    assert float(cache["stage0"]["b0"]["m"].max()) > -1e29      # the stabiliser moved


@pytest.mark.parametrize("name", ALL)
def test_card_vs_cpu_check_holds_every_leaf(name):
    """The card-against-CPU check that ``chip_smoke.py`` and the ``gpu``
    tests run, here with the CPU on both sides: every cache leaf of prefill
    and decode is paired by name and compared (exactly equal), and no
    kernel launches on CPU tensors."""
    res = card_vs_cpu(name, device="cpu")
    assert res["ok"], res["failures"]
    assert res["launches"] == {"prefill": 0, "decode": 0}
    leaves = set(res["errors"])
    for what in ("prefill", "decode"):
        assert what in leaves and any(k.startswith(f"{what}/") for k in leaves)
    assert all(e["max_abs_err"] == 0.0 for e in res["errors"].values())
    assert ("argmax" in res["bar"]) == bool(ARCHS[name].moe_experts)
