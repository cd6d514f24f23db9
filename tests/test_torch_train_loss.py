"""The training loss of every registered architecture against the JAX
package: ``Model.loss`` and the gradient of every parameter leaf, against
``jax.value_and_grad`` of the reference's ``Model.loss`` (jitted, on the
CPU), as ``tests/test_archs.py:37`` ``test_smoke_train_step`` takes one.

Setup: the reduced configs in float32; the reference's ``Model.init``
weights carried across by ``params_from_numpy``, tamed
(``models/crosscheck.tame_grads``: attention ``wq``/``wk`` at a fan-in of
d_model, as the serving tests take them, and mLSTM queries scaled by 0.1);
the batch laid out as ``smoke_batch`` lays it out (``tests/test_archs.py:
22``: B 2, S 64, the vision stub's patches before the tokens, the audio
frames beside the decoder tokens), with tokens, labels and embeddings drawn
from a seed.  On the CPU the port's attention goes through
``flash_attention``'s autograd Function (its plain forward and
``attention_backward_plain``), so this also holds the kernel's gradient
path.

Tolerances: the loss rtol 1e-5; each gradient leaf norm-wise 1e-4
(``max|port - ref| <= 1e-4 * max|ref|``).  The remat policies (off,
``full``, ``save_moe``) must give identical losses and gradients."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models.api import build_model as jax_build_model
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_backward
from repro_torch.models.api import build_model
from repro_torch.models.crosscheck import flatten, tame, tame_grads
from repro_torch.models.params import map_tree, params_from_numpy

ALL = sorted(ARCHS)
LOSS_RTOL = 1e-5
NORMWISE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its tensors are small, and
    under ``pytest -n`` a worker whose threads wait at each op's barrier
    for cores the other workers hold runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(cfg, S: int = 64, B: int = 2, seed: int = 11) -> dict:
    """``smoke_batch``'s layout with seeded tokens, labels and embeddings."""
    rng = np.random.default_rng(seed)
    tok = lambda s: rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)  # noqa: E731
    emb = lambda n: rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)  # noqa: E731
    if cfg.enc_dec:
        return {"prefix_embeds": emb(S), "tokens": tok(S), "labels": tok(S)}
    if cfg.frontend == "vision_patches":
        return {"prefix_embeds": emb(cfg.n_patches), "tokens": tok(S - cfg.n_patches),
                "labels": tok(S - cfg.n_patches)}
    return {"tokens": tok(S), "labels": tok(S)}


@functools.cache
def _reference(name):
    """(JAX model, its jitted value-and-grad, the reference's weights as
    numpy, untamed)."""
    jm = jax_build_model(JAX_ARCHS[name].reduced())
    weights = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    return jm, jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b))), weights


def _port_loss_and_grads(model, weights, batch, dtype=torch.float32):
    params = map_tree(lambda a: a.requires_grad_(True),
                      params_from_numpy(weights, "cpu", dtype))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = model.loss(params, tb)
    flat = flatten(params)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), dict(zip(flat, grads))


def _ref_loss_and_grads(name, weights, batch):
    _, vg, _ = _reference(name)
    loss, grads = vg(jax.tree.map(jnp.asarray, weights),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), {k: np.asarray(v) for k, v in flatten(jax.device_get(grads)).items()}


def _normwise(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    d = np.abs(a - b).max()
    return 0.0 if d == 0 else d / np.abs(b).max()


def _check(name, batch, weights):
    model = build_model(ARCHS[name].reduced())
    loss, grads = _port_loss_and_grads(model, weights, batch)
    ref_loss, ref_grads = _ref_loss_and_grads(name, weights, batch)
    assert np.isfinite(float(loss)) and loss.shape == ()
    np.testing.assert_allclose(float(loss), ref_loss, rtol=LOSS_RTOL)
    assert grads.keys() == ref_grads.keys()
    errs = {k: _normwise(g, ref_grads[k]) for k, g in grads.items()}
    bad = {k: e for k, e in errs.items() if not e <= NORMWISE}
    assert not bad, f"{name}: gradient leaves off the reference: {bad}"
    return grads


@pytest.mark.parametrize("name", ALL)
def test_loss_and_every_gradient_match_the_reference(name):
    _, _, weights = _reference(name)
    cfg = ARCHS[name].reduced()
    grads = _check(name, _batch(cfg), tame_grads(weights))
    assert sum(float(g.square().sum()) for g in grads.values()) > 0


@pytest.mark.parametrize("name,S", [("granite-3-2b", 90), ("llava-next-34b", 90),
                                    ("whisper-large-v3", 90)])
def test_tail_chunk(name, S):
    """S not a multiple of ``loss_chunk`` (64): the decoder-only loss sums
    the tail chunk; the encoder-decoder's, like the reference's
    (``src/repro/models/encdec.py:88``), sums whole chunks only and divides
    by every position."""
    _, _, weights = _reference(name)
    cfg = ARCHS[name].reduced()
    batch = _batch(cfg, S=S)
    assert batch["labels"].shape[1] % cfg.loss_chunk
    _check(name, batch, tame_grads(weights))


def test_encdec_loss_leaves_the_tail_out_as_the_reference_does():
    """A label past the last whole chunk does not move the
    encoder-decoder's loss, in either package; the decoder-only loss it
    does."""
    for name, moves in (("whisper-large-v3", False), ("granite-3-2b", True)):
        _, _, weights = _reference(name)
        cfg = ARCHS[name].reduced()
        model = build_model(cfg)
        params = params_from_numpy(tame(weights), "cpu", torch.float32)
        batch = _batch(cfg, S=70)
        other = dict(batch, labels=batch["labels"].copy())
        other["labels"][:, -1] = (other["labels"][:, -1] + 1) % cfg.vocab
        losses = [float(model.loss(params, {k: torch.from_numpy(v) for k, v in b.items()}))
                  for b in (batch, other)]
        ref = [_ref_loss_and_grads(name, tame(weights), b)[0] for b in (batch, other)]
        assert (losses[0] != losses[1]) == moves and (ref[0] != ref[1]) == moves


@pytest.mark.parametrize("name", ["granite-3-2b", "mixtral-8x22b", "whisper-large-v3"])
def test_remat_policies_give_identical_numbers(name):
    """Remat off, ``full`` (every layer under ``torch.utils.checkpoint``)
    and ``save_moe`` (the MoE outputs kept) give the same loss and
    gradients to the bit, and each recomputes every attention forward in
    the backward."""
    _, _, weights = _reference(name)
    base = ARCHS[name].reduced()
    batch = _batch(base)
    runs = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "save_moe")):
        model = build_model(dataclasses.replace(base, remat=remat, remat_policy=policy))
        n0 = flash_attention.launches, flash_attention_backward.launches
        runs[(remat, policy)] = _port_loss_and_grads(model, tame_grads(weights), batch)
        assert (flash_attention.launches, flash_attention_backward.launches) == n0  # CPU
    (loss0, g0), *rest = runs.values()
    for loss, g in rest:
        assert torch.equal(loss, loss0)
        assert all(torch.equal(g[k], g0[k]) for k in g0)


def test_remat_recomputes_every_layer(monkeypatch):
    """Under remat each layer's forward runs once more in the backward (the
    attention twice a layer).  ``save_moe`` tags each MoE output in the
    forward only: its value is kept, so the recompute stops before the tag
    (the layer's last op); no tag runs under the other policies."""
    from repro_torch.models import layers as L
    base = ARCHS["mixtral-8x22b"].reduced()
    _, _, weights = _reference("mixtral-8x22b")
    batch = _batch(base)
    calls = {"attend": 0, "moe_out": 0}
    attend, moe_out = L.attend, L.moe_out

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(L, "attend", count("attend", attend))
    monkeypatch.setattr(L, "moe_out", count("moe_out", moe_out))
    layers = base.n_layers
    for remat, policy, runs, tags in ((False, "full", 1, 0), (True, "full", 2, 0),
                                      (True, "save_moe", 2, 1)):
        calls.update(attend=0, moe_out=0)
        model = build_model(dataclasses.replace(base, remat=remat, remat_policy=policy))
        _port_loss_and_grads(model, tame_grads(weights), batch)
        assert calls == {"attend": runs * layers, "moe_out": tags * layers}, (remat, policy)


def test_xlstm_untamed_gradients_are_float32_noise_at_the_bar():
    """Why parity runs on ``tame_grads``' weights for the mLSTM: at the
    reference's initialiser both packages' float32 gradients of reduced
    xlstm stand about 1e-4 norm-wise from the port's float64 gradient, the
    reference's no closer than the port's; the two float32 gradients agree
    to 1e-3.  On the tamed weights both stand within 2e-5 of float64."""
    name = "xlstm-125m"
    _, _, weights = _reference(name)
    cfg = ARCHS[name].reduced()
    model = build_model(cfg)
    batch = _batch(cfg)
    for w, spread in ((tame(weights), (5e-5, 1e-3)), (tame_grads(weights), (0.0, 2e-5))):
        _, g64 = _port_loss_and_grads(model, w, batch, torch.float64)
        _, g32 = _port_loss_and_grads(model, w, batch)
        _, ref = _ref_loss_and_grads(name, w, batch)
        ref_err = max(_normwise(ref[k], g64[k]) for k in g64)
        port_err = max(_normwise(g32[k], g64[k]) for k in g64)
        lo, hi = spread
        assert lo <= ref_err <= hi and port_err <= hi, (ref_err, port_err)
        assert max(_normwise(g32[k], ref[k]) for k in g64) <= 1e-3


def test_remat_only_where_a_gradient_is_wanted(monkeypatch):
    """Serving a remat config (grad enabled, nothing requiring it) and a
    loss under ``no_grad`` run each layer as it is; a loss whose weights
    require grad checkpoints every layer."""
    from repro_torch.models import lm
    calls = []
    checkpoint = lm.checkpoint

    def counted(*a, **k):
        calls.append(1)
        return checkpoint(*a, **k)
    monkeypatch.setattr(lm, "checkpoint", counted)
    cfg = dataclasses.replace(ARCHS["granite-3-2b"].reduced(), remat=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    model.prefill(params, {"tokens": batch["tokens"]})
    with torch.no_grad():
        model.loss(params, batch)
    assert calls == []
    model.loss(map_tree(lambda t: t.requires_grad_(True), params), batch).backward()
    assert len(calls) == cfg.n_layers
