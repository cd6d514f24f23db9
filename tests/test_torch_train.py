"""The port's training substrate against the JAX package, on identical numpy
inputs: the token pipeline (bit-equal), AdamW and its schedule, gradient
compression, checkpoint files both ways, the fault manager, and the
training loop (``make_train_step`` over 3 steps, resume after an injected
failure, the loss falling).  Mirrors ``tests/test_runtime.py``.

Tolerances: pipeline batches, compressed gradients and checkpoint bytes
exact; AdamW parameters and moments within 1e-7 absolute (float32 state;
bf16 state equal after its rounding up to one bf16 step); compression
residuals 1e-6 absolute (XLA fuses ``gf - deq``); the training loop's
losses and gradient norms rtol 1e-5, and the parameters after 3 steps
norm-wise :data:`PARAM_NORMWISE` per leaf (Adam's first steps divide each
gradient entry by its own magnitude, so an entry whose gradient is at
float32 noise moves by up to the learning rate either way: at lr 1e-3 and
weights near 1 that is at most 2e-3)."""
import dataclasses
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeCell as JShapeCell
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.launch import analytic as JA
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.models.api import build_model as jax_build_model
from repro.parallel import compression as JCOMP
from repro.train import checkpoint as JC
from repro.train import fault as JF
from repro.train import optimizer as JO
from repro.train import train_loop as JT
from repro_torch.configs.base import SHAPES, ShapeCell
from repro_torch.configs.registry import ARCHS
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import NoCardError
from repro_torch.launch import analytic as A
from repro_torch.launch import train as train_cli
from repro_torch.models.api import build_model
from repro_torch.models.crosscheck import flatten, tame
from repro_torch.models.params import leaves, map_tree, params_from_numpy
from repro_torch.parallel.compression import (CompressionConfig, compress_decompress,
                                              init_residuals)
from repro_torch.train import checkpoint as C
from repro_torch.train import optimizer as O
from repro_torch.train.fault import FailureInjector, InjectedFailure
from repro_torch.train.train_loop import TrainConfig, make_train_step, train, value_and_grad

LOSS_RTOL = 1e-5
PARAM_NORMWISE = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: its tensors are small, and
    under ``pytest -n`` a worker whose threads wait at each op's barrier
    for cores the other workers hold runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(rng, dtype=np.float32):
    return {"a": rng.normal(size=(8, 16)).astype(dtype),
            "b": {"c": rng.normal(size=(5,)).astype(dtype), "d": rng.normal(size=(3, 4, 2))
                  .astype(dtype)}}


def _torch(tree, dtype=None):
    return map_tree(lambda a: torch.from_numpy(np.array(a)).to(dtype=dtype), tree)


def _jax(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _np(tree):
    return {k: np.asarray(v, np.float32) for k, v in flatten(jax.device_get(tree)).items()}


def _tnp(tree):
    return {k: v.detach().float().numpy() for k, v in flatten(tree).items()}


# --------------------------------------------------------------------- #
# data pipeline
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("vocab,seq,batch,seed", [(100, 16, 8, 3), (512, 64, 4, 5),
                                                  (49155, 33, 6, 0)])
def test_pipeline_batches_are_bit_equal(vocab, seq, batch, seed):
    a, b = TokenPipeline(vocab, seq, batch, seed), JaxPipeline(vocab, seq, batch, seed)
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
    assert a.state() == b.state()


def test_pipeline_deterministic_and_elastic():
    """``tests/test_runtime.py:66`` on the port, beside the reference's
    batches: two hosts make the global batch, skip-ahead resumes it."""
    a = TokenPipeline(vocab=100, seq_len=16, global_batch=8, seed=3)
    b1, b2 = a.next_batch(), a.next_batch()
    ref = JaxPipeline(vocab=100, seq_len=16, global_batch=8, seed=3)
    assert np.array_equal(ref.next_batch()["tokens"], b1["tokens"])
    h0 = TokenPipeline(vocab=100, seq_len=16, global_batch=8, seed=3, n_hosts=2, host_id=0)
    h1 = TokenPipeline(vocab=100, seq_len=16, global_batch=8, seed=3, n_hosts=2, host_id=1)
    merged = np.concatenate([h0.next_batch()["tokens"], h1.next_batch()["tokens"]])
    np.testing.assert_array_equal(merged, b1["tokens"])
    h0.restore({"step": 1, "seed": 3})
    np.testing.assert_array_equal(h0.next_batch()["tokens"], b2["tokens"][:4])
    e = TokenPipeline(vocab=100, seq_len=16, global_batch=8, seed=3)
    e.restore({"step": 1, "seed": 3}, n_hosts=4, host_id=3)
    np.testing.assert_array_equal(e.next_batch()["tokens"], b2["tokens"][6:])


# --------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_adamw_matches_the_reference_over_three_steps(state):
    rng = np.random.default_rng(1)
    kw = dict(lr=1e-2, warmup=2, total_steps=10, clip_norm=5.0)
    cfg = O.AdamWConfig(**kw, state_dtype=O.STATE_DTYPES[state])
    jcfg = JO.AdamWConfig(**kw, state_dtype={"float32": jnp.float32,
                                             "bfloat16": jnp.bfloat16}[state])
    params = _tree(rng)
    tp, jp = _torch(params), _jax(params)
    ts, js = O.init_state(tp, cfg), JO.init_state(jp, jcfg)
    assert ts["m"]["a"].dtype == cfg.state_dtype and ts["step"].dtype == torch.int32
    for _ in range(3):
        grads = jax.tree.map(lambda a: 3 * rng.normal(size=a.shape).astype(np.float32), params)
        tp, ts, tm = O.update(tp, _torch(grads), ts, cfg)
        jp, js, jm = JO.update(jp, _jax(grads), js, jcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])
    assert int(ts["step"]) == int(js["step"]) == 3
    for got, want in ((_tnp(tp), _np(jp)), (_tnp(ts["m"]), _np(js["m"])),
                      (_tnp(ts["v"]), _np(js["v"]))):
        for k in want:
            tol = 1e-7 if state == "float32" else 2 ** -8 * np.abs(want[k]).max()
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def test_adamw_bf16_params_round_as_the_reference():
    rng = np.random.default_rng(2)
    cfg, jcfg = O.AdamWConfig(lr=1e-2, warmup=0), JO.AdamWConfig(lr=1e-2, warmup=0)
    params = _tree(rng)
    tp, jp = _torch(params, torch.bfloat16), _jax(params, jnp.bfloat16)
    grads = _tree(rng)
    tp, _, _ = O.update(tp, _torch(grads, torch.bfloat16), O.init_state(tp, cfg), cfg)
    jp, _, _ = JO.update(jp, _jax(grads, jnp.bfloat16), JO.init_state(jp, jcfg), jcfg)
    assert tp["a"].dtype == torch.bfloat16
    for k, v in _np(jp).items():
        np.testing.assert_array_equal(_tnp(tp)[k], v)


def test_adamw_updates_stacked_leaves_a_slice_at_a_time(monkeypatch):
    """A leaf past ``UPDATE_CHUNK`` elements is updated in slices of its
    leading axis, to the same bits as whole."""
    rng = np.random.default_rng(5)
    params = {"stack": rng.normal(size=(40, 7, 9)).astype(np.float32),
              "flat": rng.normal(size=(1000,)).astype(np.float32)}
    cfg = O.AdamWConfig(lr=1e-2, warmup=0, state_dtype=torch.bfloat16)
    out = []
    for chunk in (O.UPDATE_CHUNK, 100):
        monkeypatch.setattr(O, "UPDATE_CHUNK", chunk)
        tp = _torch(params)
        state = O.init_state(tp, cfg)
        for _ in range(2):
            tp, state, _ = O.update(tp, _torch(params), state, cfg)
        out.append({**_tnp(tp), **{f"m{k}": v for k, v in _tnp(state["m"]).items()}})
    for k, v in out[0].items():
        np.testing.assert_array_equal(out[1][k], v, err_msg=k)


def test_schedule_values_match_the_reference():
    for warmup, total in ((100, 10_000), (0, 10), (5, 30), (10, 10)):
        cfg = O.AdamWConfig(lr=3e-3, warmup=warmup, total_steps=total)
        jcfg = JO.AdamWConfig(lr=3e-3, warmup=warmup, total_steps=total)
        for step in (0, 1, warmup, warmup + 1, total // 2, total, total + 7):
            got = O.schedule(cfg, torch.tensor(step, dtype=torch.int32))
            want = JO.schedule(jcfg, jnp.asarray(step, jnp.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


def test_adamw_matches_reference_numpy():
    """``tests/test_runtime.py:23`` on the port."""
    cfg = O.AdamWConfig(lr=1e-2, warmup=0, weight_decay=0.0, clip_norm=1e9, total_steps=10)
    params = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]])}
    g = np.array([[0.1, -0.2], [0.3, 0.4]], np.float32)
    before = params["w"].clone()
    p2, _, _ = O.update(params, {"w": torch.from_numpy(g)}, O.init_state(params, cfg), cfg)
    mhat, vhat = 0.1 * g / (1 - 0.9), 0.05 * g ** 2 / (1 - 0.95)
    lr = float(O.schedule(cfg, 1))
    ref = before.numpy() - lr * mhat / (np.sqrt(vhat) + cfg.eps)
    np.testing.assert_allclose(p2["w"].numpy(), ref, rtol=1e-5)


def test_adamw_clipping():
    """``tests/test_runtime.py:41`` on the port, beside the reference."""
    cfg = O.AdamWConfig(clip_norm=0.001, warmup=0)
    params = {"w": torch.ones(4)}
    p2, _, metrics = O.update(params, {"w": torch.full((4,), 100.0)},
                              O.init_state(params, cfg), cfg)
    assert float((p2["w"] - 1).abs().max()) < 0.01
    jp, _, jm = JO.update({"w": jnp.ones(4)}, {"w": jnp.full((4,), 100.0)},
                          JO.init_state({"w": jnp.ones(4)}, JO.AdamWConfig(clip_norm=0.001,
                                                                           warmup=0)),
                          JO.AdamWConfig(clip_norm=0.001, warmup=0))
    np.testing.assert_allclose(p2["w"].numpy(), np.asarray(jp["w"]), atol=1e-7)
    assert float(metrics["grad_norm"]) == float(jm["grad_norm"]) == 200.0


# --------------------------------------------------------------------- #
# gradient compression
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["int8", "topk"])
@pytest.mark.parametrize("ef", [True, False])
def test_compression_matches_the_reference(kind, ef):
    rng = np.random.default_rng(3)
    cfg, jcfg = CompressionConfig(kind, 0.25, ef), JCOMP.CompressionConfig(kind, 0.25, ef)
    grads = _tree(rng)
    grads["b"]["c"][:] = [1.0, -1.0, 1.0, 0.5, -0.5]     # ties at the top-k threshold
    r, jr = init_residuals(_torch(grads)), JCOMP.init_residuals(_jax(grads))
    for _ in range(5):
        sent, r = compress_decompress(_torch(grads), r, cfg)
        jsent, jr = JCOMP.compress_decompress(_jax(grads), jr, jcfg)
        for k, v in _np(jsent).items():
            np.testing.assert_array_equal(_tnp(sent)[k], v, err_msg=k)
        for k, v in _np(jr).items():
            np.testing.assert_allclose(_tnp(r)[k], v, rtol=0, atol=1e-6, err_msg=k)


def test_compression_keeps_the_gradient_dtype():
    g = {"w": torch.randn(64, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)}
    for kind in ("int8", "topk"):
        sent, r = compress_decompress(g, init_residuals(g), CompressionConfig(kind, 0.25))
        assert sent["w"].dtype == torch.bfloat16 and r["w"].dtype == torch.float32
    assert compress_decompress(g, None, CompressionConfig()) == (g, None)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_error_feedback_accumulates(kind):
    """``tests/test_runtime.py:130`` on the port."""
    cfg = CompressionConfig(kind=kind, topk_frac=0.25)
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(64,)).astype(np.float32))}
    r = init_residuals(g)
    total = torch.zeros(64)
    for _ in range(20):
        sent, r = compress_decompress(g, r, cfg)
        total = total + sent["w"]
    rel = float(torch.linalg.norm(total - 20 * g["w"]) / torch.linalg.norm(20 * g["w"]))
    assert rel < (0.15 if kind == "topk" else 0.05), rel


def test_compression_wire_ratio():
    for kind, frac in (("topk", 0.01), ("int8", 0.01), ("none", 0.5)):
        assert (CompressionConfig(kind, topk_frac=frac).wire_ratio()
                == JCOMP.CompressionConfig(kind, topk_frac=frac).wire_ratio())
    assert CompressionConfig("topk", topk_frac=0.01).wire_ratio() == pytest.approx(0.03)


# --------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------- #
def _state(dtype: str):
    """The same parameters and optimizer state for both packages."""
    rng = np.random.default_rng(4)
    params = {"a": np.arange(32, dtype=np.float32).reshape(8, 4) / 7,
              "b": {"c": rng.normal(size=(3,)).astype(np.float32)}}
    m = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    port = {"params": _torch(params, tdt), "opt": {"m": _torch(m, tdt), "v": _torch(m, tdt),
                                                   "step": torch.tensor(7, dtype=torch.int32)}}
    ref = {"params": _jax(params, jdt), "opt": {"m": _jax(m, jdt), "v": _jax(m, jdt),
                                                "step": jnp.asarray(7, jnp.int32)}}
    return port, ref


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_files_are_the_reference_files(tmp_path, dtype):
    """The same state, saved by each package in 4 shards: the same
    manifest and the same ``.npy`` members, byte for byte."""
    port, ref = _state(dtype)
    C.save(tmp_path / "port", 7, port["params"], port["opt"], {"data_step": 8}, n_shards=4)
    JC.save(tmp_path / "ref", 7, ref["params"], ref["opt"], {"data_step": 8}, n_shards=4)
    a, b = (tmp_path / d / "step_00000007" for d in ("port", "ref"))
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    assert ma == mb and ma["names"][0] == "['opt']['m']['a']" and "['opt']['step']" in ma["names"]
    for shard in range(4):
        assert _members(a / f"shard_{shard:04d}.npz") == _members(b / f"shard_{shard:04d}.npz")


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_restores_either_package_checkpoint(tmp_path, writer, dtype):
    port, ref = _state(dtype)
    if writer == "port":
        C.save(tmp_path, 7, port["params"], port["opt"], n_shards=4)
    else:
        JC.save(tmp_path, 7, ref["params"], ref["opt"], n_shards=4)
    assert C.latest_step(tmp_path) == 7
    tmpl = map_tree(torch.zeros_like, port)
    restored, manifest = C.restore(tmp_path, template=tmpl)
    assert manifest["step"] == 7
    for k, v in flatten(port).items():
        got = flatten(restored)[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k


def test_reference_restores_port_float32_and_fails_on_bf16_as_on_its_own(tmp_path):
    """The reference's ``restore`` reads the port's float32 checkpoint; a
    bf16 one it cannot cast back, exactly as it cannot cast its own."""
    port, ref = _state("float32")
    C.save(tmp_path / "f32", 7, port["params"], port["opt"], n_shards=4)
    restored, _ = JC.restore(tmp_path / "f32", template={"params": ref["params"],
                                                          "opt": ref["opt"]})
    for k, v in _np(restored).items():
        np.testing.assert_array_equal(v, _tnp(port)[k])
    port, ref = _state("bfloat16")
    C.save(tmp_path / "pbf", 7, port["params"], port["opt"])
    JC.save(tmp_path / "rbf", 7, ref["params"], ref["opt"])
    for d in ("pbf", "rbf"):
        with pytest.raises(ValueError):
            JC.restore(tmp_path / d, template={"params": ref["params"], "opt": ref["opt"]})


def test_checkpoint_roundtrip_and_reshard(tmp_path):
    """``tests/test_runtime.py:88`` on the port."""
    params = {"a": torch.arange(32, dtype=torch.float32).reshape(8, 4),
              "b": {"c": torch.ones(3)}}
    C.save(tmp_path, 7, params, n_shards=4)
    restored, manifest = C.restore(tmp_path, template={"params": params})
    assert torch.equal(restored["params"]["a"], params["a"])
    assert torch.equal(restored["params"]["b"]["c"], params["b"]["c"])
    assert manifest["step"] == 7 and manifest["n_shards"] == 4
    flat, _ = C.restore(tmp_path)
    assert sorted(flat) == ["['params']['a']", "['params']['b']['c']"]
    with pytest.raises(FileNotFoundError):
        C.restore(tmp_path / "none")


# --------------------------------------------------------------------- #
# fault manager
# --------------------------------------------------------------------- #
class _ScriptedClock:
    """A ``time`` module whose ``perf_counter`` makes each step take the
    scripted duration."""

    def __init__(self, durations):
        self.ticks = iter(np.cumsum([0.0] + [x for d in durations for x in (d, 0.0)]))

    def perf_counter(self):
        return float(next(self.ticks))


def test_fault_manager_matches_the_reference(tmp_path, monkeypatch):
    """Checkpoint cadence (never at step 0), keep-3 garbage collection and
    straggler detection on a scripted clock, for both packages."""
    from repro_torch.train import fault as F
    durations = [1.0] * 10 + [5.0, 1.0, 3.5, 1.0]
    params = {"w": np.ones(2, np.float32)}
    out = {}
    for pkg, mod, mk in (("port", F, _torch), ("ref", JF, _jax)):
        monkeypatch.setattr(mod, "time", _ScriptedClock(durations))
        fm = mod.FaultManager(str(tmp_path / pkg), ckpt_every=3)
        saved = []
        for step, _ in enumerate(durations):
            fm.step_started()
            fm.step_finished(step)
            saved.append(fm.maybe_save(step, mk(params), None, {"data_step": step + 1}))
        out[pkg] = (saved, fm.straggler_steps, fm.resume_info(),
                    sorted(p.name for p in (tmp_path / pkg).iterdir()))
    assert out["port"] == out["ref"]
    assert out["port"][1] == [10, 12] and out["port"][2] == 12
    assert out["port"][3] == ["step_00000006", "step_00000009", "step_00000012"]


def test_failure_injector_fires_once():
    for cls, exc in ((FailureInjector, InjectedFailure), (JF.FailureInjector, JF.InjectedFailure)):
        inj = cls(fail_at_step=2)
        inj.maybe_fail(1)
        with pytest.raises(exc):
            inj.maybe_fail(2)
        inj.maybe_fail(2)
        assert inj.fired


# --------------------------------------------------------------------- #
# training loop
# --------------------------------------------------------------------- #
def _granite():
    jm = jax_build_model(JAX_ARCHS["granite-3-2b"].reduced())
    weights = tame(jax.device_get(jm.init(jax.random.PRNGKey(0))))
    return build_model(ARCHS["granite-3-2b"].reduced()), jm, weights


@pytest.mark.parametrize("mb,compression", [(1, "none"), (2, "none"), (2, "int8")])
def test_train_step_matches_the_reference(mb, compression):
    """Three steps of each package's ``make_train_step`` from the same
    weights on the same batches: losses, gradient norms and parameters."""
    port, jm, weights = _granite()
    opt = dict(lr=1e-3, warmup=2, total_steps=10)
    tcfg = TrainConfig(microbatches=mb, opt=O.AdamWConfig(**opt),
                       compression=CompressionConfig(compression))
    jcfg = JT.TrainConfig(microbatches=mb, opt=JO.AdamWConfig(**opt),
                          compression=JCOMP.CompressionConfig(compression))
    step, jstep = make_train_step(port, tcfg), JT.make_train_step(jm, jcfg)
    tp = params_from_numpy(weights, "cpu", torch.float32)
    ts, jp = O.init_state(tp, tcfg.opt), _jax(weights)
    js = JO.init_state(jp, jcfg.opt)
    tr = init_residuals(tp) if compression != "none" else None
    jr = (JCOMP.init_residuals(jp) if compression != "none"
          else jax.tree.map(lambda p: jnp.zeros((1,), jnp.float32), jp))
    pipe = TokenPipeline(vocab=port.cfg.vocab, seq_len=32, global_batch=4, seed=9)
    for _ in range(3):
        batch = pipe.next_batch()
        tp, ts, tr, loss, gn = step(tp, ts, tr, {k: torch.from_numpy(v).long()
                                                 for k, v in batch.items()})
        jp, js, jr, jloss, jgn = jstep(jp, js, jr, _jax(batch))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=LOSS_RTOL)
    got = _tnp(tp)
    for k, v in _np(jp).items():
        err = np.abs(got[k] - v).max() / np.abs(v).max()
        assert err <= PARAM_NORMWISE, (k, err)


def test_a_step_leaves_the_callers_tensors_without_grad():
    """The gradient is taken through detached views of the leaves: the
    caller's tensors never come to require grad, so trained weights serve
    without autograd; the step then updates those same tensors in place."""
    cfg = ARCHS["granite-3-2b"].reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    before = [t.clone() for t in leaves(params)]
    batch = {k: torch.from_numpy(v).long() for k, v in TokenPipeline(
        vocab=cfg.vocab, seq_len=16, global_batch=2, seed=3).next_batch().items()}
    loss, grads = value_and_grad(model, params, batch)
    assert not loss.requires_grad and not any(g.requires_grad for g in leaves(grads))
    assert not any(t.requires_grad for t in leaves(params))
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), before))
    tcfg = TrainConfig(opt=O.AdamWConfig(lr=1e-3, warmup=1, total_steps=2))
    out, *_ = make_train_step(model, tcfg)(params, O.init_state(params, tcfg.opt), None, batch)
    assert all(a is b for a, b in zip(leaves(out), leaves(params)))
    assert not any(t.requires_grad for t in leaves(params))
    assert not all(torch.equal(a, b) for a, b in zip(leaves(params), before))


def _resume_run(pkg, tmp_path, weights, fail_at=None):
    port, jm, _ = _granite()
    kw = dict(steps=12, log_every=1000, ckpt_dir=str(tmp_path / pkg), ckpt_every=5)
    pipe = (TokenPipeline if pkg == "port" else JaxPipeline)(vocab=512, seq_len=32,
                                                             global_batch=4, seed=5)
    if pkg == "port":
        tcfg = TrainConfig(opt=O.AdamWConfig(lr=1e-3, warmup=2, total_steps=12), **kw)
        return train(port, pipe, tcfg, params=params_from_numpy(weights, "cpu", torch.float32),
                     injector=FailureInjector(fail_at) if fail_at else None,
                     device="cpu"), pipe
    tcfg = JT.TrainConfig(opt=JO.AdamWConfig(lr=1e-3, warmup=2, total_steps=12), **kw)
    return JT.train(jm, pipe, tcfg, params=_jax(weights),
                    injector=JF.FailureInjector(fail_at) if fail_at else None), pipe


def test_failure_injection_and_resume_shift_as_the_reference(tmp_path):
    """``tests/test_runtime.py:102`` on both packages from the same weights:
    a failure at step 8, then a restart from the step-5 checkpoint.  The
    resumed run repeats step 5 on batch 6 (the checkpoint's ``data_step``),
    so it takes 7 steps and ends one batch later than an uninterrupted run;
    its losses equal the reference's resumed losses."""
    _, _, weights = _granite()
    out = {}
    for pkg in ("port", "ref"):
        exc = InjectedFailure if pkg == "port" else JF.InjectedFailure
        with pytest.raises(exc):
            _resume_run(pkg, tmp_path, weights, fail_at=8)
        out[pkg] = _resume_run(pkg, tmp_path, weights)
    (res, pipe), (jres, jpipe) = out["port"], out["ref"]
    assert res["resumed_from"] == jres["resumed_from"] == 5
    assert len(res["losses"]) == len(jres["losses"]) == 12 - 5
    assert pipe.step == jpipe.step == 13                 # one batch past an uninterrupted run
    np.testing.assert_allclose(res["losses"], jres["losses"], rtol=1e-4)
    for k, v in _np(jres["params"]).items():
        assert np.abs(_tnp(res["params"])[k] - v).max() <= PARAM_NORMWISE * np.abs(v).max(), k


def test_training_reduces_loss():
    """``tests/test_runtime.py:51`` on the port, on the CPU."""
    cfg = ARCHS["granite-3-2b"].reduced()
    model = build_model(cfg)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=1)
    out = train(model, pipe, TrainConfig(steps=30, log_every=1000,
                                         opt=O.AdamWConfig(lr=3e-3, warmup=5, total_steps=30)),
                device="cpu")
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert last < first - 0.1, f"no learning: {first:.3f} -> {last:.3f}"
    assert out["device"] == "cpu" and len(out["step_seconds"]) == 30
    assert all(np.isfinite(out["grad_norms"])) and min(out["grad_norms"]) > 0


def test_train_wants_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(ARCHS["granite-3-2b"].reduced())
    pipe = TokenPipeline(vocab=512, seq_len=8, global_batch=2)
    with pytest.raises(NoCardError):
        train(model, pipe, TrainConfig(steps=1))
    with pytest.raises(ValueError):
        train(model, pipe, TrainConfig(steps=1), device="cpu",
              params=map_tree(lambda t: t.to("meta"), model.init(0, device="cpu")))
    assert train_cli.main(["--arch", "granite-3-2b", "--steps", "1"]) == 1


def test_cli_trains_on_the_cpu(capsys):
    assert train_cli.main(["--arch", "xlstm-125m", "--steps", "2", "--batch", "2",
                           "--seq", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "on cpu" in out and "final loss" in out


def test_train_config_fields_match_the_reference():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]  # noqa: E731
    assert names(TrainConfig) == names(JT.TrainConfig)
    assert names(O.AdamWConfig) == names(JO.AdamWConfig)
    assert names(CompressionConfig) == names(JCOMP.CompressionConfig)


# --------------------------------------------------------------------- #
# the analytic cost model (the train phase's MFU numerator)
# --------------------------------------------------------------------- #
def test_analytic_model_counts_as_the_reference():
    """``launch/analytic.py`` is a copy: every function gives the
    reference's numbers for every registered architecture and shape cell,
    ``chip_smoke.py``'s train cell (4 x 2048) among them."""
    cells = [*SHAPES.values(), ShapeCell("train", 2048, 4, "train")]
    jcells = [*JSHAPES.values(), JShapeCell("train", 2048, 4, "train")]
    for name in sorted(ARCHS):
        cfg, jcfg = ARCHS[name], JAX_ARCHS[name]
        n = build_model(cfg).n_params
        for cell, jcell in zip(cells, jcells):
            for remat in (None, False, True):
                assert A.cell_flops(cfg, cell, remat) == JA.cell_flops(jcfg, jcell, remat)
            assert (dataclasses.asdict(A.cell_memory(cfg, cell, n, 256, 32))
                    == dataclasses.asdict(JA.cell_memory(jcfg, jcell, n, 256, 32)))
            mesh = {"data": 16, "model": 16}
            assert (A.cell_collectives(cfg, cell, n, mesh)
                    == JA.cell_collectives(jcfg, jcell, n, mesh))
        assert A.forward_flops(cfg, 2, 64, 128) == JA.forward_flops(jcfg, 2, 64, 128)
