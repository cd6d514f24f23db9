"""The xLSTM recurrences as operators (``repro_torch.models.recurrent``).

- ``torch.library.opcheck`` on ``mlstm_scan``, ``slstm_scan`` and
  ``slstm_scan_backward`` (schema, fake implementation, autograd
  registration).
- Each operator against the per-token loop that prefill ran before the
  operators existed, kept here as the oracle (``_loop_mlstm``,
  ``_loop_slstm``, ``_token_prefill``): bit-equal on the same inputs, and
  within 1e-6 for the layer's prefill, which now projects the whole
  sequence at once where the loop projected a token at a time.
- ``slstm_scan``'s gradients (backpropagation through time by hand) against
  autograd through the loop, and against ``jax.value_and_grad`` of the
  reference's ``slstm`` at the sLSTM's existing 1e-4.
- A reduced xlstm prefill under ``FakeTensorMode`` dispatches as many ops at
  S = 16 as at S = 64: the property that lets the dry-run trace a 32k
  prefill.
- Reduced xlstm's prefill sharded on a (2, 2) gloo mesh against one device
  (rtol 1e-5, or ten times what one float32 rounding of the weights moves
  it, as ``tests/test_torch_parallel.py`` holds its steps), and
  reduced xlstm, deepseek and whisper prefill and train cells traced ``ok``
  on a fake (2, 2, 2) ``("pod", "data", "model")`` mesh (in the style of
  ``tests/test_torch_dryrun_zoo.py``); each in a child process, the two
  side by side.

Run as a script (``python tests/test_torch_recurrent.py gloo|mesh3d OUT``)
this file is a child's program."""
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.models import recurrent  # noqa: F401  (registers the operators)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOOP_RTOL = 1e-6          # the layer's prefill against the per-token loop
GRAD_RTOL = 1e-5          # BPTT by hand against autograd through the loop, norm-wise
REF_NORMWISE = 1e-4       # the sLSTM sequence's bar against the reference
SHARDED_RTOL = 1e-5
# As in tests/test_torch_parallel.py, the sharded bar is widened to
# ROUNDING_FACTOR times what one float32 rounding of the weights moves the
# single-device prefill (seeded, relative 2**-24): a 12-layer xlstm on the
# reference's initialiser moves by ~3e-5 under it; a partial sum left
# unreduced moves it by order 1.
ROUNDING = 2.0 ** -24
ROUNDING_FACTOR = 10.0
WORLD = 4
MESH3D_CELLS = [(arch, kind) for arch in ("xlstm-125m", "deepseek-v3-671b", "whisper-large-v3")
                for kind in ("prefill", "train")]
ONE_PERIOD = {"xlstm-125m": 6}


def _rng():
    return np.random.default_rng(5)


def _normwise(a, b) -> float:
    a, b = (torch.as_tensor(np.array(t) if isinstance(t, np.ndarray) else t).double()
            for t in (a, b))
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _cfg(**over):
    from repro_torch.configs.registry import ARCHS
    return dataclasses.replace(ARCHS["xlstm-125m"].reduced(), **over)


def _params(kind: str, cfg, rng):
    from repro_torch.models import ssm as SSM
    specs = (SSM.mlstm_specs if kind == "mlstm" else SSM.slstm_specs)(cfg, 1)
    out = {}
    for name, spec in specs.items():
        shape = spec.shape[1:]
        if spec.init == "ones":
            out[name] = np.ones(shape, np.float32)
        else:
            fan_in = shape[-2] if len(shape) > 1 else shape[0]
            out[name] = (rng.normal(size=shape) * spec.scale / np.sqrt(fan_in)).astype(np.float32)
    return out


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


# --------------------------------------------------------------------- #
# the oracle: prefill's per-token loop before the operators
# --------------------------------------------------------------------- #
def _loop_mlstm(q, k, v, ig, fg, C, n, m):
    """The mLSTM's recurrence a token at a time, as its decode step ran it."""
    hs = []
    for t in range(q.shape[1]):
        logf = F.logsigmoid(fg[:, t])
        m_new = torch.maximum(logf + m, ig[:, t])
        fdec = torch.exp(logf + m - m_new)[..., None]
        iexp = torch.exp(ig[:, t] - m_new)[..., None]
        C = C * fdec[..., None] + iexp[..., None] * (k[:, t][..., :, None] * v[:, t][..., None, :])
        n = n * fdec + iexp * k[:, t]
        qf = q[:, t].float()
        num = torch.einsum("bhk,bhkv->bhv", qf, C)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n).abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, 1), C, n, m


def _loop_slstm(gates, r, c, n, h, m):
    """The sLSTM's step a token at a time, as its sequence form ran it."""
    B, S = gates.shape[:2]
    H, hd = r.shape[:2]
    hs = []
    for t in range(S):
        rec = torch.einsum("bhk,hkg->bhg", h.to(gates.dtype), r)
        g = gates[:, t].reshape(B, 4, H, hd).transpose(1, 2).reshape(B, H, 4 * hd) + rec
        zi, it, fi, oi = g.float().chunk(4, dim=-1)
        ft = F.logsigmoid(fi)
        m_new = torch.maximum(ft + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(ft + m - m_new)
        c = f_ * c + i_ * torch.tanh(zi)
        n = torch.maximum(f_ * n + i_, torch.exp(-m_new))
        h = torch.sigmoid(oi) * (c / n)
        m = m_new
        hs.append(h)
    return torch.stack(hs, 1), c, n, h, m


def _token_prefill(kind: str, x, p, cfg):
    """The layer's prefill as the whole decode step a token at a time: the
    norm, the projections, one step of the loop, the output."""
    from repro_torch.models import ssm as SSM
    from repro_torch.models.layers import rms_norm
    B, S, _ = x.shape
    di = cfg.expand * cfg.d_model
    state = (SSM.mlstm_state if kind == "mlstm" else SSM.slstm_state)(B, cfg, "cpu")
    st, ys = tuple(state.values()), []
    for t in range(S):
        xt = x[:, t:t + 1]
        h = rms_norm(xt, p["ln"])
        if kind == "mlstm":
            q, k, v, ig, fg, z = SSM.mlstm_qkv(h, p, cfg)
            hsa, *st = _loop_mlstm(q, k, v, ig, fg, *st)
            y = hsa.reshape(B, 1, di).to(x.dtype) * p["gn"] * F.silu(z)
        else:
            gates = torch.einsum("bsd,dg->bsg", h, p["w_in"])
            hs, *st = _loop_slstm(gates, p["r"], *st)
            y = hs.reshape(B, 1, di).to(x.dtype) * p["gn"]
        ys.append((xt + torch.einsum("bse,ed->bsd", y, p["down"]))[:, 0])
    return torch.stack(ys, 1), dict(zip(state, st))


def _mlstm_inputs(rng, B=2, S=24, H=4, hd=8, start=False):
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    state = ((torch.zeros(B, H, hd, hd), torch.zeros(B, H, hd), torch.full((B, H), -1e30))
             if start else (f(B, H, hd, hd), f(B, H, hd), f(B, H)))
    return (f(B, S, H, hd), f(B, S, H, hd) / hd ** 0.5, f(B, S, H, hd), f(B, S, H), f(B, S, H),
            *state)


def _slstm_inputs(rng, B=2, S=24, H=4, hd=8, start=False):
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    if start:
        state = (torch.zeros(B, H, hd), torch.zeros(B, H, hd), torch.zeros(B, H, hd),
                 torch.full((B, H, hd), -1e30))
    else:
        state = (f(B, H, hd), torch.from_numpy(rng.uniform(0.5, 2.0, (B, H, hd)).astype(
            np.float32)), f(B, H, hd), f(B, H, hd))
    return (f(B, S, 4 * H * hd), f(H, hd, 4 * hd) * 0.5 / hd ** 0.5, *state)


# --------------------------------------------------------------------- #
# the operators
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("start", [False, True])
def test_mlstm_scan_is_the_token_loop(start):
    args = _mlstm_inputs(_rng(), start=start)
    got = torch.ops.repro_torch.mlstm_scan(*args)
    want = _loop_mlstm(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("start", [False, True])
def test_slstm_scan_is_the_token_loop(start):
    args = _slstm_inputs(_rng(), start=start)
    got = torch.ops.repro_torch.slstm_scan(*args)
    want = _loop_slstm(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_prefill_matches_the_token_loop(kind):
    from repro_torch.models import ssm as SSM
    cfg, rng = _cfg(), _rng()
    p = _t(_params(kind, cfg, rng))
    x = torch.from_numpy(rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32))
    out, cache = (SSM.mlstm_prefill if kind == "mlstm" else SSM.slstm_prefill)(x, p, cfg)
    want, wcache = _token_prefill(kind, x, p, cfg)
    assert list(cache) == list(wcache)
    for got, ref in [(out, want), *((cache[k], wcache[k]) for k in wcache)]:
        torch.testing.assert_close(got, ref, rtol=LOOP_RTOL,
                                   atol=LOOP_RTOL * float(ref.abs().max()))


def test_slstm_training_form_is_the_token_loop():
    """``ssm.slstm`` (the training form) gives the loop's output bit for bit:
    its gates were always projected over the whole sequence."""
    from repro_torch.models import ssm as SSM
    from repro_torch.models.layers import rms_norm
    cfg, rng = _cfg(), _rng()
    p = _t(_params("slstm", cfg, rng))
    x = torch.from_numpy(rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32))
    gates = torch.einsum("bsd,dg->bsg", rms_norm(x, p["ln"]), p["w_in"])
    hs = _loop_slstm(gates, p["r"], *SSM.slstm_state(2, cfg, "cpu").values())[0]
    y = hs.flatten(-2).to(x.dtype) * p["gn"]
    assert torch.equal(SSM.slstm(x, p, cfg), x + torch.einsum("bse,ed->bsd", y, p["down"]))


@pytest.mark.parametrize("start", [False, True])
def test_slstm_scan_gradients_match_autograd_through_the_loop(start):
    """Every input's gradient, from cotangents on every output."""
    rng = _rng()
    args = [a.requires_grad_() for a in _slstm_inputs(rng, start=start)]
    outs = torch.ops.repro_torch.slstm_scan(*args)
    cot = [torch.from_numpy(rng.normal(size=o.shape).astype(np.float32)) for o in outs]
    got = torch.autograd.grad(outs, args, cot)
    want = torch.autograd.grad(_loop_slstm(*args), args, cot)
    names = ("gates", "r", "c", "n", "h", "m")
    errs = {n: _normwise(g, w) for n, g, w in zip(names, got, want) if w.abs().max() > 0}
    assert errs and max(errs.values()) <= GRAD_RTOL, errs


def test_slstm_gradients_match_the_reference():
    """``ssm.slstm``'s loss and the gradient of x and of every parameter
    against ``jax.value_and_grad`` of the reference's ``slstm``."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.models import ssm as JS
    from repro_torch.models import ssm as SSM
    cfg, rng = _cfg(), _rng()
    jcfg = JAX_ARCHS["xlstm-125m"].reduced()
    p = _params("slstm", cfg, rng)
    x = rng.normal(size=(2, 48, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)

    def ref_loss(x, p):
        return jnp.sum(JS.slstm(x, p, jcfg) * w)
    ref_val, (ref_gx, ref_gp) = jax.jit(jax.value_and_grad(ref_loss, argnums=(0, 1)))(x, p)
    tx, tp = torch.from_numpy(x).requires_grad_(), {k: v.requires_grad_() for k, v in
                                                    _t(p).items()}
    val = torch.sum(SSM.slstm(tx, tp, cfg) * torch.from_numpy(w))
    grads = torch.autograd.grad(val, [tx, *tp.values()])
    assert float(val.detach()) == pytest.approx(float(ref_val), rel=REF_NORMWISE)
    ref = [ref_gx] + [ref_gp[k] for k in tp]
    errs = {n: _normwise(g, np.asarray(r)) for n, g, r in zip(["x", *tp], grads, ref)}
    assert max(errs.values()) <= REF_NORMWISE, errs


@pytest.mark.parametrize("op", ["mlstm_scan", "slstm_scan", "slstm_scan_backward"])
def test_opcheck(op):
    rng = _rng()
    if op == "mlstm_scan":
        args = _mlstm_inputs(rng, S=5)
    elif op == "slstm_scan":
        args = [a.requires_grad_() for a in _slstm_inputs(rng, S=5)]
    else:
        fwd = _slstm_inputs(rng, S=5)
        outs = torch.ops.repro_torch.slstm_scan(*fwd)
        args = (*fwd, *(torch.from_numpy(rng.normal(size=o.shape).astype(np.float32))
                        for o in outs))
    torch.library.opcheck(getattr(torch.ops.repro_torch, op).default, args)


# --------------------------------------------------------------------- #
# tracing: one op a layer, whatever S
# --------------------------------------------------------------------- #
def _fake_prefill_ops(S: int) -> tuple[int, dict]:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.api import build_model
    from repro_torch.models.params import map_tree

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n, self.custom = 0, {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            if func.namespace == "repro_torch":
                self.custom[str(func)] = self.custom.get(str(func), 0) + 1
            return func(*args, **(kwargs or {}))
    model = build_model(_cfg(n_layers=6))
    with FakeTensorMode():
        params = map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype),
                          model.param_structs())
        batch = {"tokens": torch.zeros((2, S), dtype=torch.long)}
        with Count() as count:
            model.prefill(params, batch)
    return count.n, count.custom


def test_fake_prefill_dispatches_the_same_ops_at_any_length():
    n16, custom16 = _fake_prefill_ops(16)
    n64, custom64 = _fake_prefill_ops(64)
    assert n16 == n64, (n16, n64)
    # one period of xlstm's pattern: 5 mLSTM layers and 1 sLSTM layer
    assert custom16 == custom64 == {"repro_torch.mlstm_scan.default": 5,
                                    "repro_torch.slstm_scan.default": 1}


# --------------------------------------------------------------------- #
# on meshes, in child processes
# --------------------------------------------------------------------- #
def _gloo_rank(rank: int, port: int, out: str) -> None:
    """One of four ranks: reduced xlstm's prefill on one device, then with
    parameters and batch distributed on a (2, 2) ``("data", "model")`` mesh
    and the activation constraint installed."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import seeded_batch
    from repro_torch.models.api import build_model
    from repro_torch.models.crosscheck import flatten
    from repro_torch.models.params import map_tree
    from repro_torch.parallel import act_sharding
    from repro_torch.parallel import sharding as S

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        cfg = _cfg()
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        B, P = 4, 16
        batch = seeded_batch(cfg, B, P, "cpu")
        logits1, cache1 = model.prefill(params, batch)
        gen = torch.Generator().manual_seed(1)
        moved = map_tree(lambda t: t * (1 + ROUNDING * torch.randn(t.shape, generator=gen)),
                         params)
        logits0, cache0 = model.prefill(moved, batch)
        mesh = make_debug_mesh(WORLD, 2, device_type="cpu")
        rules = S.rules_for(cfg, mesh, "prefill", P, B, n_params=model.n_params)
        dparams = S.distribute(params, model.param_axes(), rules, mesh)
        dbatch = S.distribute(batch, S.batch_axes(batch), rules, mesh)
        spec = S.resolve(("act_batch", "act_seq", None), (B, P, cfg.d_model),
                         {**rules, "act_seq": "model"}, mesh)
        act_sharding.install(mesh, S.placements(spec, mesh))
        try:
            with implicit_replication():
                logits2, cache2 = model.prefill(dparams, dbatch)
        finally:
            act_sharding.clear()
        whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t  # noqa: E731
        errs = {"logits": _normwise(whole(logits2), logits1)}
        c1, c2 = flatten(cache1), flatten(cache2)
        errs.update({k: _normwise(whole(c2[k]), c1[k]) for k in c1})
        c0 = flatten(cache0)
        rounding = {"logits": _normwise(logits0, logits1),
                    **{k: _normwise(c0[k], c1[k]) for k in c1}}
        res = {"errs": errs, "rounding": rounding, "sharded_params": sum(
            any(p.is_shard() for p in t.placements) for t in flatten(dparams).values()),
            "logits_placements": str(getattr(logits2, "placements", None))}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        pathlib.Path(out).write_text(json.dumps(res))


def _gloo_main(out: str) -> None:
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_gloo_rank, args=(port, out), nprocs=WORLD)


def _mesh3d_main(out: str) -> None:
    """Each cell of :data:`MESH3D_CELLS` traced by ``launch.dryrun.run_cell``
    on a fake group of 8 ranks as a (2, 2, 2) mesh: batch 8, 32
    positions, xlstm cut to one period of its pattern."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeCell
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun as D
    recs = {}
    with D.fake_world(8):
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        for arch, kind in MESH3D_CELLS:
            cfg = ARCHS[arch].reduced()
            cfg = dataclasses.replace(cfg, n_layers=ONE_PERIOD.get(arch, cfg.n_layers))
            recs[f"{arch}/{kind}"] = D.run_cell(
                arch, ShapeCell(kind, 32, 8, kind), "debug", pathlib.Path(out).parent / kind,
                device="cpu", mesh=mesh, cfg_override=cfg)
    pathlib.Path(out).write_text(json.dumps(recs, default=str))


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Both children's results, the two run side by side."""
    tmp = tmp_path_factory.mktemp("recurrent")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen([sys.executable, __file__, name, str(tmp / f"{name}.json")],
                                    env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name in ("gloo", "mesh3d")}
    try:
        out = {}
        for name, proc in procs.items():
            log, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, log[-3000:]
            out[name] = json.loads((tmp / f"{name}.json").read_text())
        return out
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()


def test_sharded_prefill_matches_single_device(children):
    res = children["gloo"]
    assert res["sharded_params"] > 0
    bars = {k: max(SHARDED_RTOL, ROUNDING_FACTOR * r) for k, r in res["rounding"].items()}
    assert all(res["errs"][k] <= bars[k] for k in bars), (res["errs"], bars)
    assert len(res["errs"]) == 1 + 5 * 3 + 4      # logits; C, n, m of 5 mLSTM; c, n, h, m


@pytest.mark.parametrize("arch,kind", MESH3D_CELLS)
def test_cell_traces_on_a_3d_mesh(children, arch, kind):
    rec = children["mesh3d"][f"{arch}/{kind}"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == [2, 2, 2] and rec["chips"] == 8
    assert sum(rec["collectives_traced"]["counts"].values()) > 0
    assert rec["argument_gb_per_device"] > 0 and rec["temp_gb_per_device"] >= 0


if __name__ == "__main__":
    {"gloo": _gloo_main, "mesh3d": _mesh3d_main}[sys.argv[1]](sys.argv[2])
