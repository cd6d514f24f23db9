"""The port's dry-run layer: ``launch.roofline`` against the reference's
(``collective_bytes`` on HLO text exactly; the roofline terms after
scaling by the ratio of the two packages' constants), K4's operator under
fake tensors and autograd (``repro_torch::flash_attention``: the kernel's
shapes and dtypes; on CPU tensors the same numbers as
``attention_backward_plain``), its DTensor sharding rule at granite's
32/8 heads on a 16-wide axis (KV gathered, never a local q-head shard
beside whole KV), and one full-width production cell (granite-3-2b
``train_4k`` on the (16, 16) mesh).  The cells that need a fake process
group run in a child process, so the pytest worker keeps no group; the
reduced zoo's cells are in ``tests/test_torch_dryrun_zoo.py``."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import roofline as JRL
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import (attention_backward_plain,
                                                     attention_lse_plain, attention_plain)
from repro_torch.launch import roofline as RL

ROOT = pathlib.Path(__file__).resolve().parents[1]

HLO_SAMPLES = {
    "start-done pair": (
        "%ag = bf16[16,4096,2048]{2,1,0} all-gather-start(bf16[1,4096,2048] %p), dims={0}\n"
        "%agd = bf16[16,4096,2048]{2,1,0} all-gather-done(bf16[16,4096,2048] %ag)\n"),
    "tuple result": (
        "%ar = (f32[1024]{0}, bf16[8,128]{1,0}) all-reduce(f32[1024] %a, bf16[8,128] %b), "
        "to_apply=%add\n"),
    "each kind": (
        "%a = f32[8,8]{1,0} all-gather(f32[1,8] %x)\n"
        "%b = f32[64]{0} all-reduce(f32[64] %y), to_apply=%sum\n"
        "%c = bf16[4,16]{1,0} reduce-scatter(bf16[64,16] %z), dimensions={0}\n"
        "%d = s32[32]{0} all-to-all(s32[32] %w), dimensions={0}\n"
        "%e = f8e4m3fn[2,3]{1,0} collective-permute(f8e4m3fn[2,3] %v), pairs={{0,1}}\n"
        "%f = pred[7]{0} all-reduce-start(pred[7] %u)\n"
        "%g = pred[7]{0} all-reduce-done(pred[7] %f)\n"),
    "none": "%m = f32[8,8]{1,0} dot(f32[8,8] %a, f32[8,8] %b)\n",
}


@pytest.mark.parametrize("name", sorted(HLO_SAMPLES))
def test_collective_bytes_equal_reference(name):
    text = HLO_SAMPLES[name]
    assert RL.collective_bytes(text) == JRL.collective_bytes(text)


ROOF_CASES = [(2.4e16, 1.8e12, 1.2e11, 256), (1e12, 5e14, 1e6, 512), (3e15, 1e9, 4e12, 8),
              (0.0, 0.0, 0.0, 4)]


@pytest.mark.parametrize("flops,hbm,coll,chips", ROOF_CASES)
def test_roofline_equals_reference_after_scaling(flops, hbm, coll, chips):
    """Each term is the reference's times the ratio of its constant to the
    H100's; the dominant term and the fraction follow from the terms."""
    got = RL.roofline(flops, hbm, coll, chips)
    ref = JRL.roofline(flops, hbm, coll, chips)
    scale = {"compute_s": JRL.PEAK_FLOPS / RL.PEAK_FLOPS, "memory_s": JRL.HBM_BW / RL.HBM_BW,
             "collective_s": JRL.ICI_BW / RL.ICI_BW}
    for key, s in scale.items():
        assert got[key] == pytest.approx(ref[key] * s, rel=1e-12, abs=0.0)
    terms = {k: got[k] for k in scale}
    assert got["dominant"] == max(terms, key=terms.get).replace("_s", "")
    bound = max(terms.values())
    assert got["roofline_fraction"] == (got["compute_s"] / bound if bound > 0 else 0.0)
    assert RL.model_flops(7e9, 2e9, 1e6, "train") == JRL.model_flops(7e9, 2e9, 1e6, "train")
    assert RL.model_flops(7e9, 2e9, 1e6, "decode") == JRL.model_flops(7e9, 2e9, 1e6, "decode")


def test_h100_constants_are_the_data_sheets():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.ICI_BW) == (989e12, 3.35e12, 450e9)


K4_CASES = [  # B, Hq, Hk, S, D, causal, window, dtype
    (2, 4, 2, 24, 32, True, None, torch.float32),
    (1, 8, 2, 40, 64, True, 9, torch.float32),
    (2, 2, 2, 17, 128, False, None, torch.float32),
    (1, 4, 1, 33, 64, True, None, torch.bfloat16),
]


def _qkv(B, Hq, Hk, S, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    def mk(H):
        return torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32)).to(dtype)
    return mk(Hq), mk(Hk), mk(Hk)


@pytest.mark.parametrize("B,Hq,Hk,S,D,causal,window,dtype", K4_CASES)
def test_flash_operator_fake_shapes(B, Hq, Hk, S, D, causal, window, dtype):
    """Under fake tensors the operator and its backward give the kernels'
    shapes and dtypes: out like q, lse float32 ``[B, Hq, S]`` only when a
    gradient is wanted, dq, dk, dv like q, k, v."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    scale = D ** -0.5
    with FakeTensorMode():
        q, k, v = (torch.empty(B, H, S, D, dtype=dtype) for H in (Hq, Hk, Hk))
        out, lse = torch.ops.repro_torch.flash_attention(q, k, v, causal, window or 0, scale,
                                                         True)
        assert (out.shape, out.dtype) == (q.shape, dtype)
        assert (lse.shape, lse.dtype) == ((B, Hq, S), torch.float32)
        _, none = torch.ops.repro_torch.flash_attention(q, k, v, causal, window or 0, scale,
                                                        False)
        assert none.shape == (B, Hq, 0)
        dq, dk, dv = torch.ops.repro_torch.flash_attention_backward(
            q, k, v, out, out, lse, causal, window or 0, scale)
        assert [(t.shape, t.dtype) for t in (dq, dk, dv)] == \
            [(x.shape, dtype) for x in (q, k, v)]
        bad = torch.empty(B, 3, S, D, dtype=dtype)          # Hq % 3 != 0 in every case
        with pytest.raises(ValueError, match="multiple"):
            torch.ops.repro_torch.flash_attention(q, bad, bad, causal, window or 0, scale, False)


@pytest.mark.parametrize("B,Hq,Hk,S,D,causal,window,dtype", K4_CASES)
def test_flash_operator_autograd_equals_plain_backward(B, Hq, Hk, S, D, causal, window, dtype):
    """On CPU tensors the operator's forward is ``attention_plain`` and its
    autograd is ``attention_backward_plain`` at the saved lse, bit for bit;
    ``torch.library.opcheck`` finds its schema, fake implementation and
    autograd registration consistent."""
    kw = dict(causal=causal, window=window)
    q, k, v = (x.requires_grad_() for x in _qkv(B, Hq, Hk, S, D, dtype))
    do = _qkv(B, Hq, Hq, S, D, dtype, seed=1)[0]
    out = flash_attention(q, k, v, **kw)
    assert "repro_torch_flash_attention" in type(out.grad_fn).__name__
    assert torch.equal(out, attention_plain(q.detach(), k.detach(), v.detach(), **kw))
    grads = torch.autograd.grad(out, (q, k, v), do)
    lse = attention_lse_plain(q.detach(), k.detach(), **kw)
    plain = attention_backward_plain(q.detach(), k.detach(), v.detach(), out.detach(), do, lse,
                                     **kw)
    for got, want in zip(grads, plain):
        assert got.dtype == want.dtype and torch.equal(got, want)
    with torch.no_grad():        # no gradient wanted: no lse computed, no graph
        assert flash_attention(q, k, v, **kw).grad_fn is None
    torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                          (q.detach(), k.detach(), v.detach(), causal, window or 0, D ** -0.5,
                           True),
                          test_utils=("test_schema", "test_autograd_registration",
                                      "test_faketensor"))


def _child(job: str, out: str) -> None:
    """A job that needs a fake process group."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import dryrun as D

    res = {}
    if job == "k4_rule":
        seen = []
        orig = ops._check_inputs

        def spy(q, k, v, window):
            seen.append((tuple(q.shape), tuple(k.shape)))
            return orig(q, k, v, window)
        ops._check_inputs = spy
        with D.fake_world(16):
            mesh = init_device_mesh("cpu", (1, 16), mesh_dim_names=("data", "model"))
            for Hk in (8, 16):
                seen.clear()
                mode = FakeTensorMode()
                with mode:
                    def mk(H, place):
                        full = torch.empty(4, H, 256, 64, dtype=torch.bfloat16)
                        return D.distribute({"t": full}, {"t": ("b", "h", "s", None)},
                                            {"b": None, "h": place[0], "s": place[1], None: None},
                                            mesh)["t"].requires_grad_()
                    q = mk(32, ("model", None))          # heads over model (32 % 16 == 0)
                    k, v = (mk(Hk, ("model", None) if Hk == 16 else (None, "model"))
                            for _ in range(2))
                with mode, D._bookkeeping_unfaked(), \
                        D.RL.CollectiveRecorder() as rec:
                    o = flash_attention(q, k, v, causal=True)
                    o.sum().backward()
                res[Hk] = {"seen": seen[:], "counts": dict(rec.counts),
                           "out": [str(p) for p in o.placements],
                           "dk": [str(p) for p in k.grad.placements],
                           "out_shape": list(o.shape), "is_dtensor": isinstance(o, DTensor)}
        ops._check_inputs = orig
    elif job == "granite_full":
        with D.fake_world(256):
            rec = D.run_cell("granite-3-2b", "train_4k", "single", pathlib.Path(out).parent,
                             device="cpu")
        res = rec
    pathlib.Path(out).write_text(json.dumps(res, default=str))


def _run_child(job: str, tmp_path, timeout: float) -> dict:
    out = tmp_path / f"{job}.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, __file__, job, str(out)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


def test_k4_sharding_rule_gathers_kv_at_granite_heads(tmp_path):
    """granite's 32 query heads shard over a 16-wide axis, its 8 KV heads do
    not: the rule offers no heads strategy, so DTensor gathers (q's heads
    and KV's sequence) and the kernel sees whole heads, 32 over 8.  With
    16 KV heads both shard: 2 over 1 a rank, the grouping kept, and no
    collective in the forward."""
    res = _run_child("k4_rule", tmp_path, timeout=240)
    gqa, even = res["8"], res["16"]
    # every call the kernels' checks see (DTensor's propagation at whole
    # shapes, then each rank's shards) keeps the grouping Hq / Hk
    for r, ratio in ((gqa, 4), (even, 2)):
        assert r["seen"] and all(q[1] == ratio * k[1] for q, k in r["seen"]), r["seen"]
    assert all(q[1] == 32 and k[1] == 8 for q, k in gqa["seen"]), gqa["seen"]
    assert gqa["counts"].get("all-gather", 0) >= 3, gqa["counts"]
    assert gqa["out_shape"] == [4, 32, 256, 64] and gqa["is_dtensor"]
    assert [2, 1] in [[q[1], k[1]] for q, k in even["seen"]], even["seen"]
    assert even["out"][1] == even["dk"][1] == "S(1)", (even["out"], even["dk"])


def test_granite_production_cell_traces(tmp_path):
    """granite-3-2b ``train_4k`` at full width on the (16, 16) mesh, 256
    fake ranks: an ``ok`` record whose analytic fields are the
    reference's, with collectives traced and the argument bytes of one
    device's shards."""
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.launch import analytic as JAN
    from repro.models.api import build_model as jax_build_model
    rec = _run_child("granite_full", tmp_path, timeout=600)
    assert rec["status"] == "ok", rec.get("error")
    jcfg, cell = JAX_ARCHS["granite-3-2b"], JSHAPES["train_4k"]
    n = jax_build_model(jcfg).n_params
    assert rec["params_b"] == n / 1e9
    assert rec["hlo_flops"] == JAN.cell_flops(jcfg, cell)["total"]
    mem = JAN.cell_memory(jcfg, cell, n, 256, 16)
    assert rec["hbm_bytes"] == mem.traffic_bytes
    assert rec["est_peak_gb_per_device"] == mem.peak_bytes_per_device / 1e9
    coll = JAN.cell_collectives(jcfg, cell, n, {"data": 16, "model": 16})
    assert rec["collectives_analytic"] == coll
    assert rec["collectives_traced"]["counts"].get("all-gather", 0) > 0
    # one device's shards by the reference's rules: bf16 params, two float32
    # moments, the int32 tokens and labels over the 16 data ranks
    import jax
    import jax.sharding as js
    from repro.parallel import sharding as JS
    jmesh = js.Mesh(np.array([jax.devices()[0]] * 256).reshape(16, 16), ("data", "model"))
    jmodel = jax_build_model(jcfg)
    rules = JS.rules_for(jcfg, jmesh, "train", cell.seq_len, cell.global_batch, n_params=n)
    flat = jax.tree_util.tree_leaves(jax.tree.map(
        lambda axes, st: int(np.prod(st.shape)) // int(np.prod(
            [jmesh.shape[a] for e in JS.resolve(axes, st.shape, rules, jmesh) if e
             for a in ((e,) if isinstance(e, str) else e)] or [1])),
        jmodel.param_axes(), jmodel.param_structs(),
        is_leaf=lambda x: isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                                       for e in x)))
    want = sum(flat) * (2 + 4 + 4) + 2 * 4 * 256 * 4096 // 16 + 4     # + the int32 step
    assert rec["argument_gb_per_device"] == pytest.approx(want / 1e9, rel=1e-9)
    assert rec["mesh"] == [16, 16] and rec["chips"] == 256


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2])
