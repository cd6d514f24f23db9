"""The dry-run on every architecture: ``launch.dryrun.run_cell`` traces each
reduced config's train, prefill and decode step on a (4, 2) ``("data",
"model")`` mesh of 8 fake ranks (small cells: batch 8, 32 positions), and
each record is ``ok`` with collectives traced, its analytic fields equal to
``repro.launch.analytic``'s on the same config and cell.  jamba's and
xlstm's reduced stacks are cut to one period of their pattern (every mixer
kind kept), so the traces stay short.  One child process holds the fake
group and runs every cell; each (architecture, kind) is its own case."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH_NAMES = ["deepseek-v3-671b", "gemma3-27b", "granite-3-2b", "jamba-v0.1-52b",
              "llava-next-34b", "mistral-large-123b", "mistral-nemo-12b", "mixtral-8x22b",
              "whisper-large-v3", "xlstm-125m"]
ONE_PERIOD = {"jamba-v0.1-52b": 8, "xlstm-125m": 6}
KINDS = ("train", "prefill", "decode")
B, S = 8, 32


def small(cfg):
    cfg = cfg.reduced()
    return dataclasses.replace(cfg, n_layers=ONE_PERIOD.get(cfg.name.removesuffix("-smoke"),
                                                            cfg.n_layers))


def _child(out: str) -> None:
    from repro_torch.configs.base import ShapeCell
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh
    recs = {}
    with D.fake_world(8):
        mesh = make_debug_mesh(8, 2, device_type="cpu")
        for arch in ARCH_NAMES:
            for kind in KINDS:
                rec = D.run_cell(arch, ShapeCell(kind, S, B, kind), "debug",
                                 pathlib.Path(out).parent / "cells" / kind, device="cpu",
                                 mesh=mesh, cfg_override=small(ARCHS[arch]))
                recs[f"{arch}/{kind}"] = rec
    pathlib.Path(out).write_text(json.dumps(recs, default=str))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_zoo") / "records.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_reduced_cell_traces_with_reference_analytics(records, arch, kind):
    from repro.configs.base import ShapeCell as JShapeCell
    from repro.configs.registry import ARCHS as JAX_ARCHS
    from repro.launch import analytic as JAN
    from repro.launch import roofline as JRL
    from repro.models.api import build_model as jax_build_model
    rec = records[f"{arch}/{kind}"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == [4, 2] and rec["chips"] == 8
    assert sum(rec["collectives_traced"]["counts"].values()) > 0
    assert rec["argument_gb_per_device"] > 0 and rec["temp_gb_per_device"] >= 0
    jcfg, cell = small(JAX_ARCHS[arch]), JShapeCell(kind, S, B, kind)
    n = jax_build_model(jcfg).n_params
    assert rec["params_b"] == n / 1e9
    fl = JAN.cell_flops(jcfg, cell)
    mem = JAN.cell_memory(jcfg, cell, n, 8, 4)
    coll = JAN.cell_collectives(jcfg, cell, n, {"data": 4, "model": 2})
    assert rec["hlo_flops"] == fl["total"]
    assert rec["hbm_bytes"] == mem.traffic_bytes
    assert rec["est_peak_gb_per_device"] == mem.peak_bytes_per_device / 1e9
    assert rec["fits_80gb_hbm"] == (mem.peak_bytes_per_device < 80e9)
    assert rec["collectives_analytic"] == coll
    assert rec["collective_bytes_per_chip"] == coll["total"]
    ref = JRL.roofline(fl["total"], mem.traffic_bytes, coll["total"], 8)
    assert rec["compute_s"] == pytest.approx(ref["compute_s"] * JRL.PEAK_FLOPS / 989e12,
                                             rel=1e-12)


if __name__ == "__main__":
    _child(sys.argv[1])
