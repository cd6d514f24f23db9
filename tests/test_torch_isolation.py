"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or anything of the JAX package ``repro``;
and its experiment layer (store, campaigns, service, CLI), like the
reference's, loads no torch, nor does a spawn worker of a host backend."""
import json
import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (the check runs in a fresh interpreter, not here)
import torch  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
BANNED_LINE = re.compile(
    r"^\s*(import\s+jax|from\s+jax|import\s+repro(\s|$|\.|,)|from\s+repro(\.|\s))")

PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.startswith("jax") or n == "repro" or n.startswith("repro."))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_port_modules_import_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.net.fluid" in out["modules"]
    assert "repro_torch.api.engines" in out["modules"]
    assert "repro_torch.api.analytic" in out["modules"]
    assert "repro_torch.kernels.maxmin.ops" in out["modules"]
    assert "repro_torch.kernels.flash_attention.ops" in out["modules"]
    assert "repro_torch.models.lm" in out["modules"]
    assert "repro_torch.launch.serve" in out["modules"]
    assert "repro_torch.net.packet_sim" in out["modules"]
    assert "repro_torch.core.wormhole" in out["modules"]
    assert "repro_torch.core.memo" in out["modules"]
    for name in ("net.sharded_sim", "net.hybrid_sim", "learned.dataset", "learned.model",
                 "learned.fit", "learned.engine", "api.store", "api.campaign",
                 "api.serve", "__main__", "workload.schedules.pipeline"):
        assert f"repro_torch.{name}" in out["modules"]
    assert out["bad"] == []


def test_no_source_line_imports_jax_or_reference():
    files = [REPO / "chip_smoke.py", *sorted((REPO / "src" / "repro_torch").rglob("*.py"))]
    offenders = [f"{p.relative_to(REPO)}:{i}: {line.strip()}"
                 for p in files
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if BANNED_LINE.match(line)]
    assert len(files) > 20
    assert offenders == []


TORCH_FREE_PROBE = """
import json, multiprocessing, sys
from concurrent.futures import ProcessPoolExecutor
import repro_torch.api.store, repro_torch.api.campaign, repro_torch.api.serve
import repro_torch.__main__
from repro_torch.api import training_scenario
from repro_torch.api.campaign import _worker_run
parent = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax"))
scn = training_scenario(n_gpus=32, scale=1 / 256).to_dict()
ctx = multiprocessing.get_context("spawn")
with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as pool:
    result, _, _ = pool.submit(_worker_run, scn, "analytic", None, {}).result()
    worker = pool.submit(eval, "sorted(m for m in __import__('sys').modules "
                               "if m.split('.')[0] in ('torch', 'jax', 'repro', 'repro_torch'))"
                         ).result()
print(json.dumps({"parent": parent, "worker": worker,
                  "iteration": result.iteration_time}))
"""


def test_experiment_layer_and_host_workers_load_no_torch():
    """``import repro_torch.api.{store,campaign,serve}`` and
    ``repro_torch.__main__`` load no torch (so ``ls``/``show``/``rm`` and the
    store server do not pay for it), and a campaign's spawn worker that
    has run an ``analytic`` scenario holds only ``repro_torch`` modules."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", TORCH_FREE_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["parent"] == []
    assert "repro_torch.api.campaign" in out["worker"]
    assert all(m.split(".")[0] == "repro_torch" for m in out["worker"]), out["worker"]
    assert out["iteration"] > 0
