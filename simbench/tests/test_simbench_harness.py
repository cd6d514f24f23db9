"""The harness on the CPU: every cell resolves by name, a cell and a metric
added as files run without an edit, the result line's shape, and the
comparison catching a broken timed path and the control.

The tiny cells below run the harness's whole path, the chip's look aside,
with the fluid backend on the CPU (``device="cpu"``), on gpt@32 as the
program resolves it (``test_simbench_reference.GPT32``)."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from simbench.checks import verify
from simbench.control import control_iteration
from simbench.harness import load_cell, main
from simbench.tests.test_simbench_reference import GPT32

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

TINY_FLUID, TINY_WORMHOLE = "tiny.fluid", "tiny.wormhole"
NEW_METRIC = "tiny.iterations"


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell, trace):
    c = load_cell(ROOT, cell, trace)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert c.config["name"] == entry["config"]
    assert set(c.mix["backends"]) <= {"fluid", "wormhole"}
    assert c.metrics and all(callable(c.readers[m["name"]]) for m in c.metrics)
    assert {"fluid_fct_gap", "fluid_iter_gap"} <= c.limits.keys()
    if "wormhole" in c.mix["backends"]:
        assert "wormhole_iter_gap" in c.limits
        assert c.config["guarantees"]["wormhole_fct_err_mean_pct"] == 1.0


def test_benchmark_json_keeps_the_contract():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["simbench"] and SPEC["command"][1] == "simbench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    configs = {c["name"] for c in SPEC["configs"]}
    assert configs == {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("simbench/") and (ROOT / c["file"]).exists()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["name"]) and NAME.match(w["traffic"])
        reported = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]
                    if w["name"] in m.get("workloads", CELLS)}
        assert "setup_s" in reported and len(reported & set(e2e)) >= 2
        assert reported - set(e2e)
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark's data with two cells, a mix each, their
    limits and one metric added as new files and entries."""
    root = tmp_path_factory.mktemp("bench")
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, root / "simbench" / sub)
    spec = json.loads(json.dumps(SPEC))
    tiny = {**GPT32, "message_bytes_scale": 1 / 1024}
    (root / "simbench" / "configs" / "tiny-gpt32.json").write_text(json.dumps(tiny))
    spec["configs"].append({"name": "gpt32-test", "source": "test", "reduced": [],
                            "file": "simbench/configs/tiny-gpt32.json", "why": "test"})
    mixes = {TINY_FLUID: {"backends": ["fluid"], "warm_db": False, "packet_checks": 0},
             TINY_WORMHOLE: {"backends": ["wormhole", "fluid"], "warm_db": False,
                             "packet_checks": 1}}
    for name, mix in mixes.items():
        (root / "simbench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
        (root / "simbench" / "limits" / f"{name}.json").write_text(
            (BENCH / "limits" / "gpt13b-128-s64.compare.json").read_text())
        spec["workloads"].append({"name": name, "config": "gpt32-test", "traffic": name,
                                  "chips": 1, "why": "test"})
    (root / "simbench" / "metrics" / f"{NEW_METRIC}.py").write_text(
        "def read(ctx):\n    return float(len(ctx.iterations))\n")
    spec["per_layer"].append({"name": NEW_METRIC, "unit": "count", "better": "higher",
                              "source": "host_clock", "layer": "test", "moves": "sim_iter_s",
                              "workloads": [TINY_FLUID, TINY_WORMHOLE]})
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(TINY_WORMHOLE)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(root, cell, trace, capsys, seed=4000000007, seconds=0.3, card=False):
    capsys.readouterr()
    rc = main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
               "--trace", str(trace)], root=root, check_chip=card,
              device="cuda" if card else "cpu")
    cap = capsys.readouterr()
    out = json.loads(cap.out.strip().splitlines()[-1]) if rc == 0 else None
    return rc, out, cap.err


@pytest.mark.parametrize("cell", [TINY_FLUID, TINY_WORMHOLE])
def test_added_cell_and_metric_run_without_edits(tiny_root, cell, capsys):
    rc, out, err = _run(tiny_root, cell, 1, capsys)
    assert rc == 0 and out["correct"] is True and out["failed"] == 0
    assert out["metrics"][NEW_METRIC]["value"] == out["attempted"] >= 1
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device",
                         "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= out["device"].keys()
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    lines = err.strip().splitlines()[-len(out["checks"]):]
    assert [ln.split(":")[0] for ln in lines] == [f"check {n}" for n in out["checks"]]


def test_trace0_prints_the_end_to_end_metrics_alone(tiny_root, capsys):
    rc, out, _ = _run(tiny_root, TINY_WORMHOLE, 0, capsys)
    assert rc == 0 and out["correct"] is True
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["metrics"]) == {"sim_iter_s", "setup_s", "fct_err_mean_pct"}
    assert out["metrics"]["fct_err_mean_pct"]["value"] > 0
    assert set(out["checks"]) == {"fluid_fct_gap", "fluid_iter_gap", "wormhole_fct_err_mean_pct",
                                  "wormhole_fct_err_max_pct", "wormhole_iter_gap",
                                  "flows_missing"}


def test_no_card_means_no_result(tiny_root, capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capsys.readouterr()
    rc = main(["--workload", TINY_FLUID, "--seed", "1", "--seconds", "0.1", "--trace", "0"],
              root=tiny_root)
    cap = capsys.readouterr()
    assert rc != 0 and cap.out == "" and "CUDA" in cap.err


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    code = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "from simbench.harness import main\n"
            f"rc = main(['--workload', {TINY_FLUID!r}, '--seed', '3', '--seconds', '0.1',"
            f" '--trace', '0'], root=__import__('pathlib').Path({str(tiny_root)!r}),"
            " check_chip=False, device='cpu')\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'repro'})\n"
            "print('LOADED', bad, rc)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert "LOADED [] 0" in res.stdout, res.stderr[-2000:]


def _scan_state_unchanged(monkeypatch):
    """The fluid scan's step returns its state unchanged: every rate stays
    at line rate, every queue empty."""
    import torch

    from repro_torch.net import fluid

    def scan(M, line, rtt0, size, bw, W, alpha, delivered, q, *, steps, window=None, **kw):
        hist = line.unsqueeze(-2).expand(*line.shape[:-1], steps, line.shape[-1]).clone()
        out = {"rates": line.clone(), "delivered": delivered.clone(), "queues": q.clone(),
               "rate_hist": hist, "queue_hist": torch.zeros(*bw.shape[:-1], steps, bw.shape[-1])}
        if window:
            out.update(win_mean=line.clone(), win_fluct=torch.zeros_like(line))
        return out
    monkeypatch.setattr(fluid, "fluid_scan", scan)


def _result_fault(monkeypatch, backend, fault):
    """Break what an engine produces: half its flows left out, or one
    answer altered where it is produced."""
    from repro_torch.api import engines
    cls = {"fluid": engines.FluidEngine, "wormhole": engines.WormholeEngine}[backend]
    orig = cls.run

    def run(self, scenario, **opts):
        res = orig(self, scenario, **opts)
        fids = sorted(res.fcts)
        if fault == "half":
            res.fcts = {f: res.fcts[f] for f in fids[::2]}
        else:
            res.fcts[fids[0]] *= 1.01 if backend == "fluid" else 1.10
        return res
    monkeypatch.setattr(cls, "run", run)


@pytest.mark.parametrize("cell, backend, fault", [
    (TINY_FLUID, "fluid", "unchanged"), (TINY_FLUID, "fluid", "half"),
    (TINY_FLUID, "fluid", "altered"), (TINY_WORMHOLE, "wormhole", "half"),
    (TINY_WORMHOLE, "wormhole", "altered"), (TINY_WORMHOLE, "fluid", "altered")])
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, backend, fault, capsys, monkeypatch):
    if fault == "unchanged":
        _scan_state_unchanged(monkeypatch)
    else:
        _result_fault(monkeypatch, backend, fault)
    rc, out, _ = _run(tiny_root, cell, 0, capsys)
    assert rc == 0 and out["correct"] is False


@pytest.mark.parametrize("cell", [TINY_FLUID, TINY_WORMHOLE])
def test_the_control_is_not_correct(tiny_root, cell):
    c = load_cell(tiny_root, cell, trace=False)
    for seed in (11, 12, 13):
        checks, _ = verify(c.config, c.mix, c.limits, [control_iteration(c, seed)], seed)
        assert checks["fluid_fct_gap"]["value"] > checks["fluid_fct_gap"]["limit"]
        if "wormhole" in c.mix["backends"]:
            assert checks["wormhole_fct_err_mean_pct"]["value"] > \
                checks["wormhole_fct_err_mean_pct"]["limit"]


@pytest.mark.gpu
def test_a_fluid_cell_is_correct_on_the_card(capsys):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rc, out, _ = _run(ROOT, "gpt13b-128.fluid", 0, capsys, seconds=1.0, card=True)
    assert rc == 0 and out["correct"] is True and out["device"]["platform"] == "gpu"
