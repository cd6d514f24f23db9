"""``workload.build_ms_per_iter``, the metric that reads the program's
``workload.build`` spans (``repro_torch.obs``), reported by a traced run of
the tiny fluid cell on the CPU, and left out of an untraced one.

The tiny cells and their copy of the benchmark come from
``test_simbench_harness``'s ``tiny_root``; this module's copy also lists
the tiny fluid cell under the metric's ``workloads``."""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from simbench.harness import _reader
from simbench.tests.test_simbench_harness import (  # noqa: F401  (tiny_root: a fixture)
    BENCH, TINY_FLUID, _run, tiny_root)

METRIC = "workload.build_ms_per_iter"


@pytest.fixture(scope="module")
def build_root(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] == METRIC:
            m["workloads"].append(TINY_FLUID)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_root


def test_a_traced_run_reads_the_builds(build_root, capsys):
    from repro_torch import obs
    obs.reset()
    rc, out, _ = _run(build_root, TINY_FLUID, 1, capsys)
    assert rc == 0 and out["correct"] is True
    assert out["metrics"][METRIC]["unit"] == "ms"
    assert 0 < out["metrics"][METRIC]["value"] < 1e3


def test_an_untraced_run_reports_no_build_time(build_root, capsys):
    rc, out, _ = _run(build_root, TINY_FLUID, 0, capsys)
    assert rc == 0 and out["correct"] is True
    assert METRIC not in out["metrics"]


def test_the_reader_divides_the_spans_by_the_iterations(monkeypatch):
    from repro_torch import obs
    read = _reader(BENCH / "metrics" / f"{METRIC}.py")
    ctx = SimpleNamespace(iterations=[object()] * 4)
    monkeypatch.setattr(obs, "table", lambda: {})
    assert read(ctx) is None
    monkeypatch.setattr(obs, "table", lambda: {
        ("workload.build", None): {"calls": 4, "total_ns": 6_000_000, "self_ns": 6_000_000},
        ("workload.build", "outer"): {"calls": 4, "total_ns": 2_000_000, "self_ns": 0},
        ("workload.flows", None): {"count": 10}})
    assert read(ctx) == pytest.approx(2.0)
    assert read(SimpleNamespace(iterations=[])) is None
