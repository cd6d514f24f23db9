"""The metrics that read the program's own spans and counters
(``repro_torch.obs``), reported by a traced run of the tiny cells on the CPU.

The tiny cells and their copy of the benchmark come from
``test_simbench_harness``'s ``tiny_root``; this module's copy also lists the
tiny cells under the five metrics' ``workloads``, and the tiny wormhole cell
under ``packet.us_per_event``'s, the loop's clock from outside."""
from __future__ import annotations

import json

import pytest

from simbench.tests.test_simbench_harness import (  # noqa: F401  (tiny_root: a fixture)
    TINY_FLUID, TINY_WORMHOLE, _run, tiny_root)

PROGRAM_METRICS = {
    "fluid.route_ms_per_phase": [TINY_FLUID, TINY_WORMHOLE],
    "fluid.syncs_per_phase": [TINY_FLUID, TINY_WORMHOLE],
    "packet.loop_us_per_event": [TINY_WORMHOLE],
    "wormhole.callout_pct": [TINY_WORMHOLE],
    "memo.us_per_lookup": [TINY_WORMHOLE],
}


@pytest.fixture(scope="module")
def program_root(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] in PROGRAM_METRICS:
            m["workloads"] += PROGRAM_METRICS[m["name"]]
        elif m["name"] == "packet.us_per_event":
            m["workloads"].append(TINY_WORMHOLE)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    return tiny_root


@pytest.mark.parametrize("cell", [TINY_FLUID, TINY_WORMHOLE])
def test_a_traced_run_reads_the_programs_spans(program_root, cell, capsys):
    from repro_torch import obs
    obs.reset()
    rc, out, _ = _run(program_root, cell, 1, capsys)
    assert rc == 0 and out["correct"] is True
    got = out["metrics"]
    want = {m for m, cells in PROGRAM_METRICS.items() if cell in cells}
    assert want <= got.keys()
    assert all(got[m]["value"] > 0 for m in want - {"fluid.syncs_per_phase"})
    assert got["fluid.syncs_per_phase"]["value"] == 0          # no card, no sync
    if cell == TINY_WORMHOLE:
        assert got["wormhole.callout_pct"]["value"] < 100
        assert got["packet.loop_us_per_event"]["value"] <= got["packet.us_per_event"]["value"]


@pytest.mark.parametrize("cell", [TINY_FLUID, TINY_WORMHOLE])
def test_an_untraced_run_reports_no_program_metric(program_root, cell, capsys):
    rc, out, _ = _run(program_root, cell, 0, capsys)
    assert rc == 0 and out["correct"] is True
    assert not PROGRAM_METRICS.keys() & out["metrics"].keys()
