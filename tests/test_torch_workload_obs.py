"""The workload builder's span and counters (``repro_torch.obs``):
``workload.build`` around each build of a training program's phase DAG, in
every engine and every what-if, and the ``workload.flows`` and
``workload.a2a_flows`` counters of the flows it built.  Under a profiler
only; with none, the builder records nothing.

The file imports neither JAX nor the JAX package."""
import pytest
import torch

from repro_torch import obs
from repro_torch.api import FlowSpec, Scenario, TopologySpec, run, training_scenario

CPU = [torch.profiler.ProfilerActivity.CPU]


def _profiled(fn):
    obs.reset()
    with torch.profiler.profile(activities=CPU):
        out = fn()
    table = obs.table()
    obs.reset()
    return out, table


def _rows(table, name):
    return [row for (n, _), row in table.items() if n == name]


@pytest.mark.parametrize("calls", [1, 3])
def test_each_build_is_one_span(calls):
    scn = training_scenario(n_gpus=32, moe=True)
    _, table = _profiled(lambda: [scn.build_phases() for _ in range(calls)])
    assert table[("workload.build", None)]["calls"] == calls
    assert table[("workload.build", None)]["total_ns"] > 0
    flows = sum(len(ph.flows) for ph in scn.build_phases())
    assert table[("workload.flows", None)] == {"count": calls * flows}


def test_the_counters_read_the_1024_gpu_job():
    scn = training_scenario(n_gpus=1024, family="minimax-text-01", scale=1.0)
    phases, table = _profiled(scn.build_phases)
    assert table[("workload.build", None)]["calls"] == 1
    assert table[("workload.flows", None)] == {"count": 131072}
    assert table[("workload.a2a_flows", None)] == {"count": 114688}
    assert sum(len(ph.flows) for ph in phases) == 131072


@pytest.mark.parametrize("backend", ["fluid", "analytic", "packet"])
def test_every_engine_records_one_build_a_run(backend):
    scn = training_scenario(n_gpus=32, scale=1 / 1024, straggler=(3, 1.2))
    opts = {"device": "cpu"} if backend == "fluid" else {}
    _, table = _profiled(lambda: run(scn, backend=backend, **opts))
    assert sum(r["calls"] for r in _rows(table, "workload.build")) == 1
    assert table[("workload.a2a_flows", None)] == {"count": 0}


def test_a_flow_scenario_builds_no_workload():
    flows = [FlowSpec(i, i, 4 + i, size=1e6, cca="dctcp") for i in range(2)]
    scn = Scenario(name="two", flows=flows,
                   topology=TopologySpec("clos", {"n_hosts": 8, "leaf_down": 4, "n_spines": 2}))
    _, table = _profiled(scn.build_phases)
    assert not any(n.startswith("workload.") for n, _ in table)


def test_without_a_profiler_the_builder_records_nothing():
    obs.reset()
    assert not obs.recording()
    assert obs.span("workload.build") is obs.NOOP
    training_scenario(n_gpus=32, moe=True).build_phases()
    assert obs.table() == {}
