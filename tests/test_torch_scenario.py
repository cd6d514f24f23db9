"""The PyTorch port's data layer against the JAX package: topologies and
ECMP routes, training programs, FluidScenario arrays, scenario JSON and
results.  Same inputs through both packages; everything here is exact."""
import dataclasses

import jax  # noqa: F401  (both frameworks in one process; data crosses as numpy)
import numpy as np
import pytest
import torch  # noqa: F401

from repro.api.results import RunResult as RefRunResult
from repro.api.scenario import Scenario as RefScenario
from repro.api.scenario import training_scenario as ref_training_scenario
from repro.net import topology as ref_topology
from repro.net.chaos import ChaosPlan as RefChaosPlan
from repro.net.fluid_jax import FluidScenario as RefFluidScenario
from repro_torch.api import RunResult, Scenario, training_scenario
from repro_torch.net import topology
from repro_torch.net.chaos import ChaosPlan
from repro_torch.net.fluid import FluidScenario
from test_api import wave_scenario

MICE = {"kind": "mice", "seed": 7, "rate": 2000.0, "size": 4e4,
        "duration": 0.004}
TOPOLOGIES = [("fat_tree", {"k": 4}),
              ("roft", {"n_servers": 4, "gpus_per_server": 8, "leaf_radix": 2,
                        "n_spines": 4}),
              ("clos", {"n_hosts": 16, "leaf_down": 4, "n_spines": 2})]


def _port(ref_scn) -> Scenario:
    return Scenario.from_dict(ref_scn.to_dict())


@pytest.mark.parametrize("kind,params", TOPOLOGIES)
def test_topology_and_routes_match_reference(kind, params):
    ref = ref_topology.TOPOLOGY_BUILDERS[kind](**params)
    port = topology.TOPOLOGY_BUILDERS[kind](**params)
    assert (port.name, port.n_hosts, port.n_nodes, port.meta) == \
        (ref.name, ref.n_hosts, ref.n_nodes, ref.meta)
    for field in ("link_src", "link_dst", "link_bw", "link_delay"):
        a, b = getattr(port, field), getattr(ref, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    hosts = range(ref.n_hosts)
    for fid, (s, d) in enumerate((s, d) for s in hosts for d in hosts):
        assert port.route(s, d, fid) == ref.route(s, d, fid), (s, d, fid)


SCENARIOS = {
    "gpt@32": lambda: ref_training_scenario(n_gpus=32),
    "moe@32": lambda: ref_training_scenario(n_gpus=32, moe=True),
    "gpt@128": lambda: ref_training_scenario(n_gpus=128),
    "tree": lambda: ref_training_scenario(n_gpus=32, collective="tree"),
    "halving_doubling": lambda: ref_training_scenario(
        n_gpus=64, collective="halving_doubling"),
    "hierarchical": lambda: ref_training_scenario(n_gpus=64, collective="hierarchical"),
    "chaos": lambda: ref_training_scenario(n_gpus=32, moe=True, chaos=[
        MICE, {"kind": "straggler", "seed": 3, "count": 2, "factor": 1.5},
        {"kind": "straggler", "ranks": [5], "factor": 2.0}]),
    "flows+mice": lambda: wave_scenario().variant(name="mice", chaos=[MICE]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_build_phases_match_reference(name):
    ref_scn = SCENARIOS[name]()
    ref = ref_scn.build_phases()
    port = _port(ref_scn).build_phases()
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert (p.name, p.deps, p.compute) == (r.name, r.deps, r.compute)
        assert [dataclasses.asdict(f) for f in p.flows] == \
            [dataclasses.asdict(f) for f in r.flows]


@pytest.mark.parametrize("name", ["gpt@32", "moe@32", "flows+mice"])
def test_fluid_scenario_arrays_bit_equal(name):
    ref_scn = SCENARIOS[name]()
    ref_topo, port_topo = ref_scn.build_topology(), _port(ref_scn).build_topology()
    for ph in ref_scn.build_phases():
        if not ph.flows:
            continue
        flows = [(f.fid, f.src, f.dst, f.size) for f in ph.flows]
        r = RefFluidScenario.from_flows(ref_topo, flows)
        p = FluidScenario.from_flows(port_topo, flows)
        for field in dataclasses.fields(RefFluidScenario):
            a, b = getattr(p, field.name), getattr(r, field.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), field.name
            else:
                assert a == b, field.name


def _interchange_cases():
    return [wave_scenario(),
            wave_scenario().variant(name="mice", chaos=[MICE], sim={"mtu": 1500}),
            ref_training_scenario(n_gpus=64, moe=True, cca="dctcp", scale=1.0),
            ref_training_scenario(n_gpus=32, straggler=(3, 1.5), collective="tree",
                                  num_microbatches=3, chaos=[MICE])]


@pytest.mark.parametrize("i", range(4))
def test_scenario_json_interchanges_both_ways(i):
    ref = _interchange_cases()[i]
    port = Scenario.from_json(ref.to_json())
    assert port.to_dict() == ref.to_dict()
    assert port.to_json(sort_keys=True) == ref.to_json(sort_keys=True)
    back = RefScenario.from_dict(port.to_dict())
    assert back.to_dict() == port.to_dict()
    assert port.kind == ref.kind and port.name == ref.name


def test_variant_and_training_scenario_match_reference():
    ref = ref_training_scenario(n_gpus=32, moe=True, chaos=[MICE])
    port = training_scenario(n_gpus=32, moe=True, chaos=[MICE])
    assert port.to_dict() == ref.to_dict()
    kw = dict(name="v", cca="dctcp", size_scale=2.0, kernel={"theta": 0.1},
              num_microbatches=2)
    assert port.variant(**kw).to_dict() == ref.variant(**kw).to_dict()
    w = wave_scenario()
    assert _port(w).variant(size_scale=0.5).to_dict() == w.variant(size_scale=0.5).to_dict()
    with pytest.raises(ValueError, match="no workload overrides"):
        _port(w).variant(n_gpus=4)


def test_chaos_parse_validation_matches_reference():
    cases = [[{"seed": 1}], [{"kind": "meteor"}],
             [{"kind": "mice", "seed": 0, "rate": 100.0}], [{**MICE, "bogus": 1}],
             [{**MICE, "rate": 0.0}], [{"kind": "straggler", "factor": 1.5}],
             [{"kind": "degrade_link", "link": 1, "t": 0.1, "factor": 1.5}],
             [{"kind": "degrade_link", "link": 1, "t": 0.2, "factor": 0.5, "t_end": 0.1}],
             [{"kind": "link_flap", "link": 1, "t_down": 0.2, "t_up": 0.1}]]
    for chaos in cases:
        with pytest.raises(ValueError) as ref_err:
            RefChaosPlan.parse(chaos)
        with pytest.raises(ValueError) as port_err:
            ChaosPlan.parse(chaos)
        assert str(port_err.value) == str(ref_err.value)
    good = [MICE, {"kind": "straggler", "seed": 0, "count": 3, "factor": 1.2},
            {"kind": "link_flap", "link": 3, "t_down": 0.004, "t_up": 0.006}]
    rp, pp = RefChaosPlan.parse(good), ChaosPlan.parse(good)
    assert pp.straggler_map(64) == rp.straggler_map(64)
    assert [(e.t, e.link, e.factor) for e in pp.link_events] == \
        [(e.t, e.link, e.factor) for e in rp.link_events]


def test_run_result_roundtrip_and_errors_match_reference():
    d = dict(backend="fluid", scenario="s", fcts={0: 1e-3, 1: 2e-3, 5: 0.0},
             flow_bytes={0: 1e6, 1: 2e6, 5: 1.0}, tags={0: "a", 1: "b", 5: "c"},
             iteration_time=2e-3, events_processed=200, wall_time=0.5,
             extras={"rates": {0: 1.5e9}, "t": (1, 2)})
    port, ref = RunResult(**d), RefRunResult(**d)
    assert port.to_dict() == ref.to_dict()
    assert RunResult.from_dict(port.to_dict()).to_dict() == port.to_dict()
    other = dict(d, fcts={0: 1.1e-3, 1: 1.8e-3})
    np.testing.assert_array_equal(RunResult(**other).fct_errors_vs(port),
                                  RefRunResult(**other).fct_errors_vs(ref))
