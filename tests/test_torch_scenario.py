"""The PyTorch port's data layer against the JAX package: topologies and
ECMP routes, training programs, FluidScenario arrays, scenario JSON and
results.  Same inputs through both packages; everything here is exact."""
import dataclasses

import jax  # noqa: F401  (both frameworks in one process; data crosses as numpy)
import numpy as np
import pytest
import torch

from repro.api.results import RunResult as RefRunResult
from repro.api.scenario import Scenario as RefScenario
from repro.api.scenario import training_scenario as ref_training_scenario
from repro.net import topology as ref_topology
from repro.net.chaos import ChaosPlan as RefChaosPlan
from repro.net.fluid_jax import FluidScenario as RefFluidScenario
from repro_torch import obs
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
              ("clos", {"n_hosts": 16, "leaf_down": 4, "n_spines": 2}),
              ("roft", {"n_servers": 16, "gpus_per_server": 8, "leaf_radix": 32,
                        "n_spines": 8})]


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


@pytest.mark.parametrize("kind,params", TOPOLOGIES)
def test_routes_to_switches_match_reference(kind, params):
    """Toward a node of several neighbours (every switch) the port runs a
    BFS of its own; toward a host it reuses its switch's."""
    ref = ref_topology.TOPOLOGY_BUILDERS[kind](**params)
    port = topology.TOPOLOGY_BUILDERS[kind](**params)
    nodes = range(ref.n_nodes)
    pairs = [(s, d) for d in range(ref.n_hosts, ref.n_nodes) for s in nodes]
    for fid, (s, d) in enumerate(pairs):
        assert port.route(s, d, fid) == ref.route(s, d, fid), (s, d, fid)


# two hosts on a switch, and a fourth node on no cable
ISLET = dict(name="islet", n_hosts=2, n_nodes=4,
             link_src=np.array([0, 2, 1, 2], np.int32),
             link_dst=np.array([2, 0, 2, 1], np.int32),
             link_bw=np.full(4, 1e10), link_delay=np.full(4, 1e-6))


@pytest.mark.parametrize("src,dst", [(3, 0), (0, 3), (3, 1), (0, 2)])
def test_route_without_a_path_raises_as_the_reference(src, dst):
    """Two hosts on a switch and a fourth node on no cable: the routes
    that reach it, or leave it, raise in both packages."""
    ref, port = ref_topology.Topology(**ISLET), topology.Topology(**ISLET)
    if 3 in (src, dst):
        for topo in (ref, port):
            with pytest.raises(ValueError, match="no path"):
                topo.route(src, dst, 5)
    else:
        assert port.route(src, dst, 5) == ref.route(src, dst, 5)


# 2**62 is an int64 whose hash int64 does not hold (past about 9.2e12), and
# 2**64 + 3 no int64 at all: the array walk reduces such ids a hop at a time
PAST_INT64_HASH = (2**62, 2**64 + 3)


@pytest.mark.parametrize("fid0", [0, 7, 1_000_003, 2**40 + 1, *PAST_INT64_HASH])
@pytest.mark.parametrize("kind,params", TOPOLOGIES)
def test_routes_repeat_on_one_topology_and_on_a_fresh_one(kind, params, fid0):
    """A route taken again on the same topology, from its cached tables, is
    the first one, and a fresh topology (empty tables) takes it too."""
    build = topology.TOPOLOGY_BUILDERS[kind]
    topo = build(**params)
    hosts = range(topo.n_hosts)
    pairs = [(s, d, fid0 + i) for i, (s, d) in
             enumerate((s, d) for s in hosts for d in hosts if s != d)]
    first = [topo.route(s, d, fid) for s, d, fid in pairs]
    assert all(first)
    assert [topo.route(s, d, fid) for s, d, fid in pairs] == first
    fresh = build(**params)
    assert [fresh.route(s, d, fid) for s, d, fid in reversed(pairs)] == first[::-1]


def _routes_as_lists(topo, fid, src, dst):
    flat, hops = topo.routes(fid, src, dst)
    assert flat.dtype == hops.dtype == np.int64 and len(hops) == len(src)
    ends = np.cumsum(hops)
    return [flat[e - k:e].tolist() for e, k in zip(ends, hops)]


@pytest.mark.parametrize("fid0", [0, 7, 1_000_003, 2**40 + 1, *PAST_INT64_HASH])
@pytest.mark.parametrize("kind,params", TOPOLOGIES)
def test_array_routes_equal_route_and_the_reference(kind, params, fid0):
    """``Topology.routes`` on every host pair (a host to itself too) and
    every node toward every switch, at once: each flow's links are
    ``route``'s, on a fresh topology and in the JAX package."""
    ref = ref_topology.TOPOLOGY_BUILDERS[kind](**params)
    port = topology.TOPOLOGY_BUILDERS[kind](**params)
    hosts, nodes = range(ref.n_hosts), range(ref.n_nodes)
    pairs = [(s, d) for s in hosts for d in hosts] + \
        [(s, d) for d in range(ref.n_hosts, ref.n_nodes) for s in nodes]
    fids = [fid0 + i for i in range(len(pairs))]
    src, dst = (np.array(x, np.int64) for x in zip(*pairs))
    got = _routes_as_lists(port, fids if fid0 > 2**63 else np.array(fids, np.int64),
                           src, dst)
    fresh = topology.TOPOLOGY_BUILDERS[kind](**params)
    want = [ref.route(s, d, f) for f, (s, d) in zip(fids, pairs)]
    assert [fresh.route(s, d, f) for f, (s, d) in zip(fids, pairs)] == want
    assert got == want
    assert _routes_as_lists(port, fids, src, dst) == want       # the tables kept


def _builds(fn):
    """``fn()`` and the ``topology.dist_builds`` it counts, under a profiler."""
    obs.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    builds = sum(row.get("count", 0) for (n, _), row in obs.table().items()
                 if n == "topology.dist_builds")
    obs.reset()
    return out, builds


@pytest.mark.parametrize("routes_first", [False, True], ids=["route_first", "routes_first"])
@pytest.mark.parametrize("kind,params", TOPOLOGIES)
def test_route_and_routes_build_each_destination_once(kind, params, routes_first):
    """``route`` and ``routes`` walk one table: on a fresh topology each
    destination is counted once, by whichever asks for it first, and both
    give the reference's paths.  ``route`` takes the host pairs toward the
    first two thirds of the hosts, ``routes`` the pairs of any two nodes
    toward the nodes from the last two thirds of the hosts on, switches
    included."""
    ref = ref_topology.TOPOLOGY_BUILDERS[kind](**params)
    port = topology.TOPOLOGY_BUILDERS[kind](**params)
    h, n = ref.n_hosts, ref.n_nodes
    one = [(s, d, 3 * i) for i, (s, d) in
           enumerate((s, d) for d in range(2 * h // 3) for s in range(h))]
    many = [(s, d, 3 * i + 1) for i, (s, d) in
            enumerate((s, d) for d in range(h // 3, n) for s in range(n))]
    src, dst, fid = (np.array(x, np.int64) for x in zip(*many))
    calls = [lambda: [port.route(s, d, f) for s, d, f in one],
             lambda: _routes_as_lists(port, fid, src, dst)]
    asked = [{d for _, d, _ in one}, {d for _, d, _ in many}]
    if routes_first:
        calls, asked = calls[::-1], asked[::-1]
    (first, n_first), (second, n_second) = _builds(calls[0]), _builds(calls[1])
    assert n_first == len(asked[0]) and n_second == len(asked[1] - asked[0])
    assert n_first + n_second == n
    got = [first, second][::-1] if routes_first else [first, second]
    assert got[0] == [ref.route(s, d, f) for s, d, f in one]
    assert got[1] == [ref.route(s, d, f) for s, d, f in many]


def _twin_cables():
    """Four hosts, two to a leaf on two cables each, two spines: every leaf
    has two equal links into each of its hosts (none of the builders has)."""
    cables = [(h, 4 + h // 2) for h in range(4) for _ in range(2)] + \
        [(leaf, spine) for leaf in (4, 5) for spine in (6, 7)]
    src = [x for a, b in cables for x in (a, b)]
    dst = [x for a, b in cables for x in (b, a)]
    n = len(src)
    return dict(name="twin", n_hosts=4, n_nodes=8, link_src=np.array(src, np.int32),
                link_dst=np.array(dst, np.int32), link_bw=np.full(n, 1e10),
                link_delay=np.full(n, 1e-6))


@pytest.mark.parametrize("fid0", [0, 7, 1_000_003, 2**40 + 1])
def test_array_routes_over_parallel_cables_equal_the_reference(fid0):
    """The last hop into a host on two cables is the hash's choice too."""
    ref, port = ref_topology.Topology(**_twin_cables()), topology.Topology(**_twin_cables())
    pairs = [(s, d) for s in range(8) for d in range(8)]
    fid = fid0 + np.arange(len(pairs))
    src, dst = (np.array(x) for x in zip(*pairs))
    want = [ref.route(s, d, f) for f, (s, d) in zip(fid.tolist(), pairs)]
    assert len({p[-1] for (s, d), p in zip(pairs, want) if d == 0 and p}) == 2
    assert _routes_as_lists(port, fid, src, dst) == want


@pytest.mark.parametrize("pair", [(3, 0), (0, 3), (3, 1), (0, 2), (3, 3), (1, 1)])
def test_array_routes_without_a_path_raise_as_route(pair):
    """On the islet, a flow to or from the node on no cable raises ``route``'s
    error among routable flows; a node to itself has no hop, as in ``route``."""
    port, ref = topology.Topology(**ISLET), ref_topology.Topology(**ISLET)
    src, dst = np.array([0, pair[0], 1]), np.array([1, pair[1], 0])
    fid = np.array([5, 6, 7])
    if 3 in pair and pair[0] != pair[1]:
        with pytest.raises(ValueError, match=f"no path {pair[0]}->{pair[1]} in islet"):
            port.routes(fid, src, dst)
        with pytest.raises(ValueError, match="no path"):
            ref.route(pair[0], pair[1], 6)
    else:
        want = [ref.route(s, d, f) for f, s, d in zip(fid.tolist(), src, dst)]
        assert _routes_as_lists(port, fid, src, dst) == want
        if pair[0] == pair[1]:
            assert want[1] == []


@pytest.mark.parametrize("kind,params", TOPOLOGIES)
def test_array_routes_from_a_node_to_itself_have_no_hop(kind, params):
    """``src == dst`` gives a path of no link, between flows that have one,
    and the fluid scenario still refuses such a flow."""
    port = topology.TOPOLOGY_BUILDERS[kind](**params)
    n = port.n_nodes
    src = np.arange(n).repeat(2)
    dst = np.stack([np.arange(n), (np.arange(n) + 1) % n], 1).ravel()
    fid = np.arange(2 * n)
    flat, hops = port.routes(fid, src, dst)
    assert (hops[0::2] == 0).all() and (hops[1::2] > 0).all()
    assert _routes_as_lists(port, fid, src, dst) == \
        [port.route(int(s), int(d), int(f)) for f, s, d in zip(fid, src, dst)]
    with pytest.raises(ValueError, match="has no path"):
        FluidScenario.from_flows(port, [(0, 0, 1, 1e6), (1, 2, 2, 1e6)])


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
