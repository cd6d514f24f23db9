"""The port's partition-sharded event loop (``repro_torch.net.sharded_sim``)
and its lane workers, on the CPU.

The load-bearing property, as in the reference: for any flow set the
sharded loop, with any ``intra_workers``, produces FCTs and event counts
identical to the single-heap serial loop.  The reference's own tests
(``tests/test_sharded.py``) are mirrored at the same sizes and run on both
packages (the ``pkg`` parameter), and the port's sharded loop is held to its
serial loop on the CI scenarios (``hybrid`` at ``fidelity="packet"``, the
sharded serial loop, is held to the reference there in
tests/test_torch_hybrid_packet.py).  Beside them: the
packet path (the exact solver, ``FlowTable``, the packet, sharded and
hybrid loops, the Wormhole kernel) imports no torch, and the spawned lane
workers import only ``repro_torch``."""
import json
import os
import pathlib
import random
import subprocess
import sys
import types

import pytest

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:                    # optional dep: deterministic fallback
    from hypcompat import given, settings, st

import repro.api as ref_api
import repro.core.wormhole as ref_wormhole
import repro.net.packet_sim as ref_packet_sim
import repro.net.sharded_sim as ref_sharded
import repro.net.soa as ref_soa
import repro.net.topology as ref_topology
import repro_torch.api as port_api
import repro_torch.core.wormhole as port_wormhole
import repro_torch.net.packet_sim as port_packet_sim
import repro_torch.net.sharded_sim as port_sharded
import repro_torch.net.soa as port_soa
import repro_torch.net.topology as port_topology
from test_torch_packet import CI_SCENARIOS, port_scenario

REPO = pathlib.Path(__file__).resolve().parents[1]


def _pkg(api, wormhole, packet_sim, sharded, topology):
    return types.SimpleNamespace(
        run=api.run, Scenario=api.Scenario, FlowSpec=api.FlowSpec,
        TopologySpec=api.TopologySpec, training_scenario=api.training_scenario,
        WormholeConfig=wormhole.WormholeConfig, WormholeKernel=wormhole.WormholeKernel,
        PacketSim=packet_sim.PacketSim, ShardedPacketSim=sharded.ShardedPacketSim,
        leaf_spine_clos=topology.leaf_spine_clos)


PKGS = {
    "reference": _pkg(ref_api, ref_wormhole, ref_packet_sim, ref_sharded, ref_topology),
    "port": _pkg(port_api, port_wormhole, port_packet_sim, port_sharded, port_topology),
}


@pytest.fixture(scope="module", params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


# --------------------------------------------------------------------- #
# mirrors of tests/test_sharded.py, on both packages
# --------------------------------------------------------------------- #
def _results(sim):
    return {fid: r.fct for fid, r in sim.results.items()}


def _run_pair(pkg, flows, kernel_cfg=None, validate=True):
    """(serial PacketSim, sharded ShardedPacketSim) over the same flows."""
    def build(cls, **kw):
        topo = pkg.leaf_spine_clos(16, leaf_down=4, n_spines=2)
        kernel = pkg.WormholeKernel(kernel_cfg) if kernel_cfg is not None else None
        sim = cls(topo, kernel=kernel, **kw)
        for fl in flows:
            sim.add_flow(fl)
        sim.run()
        assert sim.all_done()
        return sim

    return build(pkg.PacketSim), build(pkg.ShardedPacketSim, validate=validate)


def _random_flows(pkg, r, n):
    flows = []
    for fid in range(n):
        src = r.randrange(16)
        dst = r.randrange(16)
        if dst == src:
            dst = (dst + 1) % 16
        flows.append(pkg.FlowSpec(
            fid, src, dst, float(r.randrange(50_000, 600_000)),
            r.randrange(0, 20) * 1e-4,
            r.choice(["dctcp", "dcqcn", "timely", "hpcc"])))
    return flows


def _pair_in_both(r, n, wormhole: bool):
    """Each package's (serial, sharded) pair over the same random flows:
    sharded equals serial in each, and the port equals the reference."""
    seed = r.getrandbits(32)
    out = []
    for pkg in PKGS.values():
        cfg = pkg.WormholeConfig() if wormhole else None
        serial, sharded = _run_pair(pkg, _random_flows(pkg, random.Random(seed), n), cfg)
        assert _results(serial) == _results(sharded)
        assert serial.events_processed == sharded.events_processed
        out.append((_results(sharded), sharded.events_processed, sharded.shard_stats))
    assert out[0] == out[1]


@given(st.randoms(use_true_random=False), st.integers(2, 14))
@settings(max_examples=10, deadline=None)
def test_sharded_serial_loop_is_exact_on_random_flows(r, n):
    """Property, on both packages: lane-structured execution == single-heap
    execution, event for event, on arbitrary flow sets (packet backend)."""
    _pair_in_both(r, n, wormhole=False)


@given(st.randoms(use_true_random=False), st.integers(2, 10))
@settings(max_examples=6, deadline=None)
def test_sharded_exact_under_wormhole_kernel(r, n):
    """Property, on both packages: the Wormhole kernel's partition lifecycle
    drives lane merge/split and the sharded run stays identical to serial."""
    _pair_in_both(r, n, wormhole=True)


def test_lane_port_exclusivity_invariants(pkg):
    F = pkg.FlowSpec
    flows = [F(0, 0, 8, 4e6, 0.0, "dctcp"), F(1, 0, 9, 4e6, 5e-5, "dctcp"),
             F(2, 4, 5, 4e6, 0.0, "dctcp"), F(3, 12, 13, 2e6, 5e-4, "hpcc")]
    sim = pkg.ShardedPacketSim(pkg.leaf_spine_clos(16, leaf_down=4, n_spines=2),
                               validate=True)
    for fl in flows:
        sim.add_flow(fl)
    sim.run(until=2e-3)
    sim.check_invariants()
    assert sim.shard_stats["merges"] >= 1, "scenario must exercise a merge"
    sim.run()
    assert sim.all_done()
    sim.check_invariants()


def test_sharded_refuses_shared_buffer(pkg):
    with pytest.raises(ValueError, match="shared_buffer"):
        pkg.ShardedPacketSim(pkg.leaf_spine_clos(16, leaf_down=4, n_spines=2),
                             shared_buffer=3e5)


def _api_scenario(pkg, seed: int):
    flows = _random_flows(pkg, random.Random(seed), 10)
    return pkg.Scenario(f"sharded-eq-{seed}",
                        pkg.TopologySpec("clos", {"n_hosts": 16, "leaf_down": 4,
                                                  "n_spines": 2}), flows=flows)


@pytest.mark.parametrize("backend", ["packet", "wormhole"])
def test_intra_workers_identical_through_api(pkg, backend):
    scn = _api_scenario(pkg, 7)
    serial = pkg.run(scn, backend=backend)
    for iw in (1, 2, 4):
        par = pkg.run(scn, backend=backend, parallel="partitions", intra_workers=iw)
        assert par.fcts == serial.fcts, f"iw={iw} diverged"
        assert par.events_processed == serial.events_processed
        assert par.extras["shard"]["intra_workers"] == iw
        if iw > 1 and backend == "packet":
            assert par.extras["shard"]["dispatches"] > 0, \
                "parallel path never dispatched — test covers nothing"


def test_workload_driver_phases_identical_under_fanout(pkg):
    scn = pkg.training_scenario(n_gpus=16, cca="dctcp", scale=1 / 4096,
                                name="sharded-wl16")
    serial = pkg.run(scn, backend="wormhole")
    par = pkg.run(scn, backend="wormhole", parallel="partitions", intra_workers=2)
    assert par.fcts == serial.fcts
    assert par.events_processed == serial.events_processed
    assert par.iteration_time == serial.iteration_time


def test_quickstart_identical_under_fanout(pkg):
    from examples.quickstart import make_scenario
    scn = pkg.Scenario.from_dict(make_scenario().to_dict())
    serial = pkg.run(scn, backend="wormhole")
    par = pkg.run(scn, backend="wormhole", parallel="partitions", intra_workers=2)
    assert par.fcts == serial.fcts
    assert par.events_processed == serial.events_processed
    assert par.extras["shard"]["dispatches"] > 0


def test_64gpu_preset_identical_under_fanout(pkg):
    scn = pkg.training_scenario(n_gpus=64, cca="hpcc", scale=1 / 256)
    serial = pkg.run(scn, backend="wormhole")
    par = pkg.run(scn, backend="wormhole", parallel="partitions", intra_workers=2)
    assert par.fcts == serial.fcts
    assert par.events_processed == serial.events_processed
    assert par.extras["shard"]["dispatches"] > 0


@pytest.mark.parametrize("name", list(CI_SCENARIOS))
def test_sharded_packet_equal_to_serial_on_ci_scenarios(name):
    """``packet`` with ``parallel="partitions"`` at ``intra_workers`` 1 and 2
    equals the serial loop: FCTs, events, iteration time."""
    scn = port_scenario(CI_SCENARIOS[name]())
    serial = port_api.run(scn, backend="packet")
    for iw in (1, 2):
        par = port_api.run(scn, backend="packet", parallel="partitions", intra_workers=iw)
        assert par.fcts == serial.fcts
        assert par.events_processed == serial.events_processed
        assert par.iteration_time == serial.iteration_time
        assert par.extras["shard"]["intra_workers"] == iw
        assert (par.extras["shard"]["dispatches"] > 0) == (iw > 1)


# --------------------------------------------------------------------- #
# the lanes and the worker side against the reference
# --------------------------------------------------------------------- #
def test_lane_state_pop_run_equal_to_reference():
    """Same-timestamp runs pop in (t, seq) order, and a watermark leaves
    the events scheduled after it in the lane."""
    rng = random.Random(3)
    events = [(rng.choice([0.0, 1e-6, 2e-6]), rng.randrange(4), (i,)) for i in range(60)]
    for max_seq in (None, 20, 45):
        lanes = [port_soa.LaneState(5), ref_soa.LaneState(5)]
        runs = [[], []]
        for lane, out in zip(lanes, runs):
            for t, kind, payload in events:
                lane.push(t, kind, payload)
            out.append(lane.pop_run(max_seq))
            while lane.heap:
                out.append(lane.pop_run())
        assert runs[0] == runs[1] and len(runs[0]) >= 3
        assert sum(map(len, runs[0])) == len(events)
        assert lanes[0].seq == lanes[1].seq == len(events)


def test_shard_report_and_stats_equal_to_reference():
    """A sharded run with fan-out: the same shard report, stats and final
    per-flow state in both packages."""
    from examples.quickstart import make_scenario
    out = []
    for pkg in (PKGS["reference"], PKGS["port"]):
        scn = pkg.Scenario.from_dict(make_scenario().to_dict())
        r = pkg.run(scn, backend="packet", parallel="partitions", intra_workers=2,
                    validate=True)
        out.append((r.fcts, r.events_processed, r.extras["shard"]))
    assert out[0] == out[1]
    assert out[1][2]["dispatches"] > 0 and out[1][2]["intra_workers"] == 2


_NO_TORCH = """
import json, sys
import repro_torch.net.sharded_sim, repro_torch.net.hybrid_sim
import repro_torch.core.wormhole, repro_torch.net.soa
from repro_torch.kernels.maxmin import solve_paths
print(json.dumps({"torch": "torch" in sys.modules,
                  "foreign": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "repro"))}))
"""


def test_packet_path_imports_no_torch():
    """The packet path (the exact solver, the sharded and hybrid loops, the
    Wormhole kernel) loads in a fresh interpreter without torch, as the
    reference's keeps JAX out of its lane workers."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == {"torch": False, "foreign": []}


_WORKER_MODULES = ("sorted(m for m in __import__('sys').modules "
                   "if m.split('.')[0] in ('torch', 'jax', 'repro', 'repro_torch'))")


def test_lane_workers_import_only_the_port():
    """The spawned lane workers of a sharded run unpickle the port's lanes
    and hold no torch, no JAX and nothing of the reference."""
    from examples.quickstart import make_scenario
    scn = port_api.Scenario.from_dict(make_scenario().to_dict())
    r = port_api.run(scn, backend="packet", parallel="partitions", intra_workers=2)
    assert r.extras["shard"]["dispatches"] > 0
    pool = port_sharded._shared_pool(1)      # intra_workers - 1 workers
    seen = [pool.submit(eval, _WORKER_MODULES).result(timeout=120) for _ in range(4)]
    assert any("repro_torch.net.sharded_sim" in mods for mods in seen)
    for mods in seen:
        assert all(m.split(".")[0] == "repro_torch" for m in mods), mods
