"""The port's ``hybrid`` backend (adaptive packet/flow granularity on the
partition-sharded loop) against the JAX package's, on the CPU.

Both packages run the same host-side event simulator in float64, and the
flow lane solves with the same exact float64 max-min solver, so the bar is
equality: the same FCTs, events, granularity and shard reports, compared
with ``==``, on the five scenarios of ``benchmarks/ci_regression.py`` at
``fidelity`` "auto" and "flow" ("packet" is in tests/test_torch_sharded.py),
and the 30 hybrid and 2 ``maxmin/*`` counters of that gate computed by both
packages.  The reference's own tests (``tests/test_hybrid.py`` and the
pipeline cases of ``tests/test_schedules.py``) are mirrored at the same
sizes and run on both packages (the ``pkg`` parameter)."""
import dataclasses
import os
import pathlib
import subprocess
import sys
import types

import pytest

import repro.api as ref_api
import repro.api.analytic as ref_analytic
import repro.api.engines as ref_engines
import repro.core.partition as ref_partition
import repro.kernels.maxmin as ref_maxmin
import repro.net.hybrid_sim as ref_hybrid
import repro.net.packet_sim as ref_packet_sim
import repro.workload.collectives as ref_collectives
import repro.workload.driver as ref_driver
import repro.net.topology as ref_topology
import repro.workload.schedules as ref_schedules
import repro_torch.api as port_api
import repro_torch.api.analytic as port_analytic
import repro_torch.api.engines as port_engines
import repro_torch.core.partition as port_partition
import repro_torch.kernels.maxmin as port_maxmin
import repro_torch.net.hybrid_sim as port_hybrid
import repro_torch.net.packet_sim as port_packet_sim
import repro_torch.workload.collectives as port_collectives
import repro_torch.workload.driver as port_driver
import repro_torch.net.topology as port_topology
import repro_torch.workload.schedules as port_schedules
from test_torch_packet import CI_SCENARIOS, assert_same_run, port_scenario
from test_torch_wormhole import ci_counters

REPO = pathlib.Path(__file__).resolve().parents[1]


def _pkg(api, analytic, partition, hybrid, packet_sim, collectives, driver, topology,
         schedules):
    def topology_for(n_gpus):
        # ``repro.workload.presets.topology_for``, which the port's presets
        # module does not carry
        return topology.rail_optimized_fat_tree(n_servers=max(2, n_gpus // 8),
                                                gpus_per_server=8, leaf_radix=32,
                                                n_spines=8, bw=12.5e9)

    return types.SimpleNamespace(
        run=api.run, run_many=api.run_many, Scenario=api.Scenario,
        FlowSpec=api.FlowSpec, TopologySpec=api.TopologySpec,
        training_scenario=api.training_scenario, maxmin_rates=analytic.maxmin_rates,
        PartitionIndex=partition.PartitionIndex, HybridConfig=hybrid.HybridConfig,
        PacketSim=packet_sim.PacketSim, FidAlloc=collectives.FidAlloc,
        WorkloadDriver=driver.WorkloadDriver, topology_for=topology_for,
        schedules=schedules)


PKGS = {
    "reference": _pkg(ref_api, ref_analytic, ref_partition, ref_hybrid, ref_packet_sim,
                      ref_collectives, ref_driver, ref_topology, ref_schedules),
    "port": _pkg(port_api, port_analytic, port_partition, port_hybrid, port_packet_sim,
                 port_collectives, port_driver, port_topology, port_schedules),
}


@pytest.fixture(scope="module", params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


# --------------------------------------------------------------------- #
# the hybrid backend, end to end, against the reference
# --------------------------------------------------------------------- #
def _ci_hybrid_runs(api, make, maxmin) -> tuple[dict, dict]:
    """The default (``auto``) hybrid runs of benchmarks/ci_regression.py's
    scenarios, in its order, and the solver counters it reads after the
    first three."""
    maxmin.reset_counters()
    runs, solver = {}, None
    for label, mk in CI_SCENARIOS.items():
        runs[label] = api.run(make(mk()), backend="hybrid")
        if label == "moe32":
            solver = dict(maxmin.SOLVER_COUNTERS)
    return runs, solver


@pytest.fixture(scope="module")
def ci_runs():
    return {"reference": _ci_hybrid_runs(ref_api, lambda s: s, ref_maxmin),
            "port": _ci_hybrid_runs(port_api, port_scenario, port_maxmin)}


@pytest.mark.parametrize("name", list(CI_SCENARIOS))
def test_hybrid_auto_run_equal_to_reference(name, ci_runs):
    """FCTs, events, the kernel report, granularity and shard reports."""
    port, ref = ci_runs["port"][0][name], ci_runs["reference"][0][name]
    assert_same_run(port, ref)
    assert port.extras["granularity"]["demotions"] > 0


@pytest.mark.parametrize("name", list(CI_SCENARIOS))
def test_hybrid_flow_run_equal_to_reference(name, ci_runs):
    ref_scn = CI_SCENARIOS[name]()
    ref = ref_api.run(ref_scn, backend="hybrid", fidelity="flow")
    port = port_api.run(port_scenario(ref_scn), backend="hybrid", fidelity="flow")
    assert_same_run(port, ref)
    assert port.events_processed < ci_runs["port"][0][name].events_processed


def test_ci_hybrid_and_maxmin_counters_equal_to_reference(ci_runs):
    """The 30 hybrid and 2 maxmin counters of benchmarks/ci_regression.py,
    computed by both packages: with the 26 of tests/test_torch_packet.py
    and tests/test_torch_wormhole.py, 58 of its 68 (the campaign and
    learned ones need the run store and campaigns)."""
    ref = ci_counters(*ci_runs["reference"])
    port = ci_counters(*ci_runs["port"])
    assert len(port) == 32 and port == ref
    assert port["maxmin/solver_invocations"] > 0


def test_hybrid_opts_and_refusals_as_in_reference():
    """Option names, config precedence (a dict over scenario.kernel, an
    object copied), and the refusals' messages."""
    assert port_engines.HybridEngine.option_names == ref_engines.HybridEngine.option_names
    assert port_engines.HybridEngine.uses_db == ref_engines.HybridEngine.uses_db
    assert port_hybrid.FIDELITIES == ref_hybrid.FIDELITIES
    assert [f.name for f in dataclasses.fields(port_hybrid.HybridConfig)] == \
        [f.name for f in dataclasses.fields(ref_hybrid.HybridConfig)]
    assert dataclasses.asdict(port_hybrid.HybridConfig()) == \
        dataclasses.asdict(ref_hybrid.HybridConfig())
    ref_scn = CI_SCENARIOS["quickstart"]().variant(name="k", kernel={"demote_after": 4})
    scn = port_scenario(ref_scn)
    for kw in ({"config": {"band": 0.08}}, {"demote_after": 8, "until": 0.01},
               {"record_rtt": (0, 3)}):
        ref_kw = dict(kw)
        assert_same_run(port_api.run(scn, backend="hybrid", **kw),
                        ref_api.run(ref_scn, backend="hybrid", **ref_kw))
    assert_same_run(port_api.run(scn, backend="hybrid",
                                 config=port_hybrid.HybridConfig(demote_after=3)),
                    ref_api.run(ref_scn, backend="hybrid",
                                config=ref_hybrid.HybridConfig(demote_after=3)))
    for kw in ({"fidelity": "quantum"}, {"device": "cpu"}, {"intra_workers": 2}):
        with pytest.raises(ValueError) as ref_err:
            ref_api.run(ref_scn.variant(name="c", chaos=[
                {"kind": "degrade_link", "link": 3, "t": 0.001, "factor": 0.5}]),
                backend="hybrid", **kw)
        with pytest.raises(ValueError) as port_err:
            port_api.run(port_scenario(ref_scn.variant(name="c", chaos=[
                {"kind": "degrade_link", "link": 3, "t": 0.001, "factor": 0.5}])),
                backend="hybrid", **kw)
        assert str(port_err.value) == str(ref_err.value)


_HYBRID_RUN = """
import json, sys
pkg = sys.argv[1]
api = __import__(pkg + ".api", fromlist=["run"])
sys.path.insert(0, ".")
from examples.quickstart import make_scenario
scn = api.Scenario.from_dict(make_scenario().to_dict())
r = api.run(scn, backend="hybrid")
json.dump({"fcts": {str(k): v.hex() for k, v in r.fcts.items()},
           "events": r.events_processed, "granularity": r.extras["granularity"],
           "shard": r.extras["shard"]}, sys.stdout)
"""


def test_hybrid_run_identical_across_hash_seeds():
    """The port's hybrid run is bit-identical under two PYTHONHASHSEED
    values, and equal to the reference's under a third."""
    outs = []
    for pkg, seed in (("repro_torch", "0"), ("repro_torch", "31337"), ("repro", "7")):
        env = dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=os.pathsep.join(
            p for p in (str(REPO / "src"), os.environ.get("PYTHONPATH")) if p))
        proc = subprocess.run([sys.executable, "-c", _HYBRID_RUN, pkg], cwd=REPO,
                              capture_output=True, text=True, env=env, timeout=600)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout)
    assert outs[0] == outs[1] == outs[2]
    assert '"demotions": 0' not in outs[0]


# --------------------------------------------------------------------- #
# mirrors of tests/test_hybrid.py, on both packages
# --------------------------------------------------------------------- #
def wave_scenario(pkg, second_wave: float = 0.02, name: str = "hwaves"):
    """The quickstart contention pattern; ``second_wave`` inside the first
    wave's lifetime (~1.5 ms) turns the second launch into a promotion
    interrupt for the demoted first-wave partitions."""
    flows = []
    fid = 0
    for wave in (0.0, second_wave):
        for i in range(4):
            flows.append(pkg.FlowSpec(fid, i, 12 + (i % 2), size=8e6,
                                      start=wave, cca="dctcp", tag=f"w{wave:g}"))
            fid += 1
    return pkg.Scenario(name, pkg.TopologySpec("clos", {"n_hosts": 16, "leaf_down": 4,
                                                        "n_spines": 2}), flows=flows)


def test_fidelity_packet_bit_identical_to_sharded_serial(pkg):
    scn = wave_scenario(pkg)
    sharded = pkg.run(scn, backend="packet", parallel="partitions")
    hyb = pkg.run(scn, backend="hybrid", fidelity="packet")
    assert hyb.fcts == sharded.fcts
    assert hyb.events_processed == sharded.events_processed
    serial = pkg.run(scn, backend="packet")
    assert hyb.fcts == serial.fcts
    assert hyb.events_processed == serial.events_processed
    g = hyb.extras["granularity"]
    assert g["demotions"] == 0 and g["flow_lane_events"] == 0
    assert g["packet_lane_events"] > 0


def _assert_acceptance(pkg, scn, min_cut=3.0, max_err=0.01):
    base = pkg.run(scn, backend="packet")
    auto = pkg.run(scn, backend="hybrid", fidelity="auto")
    g = auto.extras["granularity"]
    cut = base.events_processed / max(g["packet_lane_events"], 1)
    err = float(auto.fct_errors_vs(base).mean())
    assert cut >= min_cut, f"packet-lane cut {cut:.2f}x < {min_cut}x"
    assert err < max_err, f"mean FCT err {err:.4f} >= {max_err}"
    assert g["demotions"] > 0
    assert set(auto.fcts) == set(base.fcts)
    return auto


def test_acceptance_quickstart(pkg):
    _assert_acceptance(pkg, wave_scenario(pkg))


def test_acceptance_64gpu_preset(pkg):
    _assert_acceptance(pkg, pkg.training_scenario(n_gpus=64, cca="hpcc", scale=1 / 256))


def test_acceptance_moe_ep_preset(pkg):
    scn = pkg.training_scenario(n_gpus=64, moe=True, cca="hpcc", scale=1 / 512)
    assert scn.workload.family == "moe"
    _assert_acceptance(pkg, scn)


def test_promotion_on_flow_entry(pkg):
    scn = wave_scenario(pkg, second_wave=0.0008, name="overlap")
    base = pkg.run(scn, backend="packet")
    auto = pkg.run(scn, backend="hybrid")
    g = auto.extras["granularity"]
    assert g["promotions"] > 0, "flow entry must promote demoted partitions"
    assert g["demotions"] > g["promotions"], "partitions re-demote after"
    assert float(auto.fct_errors_vs(base).mean()) < 0.10
    assert g["packet_lane_events"] < base.events_processed


def test_completion_resolve_keeps_flow_lane(pkg):
    flows = [pkg.FlowSpec(0, 0, 12, 8e6, 0.0, "dctcp"),
             pkg.FlowSpec(1, 1, 12, 12e6, 0.0, "dctcp")]
    scn = pkg.Scenario("uneven", pkg.TopologySpec("clos", {"n_hosts": 16,
                       "leaf_down": 4, "n_spines": 2}), flows=flows)
    base = pkg.run(scn, backend="packet")
    auto = pkg.run(scn, backend="hybrid")
    g = auto.extras["granularity"]
    assert g["resolves"] >= 1, "survivor must re-enter the flow lane"
    assert float(auto.fct_errors_vs(base).mean()) < 0.02


def test_fidelity_flow_is_coarse_and_cheap(pkg):
    scn = wave_scenario(pkg)
    base = pkg.run(scn, backend="packet")
    fl = pkg.run(scn, backend="hybrid", fidelity="flow")
    g = fl.extras["granularity"]
    assert g["packet_lane_events"] == 0
    assert fl.events_processed < base.events_processed / 100
    assert set(fl.fcts) == set(base.fcts)
    assert float(fl.fct_errors_vs(base).mean()) < 0.35


def test_validate_mode_checks_invariants(pkg):
    scn = wave_scenario(pkg, second_wave=0.0008, name="overlap-v")
    plain = pkg.run(scn, backend="hybrid")
    checked = pkg.run(scn, backend="hybrid", validate=True)
    assert checked.fcts == plain.fcts


def test_intra_workers_parity(pkg):
    """The hybrid backend rides the sharded loop's fan-out machinery:
    results are identical for any worker count."""
    scn = wave_scenario(pkg, second_wave=0.0008, name="overlap-iw")
    serial = pkg.run(scn, backend="hybrid")
    par = pkg.run(scn, backend="hybrid", intra_workers=2)
    assert par.fcts == serial.fcts
    assert par.events_processed == serial.events_processed
    assert (par.extras["granularity"]["packet_lane_events"]
            == serial.extras["granularity"]["packet_lane_events"])


def test_unknown_fidelity_raises(pkg):
    with pytest.raises(ValueError, match="fidelity"):
        pkg.run(wave_scenario(pkg), backend="hybrid", fidelity="quantum")


def test_config_ignores_foreign_kernel_knobs(pkg):
    cfg = pkg.HybridConfig.from_knobs({"theta": 0.05, "demote_after": 4})
    assert cfg.demote_after == 4


def test_config_fidelity_respected_and_not_mutated(pkg):
    scn = wave_scenario(pkg)
    cfg = pkg.HybridConfig(fidelity="flow")
    r = pkg.run(scn, backend="hybrid", config=cfg)
    assert r.extras["granularity"]["packet_lane_events"] == 0
    assert cfg.fidelity == "flow"
    pkg.run(scn, backend="hybrid", config=cfg, fidelity="auto", demote_after=4)
    assert cfg.fidelity == "flow"
    assert cfg.demote_after == pkg.HybridConfig().demote_after


def test_flow_fidelity_survives_max_demote_horizon(pkg):
    scn = wave_scenario(pkg)
    r = pkg.run(scn, backend="hybrid", fidelity="flow", config={"max_demote": 1e-4})
    g = r.extras["granularity"]
    assert g["packet_lane_events"] == 0
    assert g["probes"] == 0 and g["promotions"] == 0


def test_demote_after_knob_threads_through(pkg):
    scn = wave_scenario(pkg)
    eager = pkg.run(scn, backend="hybrid", demote_after=4)
    lazy = pkg.run(scn, backend="hybrid", demote_after=24)
    ge, gl = eager.extras["granularity"], lazy.extras["granularity"]
    assert ge["packet_lane_events"] < gl["packet_lane_events"]


def test_run_many_rejects_db_for_hybrid(pkg):
    with pytest.raises(ValueError, match="wormhole"):
        pkg.run_many([wave_scenario(pkg)], backend="hybrid", shared_db=True)


def test_partition_granularity_tags(pkg):
    idx = pkg.PartitionIndex()
    pid_a, _ = idx.add_flow(1, frozenset({10, 11}))
    assert idx.granularity[pid_a] == "packet"
    idx.set_granularity(pid_a, "flow")
    pid_b, merged = idx.add_flow(2, frozenset({11, 12}))
    assert merged == {pid_a}
    assert idx.granularity[pid_b] == "packet"
    idx.set_granularity(pid_b, "flow")
    idx.add_flow(3, frozenset({12, 13}))
    pid_c = idx.flow_pid[1]
    idx.set_granularity(pid_c, "flow")
    idx.remove_flow(2)
    assert all(idx.granularity[idx.flow_pid[f]] == "flow" for f in (1, 3))
    idx.check_invariants()
    with pytest.raises(ValueError):
        idx.set_granularity(idx.flow_pid[1], "plasma")
    with pytest.raises(KeyError):
        idx.set_granularity(999, "flow")


def test_maxmin_rates_water_filling(pkg):
    rates = pkg.maxmin_rates({1: [0], 2: [0, 1], 3: [0]}, {0: 10.0, 1: 4.0})
    assert rates[2] == pytest.approx(10 / 3)
    assert rates[1] == rates[3] == pytest.approx(10 / 3)
    rates = pkg.maxmin_rates({1: [0], 2: [1]}, {0: 10.0, 1: 4.0})
    assert rates[1] == pytest.approx(10.0)
    assert rates[2] == pytest.approx(4.0)


# --------------------------------------------------------------------- #
# mirrors of the pipeline and step-chaining cases of tests/test_schedules.py
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("collective", ["tree", "halving_doubling", "hierarchical"])
def test_steps_execute_in_strict_order_under_driver(pkg, collective):
    topo = pkg.topology_for(16)
    steps = pkg.schedules.allreduce_steps(collective, list(range(8)), 4e5, pkg.FidAlloc(),
                                          topo_meta={"gpus_per_server": 8})
    phases = pkg.schedules.steps_to_phases(steps, compute=1e-5)
    assert phases[0].compute == 1e-5 and phases[0].deps == []
    assert [p.deps for p in phases[1:]] == [[k] for k in range(len(phases) - 1)]
    fid2step = {f.fid: k for k, (_n, fl) in enumerate(steps) for f in fl}
    finish: dict[int, float] = {}
    sim = pkg.PacketSim(topo)
    sim.finish_listeners.append(lambda fl, t: finish.setdefault(fl.fid, t))
    drv = pkg.WorkloadDriver(sim, phases)
    sim.run()
    assert drv.finished
    assert set(finish) == set(fid2step)
    for k in range(1, len(steps)):
        prev_done = max(t for f, t in finish.items() if fid2step[f] == k - 1)
        first_done = min(t for f, t in finish.items() if fid2step[f] == k)
        assert first_done >= prev_done


def test_pipeline_phases_dag_and_bubble_fraction(pkg):
    S, M, t_fwd = 4, 6, 2e-4
    phases = pkg.schedules.pipeline_phases(list(range(S)), M, 1e3, pkg.FidAlloc(),
                                           t_fwd=t_fwd)
    assert len(phases) == 2 * S * M
    for i, p in enumerate(phases):
        assert all(d < i for d in p.deps)
    assert phases[0].deps == []
    sim = pkg.PacketSim(pkg.topology_for(16))
    drv = pkg.WorkloadDriver(sim, phases)
    sim.run()
    ideal = (M + S - 1) * (t_fwd + 2 * t_fwd)
    assert ideal <= drv.iteration_time == pytest.approx(ideal, rel=0.1)
    frac = pkg.schedules.pipeline_bubble_fraction
    assert frac(S, M) == pytest.approx((S - 1) / (M + S - 1))
    assert frac(1, M) == 0.0
    with pytest.raises(ValueError, match=">= 2 stages"):
        pkg.schedules.pipeline_phases([0], M, 1e3, pkg.FidAlloc())
    with pytest.raises(ValueError, match=">= 1 microbatch"):
        pkg.schedules.pipeline_phases([0, 1], 0, 1e3, pkg.FidAlloc())


def _phases_form(phases):
    return [(p.name, [dataclasses.astuple(f) for f in p.flows], list(p.deps), p.compute)
            for p in phases]


@pytest.mark.parametrize("t_bwd", [None, 3e-4])
def test_pipeline_and_step_chaining_equal_to_reference(t_bwd):
    """The ported schedules emit the reference's phases, flow for flow, and
    a pipeline program runs to the reference's iteration time."""
    def build(p):
        pp = p.schedules.pipeline_phases([0, 3, 5, 9], 5, 2e4, p.FidAlloc(),
                                         cca="hpcc", t_fwd=1e-4, t_bwd=t_bwd)
        steps = p.schedules.allreduce_steps("tree", list(range(8)), 4e5, p.FidAlloc(),
                                            topo_meta={"gpus_per_server": 8})
        return pp, p.schedules.steps_to_phases(steps, deps=[2], compute=3e-5)
    ref, port = build(PKGS["reference"]), build(PKGS["port"])
    for r, q in zip(ref, port):
        assert _phases_form(q) == _phases_form(r)
    assert port_schedules.__all__ == ref_schedules.__all__
    times = []
    for p, (pp, _chain) in ((PKGS["reference"], ref), (PKGS["port"], port)):
        sim = p.PacketSim(p.topology_for(16))
        drv = p.WorkloadDriver(sim, pp)
        sim.run()
        times.append((drv.iteration_time, sim.events_processed))
    assert times[0] == times[1]
