"""The port's Wormhole kernel (``wormhole`` backend) and the modules under
it (steady detector, partitioning, flow conflict graphs, the simulation
database) against the JAX package's, on the CPU.

The kernel is a host-side event simulator in float64 in both packages, so
the bar is equality: the same FCTs, events, kernel report counters and
SimDB contents, compared with ``==``, and SimDB files that either package
loads from the other.  The reference's own tests of these modules
(``tests/test_steady.py``, ``test_partition.py``, ``test_fcg.py``,
``test_memo.py``, ``test_wormhole.py``, ``test_determinism_pins.py`` and the
wormhole rows of ``test_chaos.py``) are mirrored here at the same sizes and
run on both packages (the ``pkg`` parameter), beside the parity tests."""
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:                    # optional dep: deterministic fallback
    from hypcompat import given, settings, st

import repro.api as ref_api
import repro.core.fcg as ref_fcg
import repro.core.memo as ref_memo
import repro.core.partition as ref_partition
import repro.core.steady as ref_steady
import repro.core.theory as ref_theory
import repro.core.wormhole as ref_wormhole
import repro.net.flows as ref_flows
import repro.net.packet_sim as ref_packet_sim
import repro.net.topology as ref_topology
import repro_torch.api as port_api
import repro_torch.core.fcg as port_fcg
import repro_torch.core.memo as port_memo
import repro_torch.core.partition as port_partition
import repro_torch.core.steady as port_steady
import repro_torch.core.theory as port_theory
import repro_torch.core.wormhole as port_wormhole
import repro_torch.net.flows as port_flows
import repro_torch.net.packet_sim as port_packet_sim
import repro_torch.net.topology as port_topology
from test_api import wave_scenario
from test_chaos import DEGRADE, HOT_LINK
from test_torch_packet import (CI_SCENARIOS, PARITY_SCENARIOS, assert_same_run,
                               port_scenario, quickstart)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _pkg(api, fcg, memo, partition, steady, theory, wormhole, flows, packet_sim,
         topology):
    return types.SimpleNamespace(
        run=api.run, Scenario=api.Scenario, build_fcg=fcg.build_fcg,
        isomorphism=fcg.isomorphism, stable_hash=fcg.stable_hash, SimDB=memo.SimDB,
        MemoEntry=memo.MemoEntry, MemoHit=memo.MemoHit, STEADY=memo.STEADY,
        COMPLETION=memo.COMPLETION, PartitionIndex=partition.PartitionIndex,
        steady=steady, theory=theory, WormholeConfig=wormhole.WormholeConfig,
        WormholeKernel=wormhole.WormholeKernel, FlowSpec=flows.FlowSpec,
        PacketSim=packet_sim.PacketSim, leaf_spine_clos=topology.leaf_spine_clos,
        rail_optimized_fat_tree=topology.rail_optimized_fat_tree)


PKGS = {
    "reference": _pkg(ref_api, ref_fcg, ref_memo, ref_partition, ref_steady, ref_theory,
                      ref_wormhole, ref_flows, ref_packet_sim, ref_topology),
    "port": _pkg(port_api, port_fcg, port_memo, port_partition, port_steady, port_theory,
                 port_wormhole, port_flows, port_packet_sim, port_topology),
}
REF, PORT = PKGS["reference"], PKGS["port"]


@pytest.fixture(scope="module", params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


# --------------------------------------------------------------------- #
# the wormhole backend, end to end, against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(PARITY_SCENARIOS))
def test_wormhole_run_equal_to_reference(name):
    """FCTs, events, iteration time, the kernel report and the SimDB the
    run fills, on the CI scenarios and a degrade_link scenario."""
    ref_scn = PARITY_SCENARIOS[name]()
    ref_db, port_db = ref_memo.SimDB(), port_memo.SimDB()
    ref = ref_api.run(ref_scn, backend="wormhole", db=ref_db)
    port = port_api.run(port_scenario(ref_scn), backend="wormhole", db=port_db)
    assert_same_run(port, ref)
    assert port.kernel_report["parks"] + port.kernel_report["replays"] > 0
    assert port_db.to_dict() == ref_db.to_dict()
    assert port_db.fingerprint == ref_db.fingerprint


def _ci_wormhole_counters(api, make):
    out = {}
    for label, mk in CI_SCENARIOS.items():
        rep = api.run(make(mk()), backend="wormhole").kernel_report
        out[f"{label}/wormhole/events_processed"] = rep["events_processed"]
        for k in ("db_hits", "db_lookups", "parks", "replays"):
            out[f"{label}/wormhole/{k}"] = rep[k]
    return out


def test_ci_wormhole_counters_equal_to_reference():
    """The 25 wormhole counters of benchmarks/ci_regression.py, computed by
    both packages (the packet counter is in tests/test_torch_packet.py)."""
    ref = _ci_wormhole_counters(ref_api, lambda s: s)
    port = _ci_wormhole_counters(port_api, port_scenario)
    assert len(port) == 25 and port == ref


def test_config_dict_and_object_as_in_reference():
    ref_scn = wave_scenario(0.5)
    for config in ({"theta": 0.08, "enable_memo": False},
                   port_wormhole.WormholeConfig(window_auto=False, window=16)):
        ref_cfg = (config if isinstance(config, dict)
                   else ref_wormhole.WormholeConfig(window_auto=False, window=16))
        ref = ref_api.run(ref_scn, backend="wormhole", config=ref_cfg)
        port = port_api.run(port_scenario(ref_scn), backend="wormhole", config=config)
        assert_same_run(port, ref)
    # scenario.kernel is the base the config dict merges over
    ref_scn = ref_scn.variant(name="k", kernel={"theta": 0.1})
    assert_same_run(port_api.run(port_scenario(ref_scn), backend="wormhole",
                                 config={"confirm": False}),
                    ref_api.run(ref_scn, backend="wormhole", config={"confirm": False}))


def test_run_many_shared_db_equal_to_reference():
    """Three quickstart size variants through one shared SimDB: the same
    per-run events and memo hits, and the same DB at the end."""
    variants = [quickstart().variant(name=f"ci-{s:g}", size_scale=s)
                for s in (1.0, 1.05, 1.1)]
    ref_db, port_db = ref_memo.SimDB(), port_memo.SimDB()
    ref = ref_api.run_many(variants, backend="wormhole", db=ref_db)
    port = port_api.run_many([port_scenario(s) for s in variants], backend="wormhole",
                             db=port_db)
    for p, r in zip(port, ref):
        assert_same_run(p, r)
    assert [p.kernel_report["run_db_hits"] for p in port][1:] != [0, 0]
    assert port_db.to_dict() == ref_db.to_dict()
    shared = port_api.run_many([port_scenario(s) for s in variants], backend="wormhole",
                               shared_db=True)
    for p, r in zip(shared, ref):
        assert_same_run(p, r)


def test_run_many_collapses_duplicates_before_the_shared_db():
    """An identical scenario twice in one sweep is one simulation: the
    second does not run warm against the first's memo entries."""
    scns = [wave_scenario(0.5, name="a"), wave_scenario(0.6, name="b"),
            wave_scenario(0.5, name="a")]
    ref = ref_api.run_many(scns, backend="wormhole", shared_db=True)
    port = port_api.run_many([port_scenario(s) for s in scns], backend="wormhole",
                             shared_db=True)
    assert port[2] is port[0]
    for p, r in zip(port, ref):
        assert_same_run(p, r)


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_simdb_file_warm_starts_the_other_package(saver, tmp_path):
    """A SimDB saved by either package loads in the other and warm-starts
    it to the same events as the saver's own warm run."""
    cold, warm = wave_scenario(1.0, name="cold"), wave_scenario(1.1, name="warm")
    src, dst = PKGS[saver], PKGS["port" if saver == "reference" else "reference"]
    db = src.SimDB()
    src.run(src.Scenario.from_dict(cold.to_dict()), backend="wormhole", db=db)
    path = str(tmp_path / "simdb.json")
    db.save(path)
    home = src.run(src.Scenario.from_dict(warm.to_dict()), backend="wormhole",
                   db=src.SimDB.load_or_new(path))
    away_db = dst.SimDB.load_or_new(path)
    assert away_db.to_dict() == json.loads(pathlib.Path(path).read_text())
    away = dst.run(dst.Scenario.from_dict(warm.to_dict()), backend="wormhole", db=away_db)
    assert away.kernel_report["run_db_hits"] > 0
    assert away.fcts == home.fcts
    assert away.events_processed == home.events_processed
    assert away.kernel_report == home.kernel_report
    # and the files the two write are the same bytes
    other = str(tmp_path / "again.json")
    dst.SimDB.load(path).save(other)
    assert pathlib.Path(other).read_text() == pathlib.Path(path).read_text()


def test_simdb_refusals_as_in_reference():
    db = port_memo.SimDB()
    port_api.run(port_scenario(wave_scenario(0.5)), backend="wormhole", db=db)
    assert ";si=default" in db.fingerprint
    with pytest.raises(port_api.SimDBMismatch, match="recorded under"):
        port_api.run(port_scenario(wave_scenario(0.5, sample_interval=5e-5)),
                     backend="wormhole", db=db)
    with pytest.raises(port_memo.SimDBMismatch, match="format_version"):
        port_memo.SimDB.from_dict({**db.to_dict(), "format_version": -1})
    ref_db = ref_memo.SimDB()
    ref_api.run(wave_scenario(0.5), backend="wormhole", db=ref_db)
    assert db.fingerprint == ref_db.fingerprint
    assert port_memo.FORMAT_VERSION == ref_memo.FORMAT_VERSION


# --------------------------------------------------------------------- #
# mirrors of tests/test_wormhole.py, on both packages
# --------------------------------------------------------------------- #
def ring_workload(pkg, kernel=None, cca="dctcp", size=6e6, waves=2):
    topo = pkg.rail_optimized_fat_tree(8, gpus_per_server=4, leaf_radix=8, n_spines=2)
    sim = pkg.PacketSim(topo, kernel=kernel)
    fid = 0
    for w in range(waves):
        for r in range(4):
            for s in range(8):
                src = s * 4 + r
                dst = ((s + 1) % 8) * 4 + r
                sim.add_flow(pkg.FlowSpec(fid, src, dst, size, w * 0.02, cca, tag=f"ring{w}"))
                fid += 1
    sim.run()
    assert sim.all_done()
    return sim


def fct_errors(base, wh):
    assert set(base.results) == set(wh.results)
    return {fid: abs(wh.results[fid].fct - r.fct) / r.fct for fid, r in base.results.items()}


@pytest.fixture(scope="module")
def baseline(pkg):
    return ring_workload(pkg)


def test_fct_error_below_one_percent(pkg, baseline):
    wh = ring_workload(pkg, pkg.WormholeKernel(pkg.WormholeConfig()))
    errs = fct_errors(baseline, wh)
    assert sum(errs.values()) / len(errs) < 0.01
    assert max(errs.values()) < 0.05


def test_event_speedup_and_skip_ratio(pkg, baseline):
    k = pkg.WormholeKernel(pkg.WormholeConfig())
    wh = ring_workload(pkg, k)
    assert baseline.events_processed / wh.events_processed > 2.0
    rep = k.report()
    skip = rep["est_events_skipped"] / (rep["est_events_skipped"] + wh.events_processed)
    assert skip > 0.5


def test_memoization_hits_on_repeated_waves(pkg, baseline):
    k = pkg.WormholeKernel(pkg.WormholeConfig())
    ring_workload(pkg, k)
    assert k.db.hits >= 16
    wh2 = ring_workload(pkg, pkg.WormholeKernel(pkg.WormholeConfig(enable_memo=False)))
    errs = fct_errors(baseline, wh2)
    assert sum(errs.values()) / len(errs) < 0.01


def test_steady_only_and_memo_only_modes(pkg, baseline):
    for cfg in (pkg.WormholeConfig(enable_memo=False),
                pkg.WormholeConfig(enable_steady=False)):
        wh = ring_workload(pkg, pkg.WormholeKernel(cfg))
        errs = fct_errors(baseline, wh)
        assert sum(errs.values()) / len(errs) < 0.02


def test_conservation_under_wormhole(pkg):
    wh = ring_workload(pkg, pkg.WormholeKernel(pkg.WormholeConfig()))
    for f in wh.flows.values():
        assert f.done
        assert abs(f.delivered - f.spec.size) < 1.0


def _skip_back_scenario(pkg, kernel=None):
    topo = pkg.leaf_spine_clos(16, leaf_down=4, n_spines=2)
    sim = pkg.PacketSim(topo, kernel=kernel)
    sim.add_flow(pkg.FlowSpec(0, 0, 12, 16e6, 0.0, "dctcp"))
    sim.add_flow(pkg.FlowSpec(1, 1, 12, 16e6, 0.0, "dctcp"))
    sim.add_flow(pkg.FlowSpec(2, 2, 12, 2e6, 1.2e-3, "dctcp"))
    sim.run()
    assert sim.all_done()
    return sim


def test_skip_back_with_realtime_arrivals(pkg):
    base = _skip_back_scenario(pkg)
    k = pkg.WormholeKernel(pkg.WormholeConfig())
    errs = fct_errors(base, _skip_back_scenario(pkg, k))
    assert k.stats["skip_backs"] >= 1
    assert max(errs.values()) < 0.15
    assert sorted(errs.values())[1] < 0.02


def test_disjoint_partitions_do_not_interact(pkg):
    topo = pkg.leaf_spine_clos(16, leaf_down=4, n_spines=2)
    base = pkg.PacketSim(topo)
    base.add_flow(pkg.FlowSpec(0, 0, 1, 4e6, 0.0, "dctcp"))
    base.add_flow(pkg.FlowSpec(1, 4, 5, 4e6, 0.0, "dctcp"))
    base.run()
    k = pkg.WormholeKernel(pkg.WormholeConfig())
    wh = pkg.PacketSim(topo, kernel=k)
    wh.add_flow(pkg.FlowSpec(0, 0, 1, 4e6, 0.0, "dctcp"))
    wh.add_flow(pkg.FlowSpec(1, 4, 5, 4e6, 0.0, "dctcp"))
    wh.run()
    for fid in (0, 1):
        assert abs(wh.results[fid].fct - base.results[fid].fct) / base.results[fid].fct < 0.02


@pytest.mark.parametrize("cca", ["hpcc", "timely", "dcqcn"])
def test_other_ccas_bounded_error(pkg, cca):
    base = ring_workload(pkg, cca=cca, waves=1)
    wh = ring_workload(pkg, pkg.WormholeKernel(pkg.WormholeConfig()), cca=cca, waves=1)
    errs = fct_errors(base, wh)
    assert sum(errs.values()) / len(errs) < 0.015, f"{cca}: {max(errs.values())}"


def _short_flows(pkg, kernel=None):
    topo = pkg.leaf_spine_clos(16, leaf_down=4, n_spines=2)
    sim = pkg.PacketSim(topo, kernel=kernel)
    for fid in range(24):
        src, dst = int(fid % 16), int((fid * 7 + 3) % 16)
        if src == dst:
            dst = (dst + 1) % 16
        sim.add_flow(pkg.FlowSpec(fid, src, dst, float(2e5 + (fid % 5) * 1e5),
                                  fid * 3e-5, "dctcp"))
    sim.run()
    assert sim.all_done()
    return sim


def test_worst_case_degrades_gracefully(pkg):
    base = _short_flows(pkg)
    errs = fct_errors(base, _short_flows(pkg, pkg.WormholeKernel(pkg.WormholeConfig())))
    assert sum(errs.values()) / len(errs) < 0.03


def _forced_replay(pkg, cca: str):
    topo = pkg.leaf_spine_clos(16, leaf_down=4, n_spines=2)
    k = pkg.WormholeKernel(pkg.WormholeConfig())
    sim = pkg.PacketSim(topo, kernel=k)
    f = sim.add_flow(pkg.FlowSpec(0, 0, 12, 1e8, 0.0, cca))
    sim.run(until=2e-5)
    part = next(iter(k.parts.values()))
    assert part.fcg is not None and not f.parked
    hit = pkg.MemoHit(
        entry=pkg.MemoEntry(fcg=part.fcg, end_rates=[5e9], sizes=[1e5],
                            t_conv=1e-4, end_reason=pkg.STEADY),
        mapping={0: 0})
    k._apply_hit(part, hit, sim.now)
    assert f.parked
    sim.run(until=sim.now + 2e-4)
    assert k.stats["replays"] == 1 and k.stats["unparks"] == 1
    return f


def test_replay_restores_window_for_window_ccas(pkg):
    f = _forced_replay(pkg, "dctcp")
    assert f.cca.r == pytest.approx(5e9)
    assert f.cca.w == pytest.approx(5e9 * max(f.cca.srtt, f.cca.base_rtt))


@pytest.mark.parametrize("cca", ["dcqcn", "timely"])
def test_replay_keeps_rate_cca_window_cap(pkg, cca):
    f = _forced_replay(pkg, cca)
    assert f.cca.r == pytest.approx(5e9)
    cap = 1.5 * f.cca.line_rate * f.cca.base_rtt
    assert f.cca.w == pytest.approx(cap)
    assert f.cca.w > 5e9 * f.cca.srtt


def test_dcqcn_replay_fct_parity(pkg):
    base = ring_workload(pkg, cca="dcqcn", waves=2)
    k = pkg.WormholeKernel(pkg.WormholeConfig())
    wh = ring_workload(pkg, k, cca="dcqcn", waves=2)
    assert k.stats["replays"] > 0
    errs = fct_errors(base, wh)
    assert sum(errs.values()) / len(errs) < 0.015


def test_kernel_threads_mtu_into_lookup_tolerance(pkg, monkeypatch):
    seen = []
    orig = pkg.SimDB.lookup

    def spy(self, fcg, remaining, atol=None):
        seen.append(atol)
        return orig(self, fcg, remaining, atol)

    monkeypatch.setattr(pkg.SimDB, "lookup", spy)
    topo = pkg.leaf_spine_clos(16, leaf_down=4, n_spines=2)
    sim = pkg.PacketSim(topo, kernel=pkg.WormholeKernel(pkg.WormholeConfig()), mtu=500.0)
    sim.add_flow(pkg.FlowSpec(0, 0, 12, 2e6, 0.0, "dctcp"))
    sim.run(until=1e-4)
    assert seen and all(a == pytest.approx(2 * 500.0) for a in seen)


def _shared_buffer_scenario(pkg, kernel=None):
    topo = pkg.leaf_spine_clos(16, leaf_down=8, n_spines=2)
    sim = pkg.PacketSim(topo, kernel=kernel, shared_buffer=300_000.0, buffer_bytes=260_000.0)
    sim.add_flow(pkg.FlowSpec(0, 0, 8, 6e6, 0.0, "dctcp"))
    sim.add_flow(pkg.FlowSpec(1, 1, 8, 6e6, 0.0, "dctcp"))
    for i in range(4):
        sim.add_flow(pkg.FlowSpec(10 + i, 2 + i, 9, 1.5e6, 3e-4 + i * 1e-5, "dctcp"))
    sim.run()
    assert sim.all_done()
    return sim


def test_packet_pausing_preserves_shared_buffer_pressure(pkg):
    base = _shared_buffer_scenario(pkg)
    k = pkg.WormholeKernel(pkg.WormholeConfig())
    wh = _shared_buffer_scenario(pkg, k)
    errs = [abs(wh.results[f].fct - r.fct) / r.fct for f, r in base.results.items()]
    assert sum(errs) / len(errs) < 0.03, errs
    assert k.stats["parks"] >= 1


def _kernel_state(sim, kernel):
    return dict(fcts={f: (r.start, r.fct) for f, r in sim.results.items()},
                events=sim.events_processed, hops=sim.packet_hop_events,
                timeouts=sim.timeouts, report=kernel.report(),
                db=kernel.db.to_dict())


@pytest.mark.parametrize("case", ["ring", "ring-hpcc", "skip_back", "shared_buffer",
                                  "short_flows"])
def test_kernel_runs_equal_to_reference(case):
    """The mirrored sim-level runs, held to the reference's: FCTs, events,
    packet hops, the whole kernel report and the memo DB."""
    def drive(pkg):
        k = pkg.WormholeKernel(pkg.WormholeConfig(), pkg.SimDB())
        sim = {"ring": lambda: ring_workload(pkg, k),
               "ring-hpcc": lambda: ring_workload(pkg, k, cca="hpcc", waves=1),
               "skip_back": lambda: _skip_back_scenario(pkg, k),
               "shared_buffer": lambda: _shared_buffer_scenario(pkg, k),
               "short_flows": lambda: _short_flows(pkg, k)}[case]()
        return _kernel_state(sim, k)
    assert drive(PORT) == drive(REF)


# --------------------------------------------------------------------- #
# mirrors of the wormhole rows of tests/test_chaos.py, on both packages
# --------------------------------------------------------------------- #
def _wave(pkg, **kw):
    return pkg.Scenario.from_dict(wave_scenario().variant(**kw).to_dict())


def test_wormhole_skips_back_and_stays_accurate_under_chaos(pkg):
    scn = _wave(pkg, name="whchaos", chaos=[DEGRADE])
    pkt = pkg.run(scn, backend="packet")
    wh = pkg.run(scn, backend="wormhole")
    rep = wh.kernel_report
    assert rep["skip_backs"] >= 1
    assert rep["parks"] > 0
    assert wh.fct_errors_vs(pkt).mean() < 0.01
    assert wh.events_processed < pkt.events_processed


def test_wormhole_memo_entries_do_not_leak_across_capacity_regimes(pkg):
    scn = _wave(pkg, name="leak", chaos=[
        {"kind": "degrade_link", "link": HOT_LINK, "t": 0.01, "factor": 0.25}])
    pkt = pkg.run(scn, backend="packet")
    wh = pkg.run(scn, backend="wormhole")
    assert wh.fct_errors_vs(pkt).mean() < 0.01


# --------------------------------------------------------------------- #
# mirrors of tests/test_determinism_pins.py
# --------------------------------------------------------------------- #
def test_stable_hash_pinned_values(pkg):
    assert pkg.stable_hash(()) == 3492114727459
    assert pkg.stable_hash((1, 2, 3)) == 137031301605602
    assert pkg.stable_hash(("dctcp", (4, 8))) == 2227764377384
    assert pkg.stable_hash(("a", ("b", ("c",)))) == 71742425096237


def test_stable_hash_fits_48_bits(pkg):
    for obj in [(), (0,), ("x", 1, ("y", 2)), tuple(range(100))]:
        h = pkg.stable_hash(obj)
        assert 0 <= h < 2**48
        assert h == REF.stable_hash(obj)


def test_partition_index_orders_are_value_determined(pkg):
    def build():
        idx = pkg.PartitionIndex()
        for fid, ports in [(3, {1, 2}), (1, {2, 3}), (2, {9}), (7, {3, 4}), (5, {9, 10})]:
            idx.add_flow(fid, frozenset(ports))
        idx.remove_flow(1)
        return idx
    a, b = build(), build()
    assert list(a.flow_pid.items()) == list(b.flow_pid.items())
    assert list(a.port_pid.items()) == list(b.port_pid.items())
    assert {pid: sorted(fl) for pid, fl in a.parts.items()} == \
           {pid: sorted(fl) for pid, fl in b.parts.items()}
    if pkg is PORT:
        ref = REF.PartitionIndex()
        for fid, ports in [(3, {1, 2}), (1, {2, 3}), (2, {9}), (7, {3, 4}), (5, {9, 10})]:
            ref.add_flow(fid, frozenset(ports))
        ref.remove_flow(1)
        assert list(a.flow_pid.items()) == list(ref.flow_pid.items())
        assert list(a.port_pid.items()) == list(ref.port_pid.items())


_WORMHOLE_RUN = textwrap.dedent("""
    import json, sys
    PKG = sys.argv[1]
    memo = __import__(PKG + ".core.memo", fromlist=["SimDB"])
    wormhole = __import__(PKG + ".core.wormhole", fromlist=["WormholeKernel"])
    flows = __import__(PKG + ".net.flows", fromlist=["FlowSpec"])
    packet_sim = __import__(PKG + ".net.packet_sim", fromlist=["PacketSim"])
    topology = __import__(PKG + ".net.topology", fromlist=["rail_optimized_fat_tree"])

    topo = topology.rail_optimized_fat_tree(8, gpus_per_server=4, leaf_radix=8,
                                            n_spines=2)
    kernel = wormhole.WormholeKernel(wormhole.WormholeConfig(), memo.SimDB())
    sim = packet_sim.PacketSim(topo, kernel=kernel)
    fid = 0
    for w in range(2):
        for r in range(4):
            for s in range(8):
                sim.add_flow(flows.FlowSpec(fid, s * 4 + r, ((s + 1) % 8) * 4 + r,
                                            2e6, w * 0.02, "dctcp"))
                fid += 1
    sim.run()
    out = {
        "fcts": {str(f): r.fct for f, r in sorted(sim.results.items())},
        "events": sim.events_processed,
        "hops": sim.packet_hop_events,
        "report": {k: v for k, v in sorted(kernel.report().items())
                   if isinstance(v, (int, float, str))},
        "db": kernel.db.to_dict(),
    }
    json.dump(out, sys.stdout)
""")


def test_wormhole_run_identical_across_hash_seeds():
    """The port's wormhole run is bit-identical under two PYTHONHASHSEED
    values, and equal to the reference's."""
    outs = []
    for pkg, seed in (("repro_torch", "0"), ("repro_torch", "31337"), ("repro", "7")):
        env = dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=os.pathsep.join(
            p for p in (str(REPO / "src"), os.environ.get("PYTHONPATH")) if p))
        proc = subprocess.run([sys.executable, "-c", _WORMHOLE_RUN, pkg],
                              capture_output=True, text=True, env=env, timeout=600)
        assert proc.returncode == 0, proc.stderr
        outs.append(json.loads(proc.stdout))
    assert outs[0] == outs[1] == outs[2]
    assert outs[0]["report"]["parks"] + outs[0]["report"]["replays"] > 0


# --------------------------------------------------------------------- #
# mirrors of tests/test_memo.py, on both packages
# --------------------------------------------------------------------- #
def _fcg(pkg, fids, ports, rates=None, lr=12.5e9):
    rates = rates or {}
    return pkg.build_fcg(fids, {f: frozenset(p) for f, p in ports.items()},
                         {f: rates.get(f, lr) for f in fids},
                         {f: lr for f in fids}, {f: "dctcp" for f in fids})


def _entry(pkg, g, sizes, reason=None, rates=None):
    return pkg.MemoEntry(fcg=g, end_rates=rates or [6e9] * g.n, sizes=sizes,
                         t_conv=1e-3, end_reason=reason or pkg.STEADY)


def test_hit_on_isomorphic_scene(pkg):
    db = pkg.SimDB()
    db.insert(_entry(pkg, _fcg(pkg, [1, 2], {1: {10}, 2: {10}}), [1e6, 1e6]))
    hit = db.lookup(_fcg(pkg, [40, 41], {40: {99}, 41: {99}}), remaining=[5e6, 5e6])
    assert hit is not None
    assert sorted(hit.mapping.keys()) == [0, 1]


def test_remaining_size_guard(pkg):
    db = pkg.SimDB()
    db.insert(_entry(pkg, _fcg(pkg, [1, 2], {1: {10}, 2: {10}}), [4e6, 4e6]))
    assert db.lookup(_fcg(pkg, [3, 4], {3: {5}, 4: {5}}), remaining=[1e6, 9e6]) is None
    assert db.lookup(_fcg(pkg, [3, 4], {3: {5}, 4: {5}}), remaining=[9e6, 9e6]) is not None


def test_no_hit_across_structures(pkg):
    db = pkg.SimDB()
    db.insert(_entry(pkg, _fcg(pkg, [1, 2], {1: {10}, 2: {10}}), [1e6, 1e6]))
    g3 = _fcg(pkg, [1, 2, 3], {1: {10}, 2: {10}, 3: {10}})
    assert db.lookup(g3, [9e6] * 3) is None


def test_stats_and_size_accounting(pkg):
    db = pkg.SimDB()
    for i in range(10):
        g = _fcg(pkg, [i, 100 + i], {i: {i * 2}, 100 + i: {i * 2}},
                 rates={i: 12.5e9 * (1 - 0.05 * i)})
        db.insert(_entry(pkg, g, [1e6, 1e6]))
    s = db.stats()
    assert s["entries"] == 10
    assert 0 < s["bytes"] < 100_000


def test_completion_entries_roundtrip(pkg):
    db = pkg.SimDB()
    db.insert(_entry(pkg, _fcg(pkg, [1], {1: {10}}), [2e6], reason=pkg.COMPLETION))
    hit = db.lookup(_fcg(pkg, [9], {9: {77}}), remaining=[2e6])
    assert hit is not None and hit.entry.end_reason == pkg.COMPLETION


def test_nbytes_counts_sizes_and_completed(pkg):
    g = _fcg(pkg, [1, 2], {1: {10}, 2: {10}})
    e = pkg.MemoEntry(fcg=g, end_rates=[6e9, 6e9], sizes=[1e6, 1e6], t_conv=1e-3,
                      end_reason=pkg.STEADY, completed=(0,))
    assert e.nbytes() == g.nbytes() + 16 * 2 + 16 * 2 + 8 * 1 + 32
    assert e.nbytes() >= g.nbytes() + 16 * len(e.end_rates) + 16 * len(e.sizes)
    assert e.nbytes() > g.nbytes() + 16 * len(e.end_rates) + 32


def test_completion_match_tolerance_scales_with_mtu(pkg):
    db = pkg.SimDB()
    g = _fcg(pkg, [1], {1: {10}})
    db.insert(pkg.MemoEntry(fcg=g, end_rates=[6e9], sizes=[2e6], t_conv=1e-3,
                            end_reason=pkg.COMPLETION, completed=(0,)))
    probe = _fcg(pkg, [9], {9: {77}})
    assert db.lookup(probe, remaining=[2e6 + 3e3]) is None
    assert db.lookup(probe, remaining=[2e6 + 3e3], atol=2 * 9000.0) is not None
    assert db.lookup(probe, remaining=[2e6 + 1.5e3], atol=2 * 500.0) is None
    assert db.lookup(probe, remaining=[2e6 + 0.9e3], atol=2 * 500.0) is not None


def test_completion_tolerance_capped_relative_to_flow_size(pkg):
    db = pkg.SimDB()
    g = _fcg(pkg, [1], {1: {10}})
    db.insert(pkg.MemoEntry(fcg=g, end_rates=[6e9], sizes=[18923.0], t_conv=2e-5,
                            end_reason=pkg.COMPLETION, completed=(0,)))
    probe = _fcg(pkg, [9], {9: {77}})
    assert db.lookup(probe, remaining=[19783.0]) is None
    assert db.lookup(probe, remaining=[18930.0]) is not None


def test_merge_and_entry_dicts_equal_to_reference():
    """Entries built from the same scene serialise to the same dicts, and a
    merge of two DBs keeps the reference's entries and counts."""
    def build(pkg):
        a, b = pkg.SimDB(fingerprint="fp"), pkg.SimDB(fingerprint="fp")
        for i in range(6):
            g = _fcg(pkg, [i, 100 + i], {i: {i * 2}, 100 + i: {i * 2, 7}},
                     rates={i: 12.5e9 * (1 - 0.05 * i)})
            (a if i % 2 else b).insert(_entry(pkg, g, [1e6 * (i + 1), 1e6]))
            a.insert(_entry(pkg, g, [1e6 * (i + 1), 1e6]))
        added = a.merge(b)
        return added, a.to_dict(), a.stats()
    assert build(PORT) == build(REF)


# --------------------------------------------------------------------- #
# mirrors of tests/test_fcg.py, on both packages
# --------------------------------------------------------------------- #
def _mk(pkg, fids, ports, rates, lr=12.5e9, cca="dctcp"):
    return pkg.build_fcg(fids, {f: frozenset(p) for f, p in ports.items()},
                         rates={f: rates.get(f, lr) for f in fids},
                         line_rates={f: lr for f in fids}, ccas={f: cca for f in fids})


def test_relabeling_invariance(pkg):
    a = _mk(pkg, [1, 2, 3], {1: {10, 11}, 2: {11, 12}, 3: {12, 13}}, {})
    b = _mk(pkg, [7, 8, 9], {9: {20, 21}, 8: {21, 22}, 7: {22, 23}}, {})
    assert a.key == b.key
    m = pkg.isomorphism(a, b)
    assert m is not None
    deg_a = {0: 1, 1: 2, 2: 1}
    for u, v in m.items():
        assert deg_a[u] == deg_a[v]


def test_different_structure_rejected(pkg):
    chain = _mk(pkg, [1, 2, 3], {1: {10}, 2: {10, 11}, 3: {11}}, {})
    tri = _mk(pkg, [1, 2, 3], {1: {10, 12}, 2: {10, 11}, 3: {11, 12}}, {})
    assert chain.key != tri.key
    assert pkg.isomorphism(chain, tri) is None


def test_edge_weight_mismatch_rejected(pkg):
    one = _mk(pkg, [1, 2], {1: {10}, 2: {10}}, {})
    two = _mk(pkg, [1, 2], {1: {10, 11}, 2: {10, 11}}, {})
    assert pkg.isomorphism(one, two) is None


def test_rate_buckets_affect_key(pkg):
    a = _mk(pkg, [1, 2], {1: {10}, 2: {10}}, {1: 12.5e9, 2: 12.5e9})
    b = _mk(pkg, [1, 2], {1: {10}, 2: {10}}, {1: 6.0e9, 2: 6.0e9})
    assert pkg.isomorphism(a, b) is None


def test_cca_affects_key(pkg):
    a = _mk(pkg, [1, 2], {1: {10}, 2: {10}}, {}, cca="dctcp")
    b = _mk(pkg, [1, 2], {1: {10}, 2: {10}}, {}, cca="hpcc")
    assert pkg.isomorphism(a, b) is None


@given(st.integers(2, 9), st.randoms(use_true_random=False))
@settings(max_examples=60, deadline=None)
def test_random_graph_permutation_isomorphic(n, rnd):
    """On the port: permuting a random conflict graph's vertices always
    yields an isomorphism that preserves edges and weights; and both
    packages build the same key, labels, edges and mapping."""
    ports = {f: set() for f in range(n)}
    pid = 0
    for i in range(n):
        for j in range(i + 1, n):
            if rnd.random() < 0.4:
                for _ in range(rnd.randint(1, 3)):
                    ports[i].add(pid)
                    ports[j].add(pid)
                    pid += 1
    for f in range(n):
        if not ports[f]:
            ports[f].add(pid)
            pid += 1
    perm = list(range(n))
    rnd.shuffle(perm)
    ports_b = {perm[f]: ports[f] for f in range(n)}
    a, b = _mk(PORT, list(range(n)), ports, {}), _mk(PORT, list(range(n)), ports_b, {})
    assert a.key == b.key
    m = PORT.isomorphism(a, b)
    assert m is not None
    for (i, j), w in a.edges.items():
        assert b.edges.get(tuple(sorted((m[i], m[j])))) == w
    ra, rb = _mk(REF, list(range(n)), ports, {}), _mk(REF, list(range(n)), ports_b, {})
    assert (a.key, a.labels, a.edges, a.fids) == (ra.key, ra.labels, ra.edges, ra.fids)
    assert a.to_dict() == ra.to_dict() and b.to_dict() == rb.to_dict()
    assert m == REF.isomorphism(ra, rb)


# --------------------------------------------------------------------- #
# mirrors of tests/test_partition.py
# --------------------------------------------------------------------- #
def brute_force(flow_ports):
    fids = list(flow_ports)
    parent = {f: f for f in fids}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, a in enumerate(fids):
        for b in fids[i + 1:]:
            if flow_ports[a] & flow_ports[b]:
                parent[find(a)] = find(b)
    groups = {}
    for f in fids:
        groups.setdefault(find(f), set()).add(f)
    return {frozenset(g) for g in groups.values()}


flow_ports_st = st.dictionaries(
    keys=st.integers(0, 40),
    values=st.frozensets(st.integers(0, 25), min_size=1, max_size=5),
    min_size=1, max_size=20,
)


@given(flow_ports_st)
@settings(max_examples=200, deadline=None)
def test_algorithm1_matches_transitive_closure(flow_ports):
    parts = port_partition.network_partitioner(flow_ports)
    assert {frozenset(p) for p in parts} == brute_force(flow_ports)
    assert [sorted(p) for p in parts] == \
        [sorted(p) for p in ref_partition.network_partitioner(flow_ports)]


@given(flow_ports_st, st.randoms(use_true_random=False))
@settings(max_examples=100, deadline=None)
def test_incremental_tracks_algorithm1_under_churn(flow_ports, rnd):
    """On the port, and step for step the reference's index."""
    idx, ref = port_partition.PartitionIndex(), ref_partition.PartitionIndex()
    fids = list(flow_ports)
    rnd.shuffle(fids)

    def same(a, b):
        assert a == b
        assert list(idx.flow_pid.items()) == list(ref.flow_pid.items())
        assert list(idx.port_pid.items()) == list(ref.port_pid.items())
    for fid in fids:
        same(idx.add_flow(fid, flow_ports[fid]), ref.add_flow(fid, flow_ports[fid]))
        idx.check_invariants()
    rnd.shuffle(fids)
    for fid in fids[: len(fids) // 2]:
        same(idx.remove_flow(fid), ref.remove_flow(fid))
        idx.check_invariants()


def test_merge_and_split(pkg):
    idx = pkg.PartitionIndex()
    idx.add_flow(1, frozenset({10, 11}))
    idx.add_flow(2, frozenset({20, 21}))
    assert len(idx.parts) == 2
    pid, merged = idx.add_flow(3, frozenset({11, 20}))
    assert len(merged) == 2 and len(idx.parts) == 1
    _, splits = idx.remove_flow(3)
    assert len(splits) == 2
    idx.check_invariants()


def test_port_exclusivity_invariant(pkg):
    idx = pkg.PartitionIndex()
    idx.add_flow(1, frozenset({1, 2}))
    idx.add_flow(2, frozenset({2, 3}))
    idx.add_flow(3, frozenset({7}))
    assert idx.flow_pid[1] == idx.flow_pid[2] != idx.flow_pid[3]
    idx.check_invariants()


# --------------------------------------------------------------------- #
# mirrors of tests/test_steady.py
# --------------------------------------------------------------------- #
def test_flat_signal_is_steady(pkg):
    assert pkg.steady.is_steady([5.0] * 16, 16, 0.05)


def test_sawtooth_within_theta_is_steady(pkg):
    saw = [10.0 + 0.2 * math.sin(i) for i in range(32)]
    assert pkg.steady.is_steady(saw, 32, 0.05)


def test_ramp_is_not_steady(pkg):
    assert not pkg.steady.is_steady([float(i) for i in range(1, 33)], 32, 0.05)


def test_short_history_not_steady(pkg):
    assert not pkg.steady.is_steady([5.0] * 7, 8, 0.05)


@given(st.lists(st.floats(1.0, 100.0), min_size=8, max_size=64))
@settings(max_examples=200, deadline=None)
def test_theorem2_bound_holds(window):
    """On the port, with the detector's verdict and estimate the
    reference's bit for bit."""
    theta = 0.08
    n = len(window)
    steady = port_steady.is_steady(window, n, theta)
    assert steady == ref_steady.is_steady(window, n, theta)
    assert port_steady.fluctuation(window) == ref_steady.fluctuation(window)
    if not steady:
        return
    r_hat = port_steady.rate_estimate(window, n)
    assert r_hat == ref_steady.rate_estimate(window, n)
    r_bar = sum(window) / n
    assert abs(r_hat - r_bar) / r_bar <= port_theory.rate_error_bound(theta) + 1e-12
    for r in window:
        assert abs(r - r_bar) / r_bar < theta / (1 - theta) + 1e-9


def test_theorem3_duration_bound(pkg):
    theta = 0.05
    rng = np.random.default_rng(0)
    fired = 0
    for _ in range(100):
        base = rng.uniform(1, 20)
        window = base * (1 + rng.uniform(-theta / 2.5, theta / 2.5, size=32))
        if not pkg.steady.is_steady(list(window), 32, theta):
            continue
        fired += 1
        r_hat = pkg.steady.rate_estimate(list(window), 32)
        r_bar = window.mean()
        err = abs(1 / r_hat - 1 / r_bar) * r_bar
        assert err < pkg.theory.duration_error_bound(theta)
    assert fired > 0


def test_batch_matches_scalar(pkg):
    rng = np.random.default_rng(1)
    hist = rng.uniform(1, 10, size=(17, 23))
    fl = pkg.steady.fluctuation_batch(hist)
    for i in range(17):
        assert abs(fl[i] - pkg.steady.fluctuation(list(hist[i]))) < 1e-12
    np.testing.assert_allclose(pkg.steady.rate_estimate_batch(hist), hist.mean(-1))
    mask = pkg.steady.steady_mask_batch(hist, 0.3)
    assert mask.shape == (17,)
    if pkg is PORT:
        assert np.array_equal(fl, ref_steady.fluctuation_batch(hist))
        assert np.array_equal(mask, ref_steady.steady_mask_batch(hist, 0.3))


def test_theta_guidance_monotone(pkg):
    t1 = pkg.theory.theta_guidance(2, 12.5e9, 10e-6)
    t2 = pkg.theory.theta_guidance(8, 12.5e9, 10e-6)
    assert t2 > t1
    assert pkg.theory.theta_guidance(2, 1.25e9, 10e-6) > t1
    assert t1 == REF.theory.theta_guidance(2, 12.5e9, 10e-6)


def test_l_guidance_covers_period(pkg):
    n = pkg.theory.l_guidance(2, 12.5e9, 10e-6, 64_000, sample_interval_s=4e-6)
    assert n >= 4
    t_c = pkg.theory.sawtooth_period_rtts(2, 12.5e9, 10e-6, 64_000) * 10e-6
    assert (n - 1) * 4e-6 >= 2 * t_c - 4e-6
    assert n == REF.theory.l_guidance(2, 12.5e9, 10e-6, 64_000, sample_interval_s=4e-6)


def test_batch_atol_dead_band_matches_scalar(pkg):
    atol = 2000.0
    hist = np.zeros((4, 16))
    hist[1] = 1500.0
    hist[2] = np.linspace(0, 1e6, 16)
    hist[3] = 5e5
    fb = pkg.steady.fluctuation_batch(hist, atol)
    for i in range(4):
        assert fb[i] == pytest.approx(pkg.steady.fluctuation(list(hist[i]), atol)), i
    mask = pkg.steady.steady_mask_batch(hist, 0.05, atol)
    assert mask.tolist() == [True, True, False, True]
    assert pkg.steady.fluctuation_batch(hist)[0] == pkg.steady.fluctuation(list(hist[0])) == 0.0


@given(st.lists(st.floats(0.0, 1e4), min_size=4, max_size=32), st.floats(0.0, 5e3))
@settings(max_examples=40, deadline=None)
def test_batch_matches_scalar_with_atol_property(row, atol):
    hist = np.asarray([row])
    fb = float(port_steady.fluctuation_batch(hist, atol)[0])
    fs = port_steady.fluctuation(row, atol)
    assert fs == ref_steady.fluctuation(row, atol) or (math.isnan(fs) and math.isnan(
        ref_steady.fluctuation(row, atol)))
    if math.isinf(fs):
        assert math.isinf(fb)
    else:
        assert fb == pytest.approx(fs, rel=1e-9, abs=1e-12)
