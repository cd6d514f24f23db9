"""The port's packet-level oracle (``packet`` backend), its congestion
controls and ``compare()`` against the JAX package's, on the CPU.

Both packages run the same host-side discrete-event simulator in float64,
so the bar is equality: the same FCTs, event counts, iteration time and
RTT samples, compared with ``==``.  The reference's own tests of these
modules (``tests/test_event_loop.py``, ``tests/test_cca.py`` and the packet
rows of ``tests/test_chaos.py``) are mirrored here at the same sizes and
run on both packages (the ``pkg`` parameter), beside the parity tests."""
import dataclasses
import inspect
import types

import pytest
import torch

import repro.api as ref_api
import repro.api.engines as ref_engines
import repro.core.steady as ref_steady
import repro.net.cca as ref_cca
import repro.net.chaos as ref_chaos
import repro.net.flows as ref_flows
import repro.net.packet_sim as ref_packet_sim
import repro.net.topology as ref_topology
import repro_torch.api as port_api
import repro_torch.api.engines as port_engines
import repro_torch.core.steady as port_steady
import repro_torch.net.cca as port_cca
import repro_torch.net.chaos as port_chaos
import repro_torch.net.flows as port_flows
import repro_torch.net.packet_sim as port_packet_sim
import repro_torch.net.topology as port_topology
from test_api import wave_scenario
from test_chaos import DEGRADE, HOT_LINK, MICE


def _pkg(api, steady, cca, chaos, flows, packet_sim, topology, fluid_opts):
    return types.SimpleNamespace(
        run=api.run, Scenario=api.Scenario, fluctuation=steady.fluctuation,
        make_cca=cca.make_cca, CHAOS_FID_BASE=chaos.CHAOS_FID_BASE,
        FlowSpec=flows.FlowSpec, PacketSim=packet_sim.PacketSim,
        leaf_spine_clos=topology.leaf_spine_clos, fluid_opts=fluid_opts)


PKGS = {
    "reference": _pkg(ref_api, ref_steady, ref_cca, ref_chaos, ref_flows,
                      ref_packet_sim, ref_topology, {}),
    # the port's fluid engine runs on the card unless told otherwise
    "port": _pkg(port_api, port_steady, port_cca, port_chaos, port_flows,
                 port_packet_sim, port_topology, {"device": "cpu"}),
}
REF, PORT = PKGS["reference"], PKGS["port"]


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def port_scenario(ref_scn):
    """The reference scenario as the port's (the same JSON)."""
    return port_api.Scenario.from_dict(ref_scn.to_dict())


def assert_same_run(port, ref) -> None:
    """Two RunResults of the same simulation, bar the wall clock."""
    assert port.backend == ref.backend and port.scenario == ref.scenario
    assert list(port.fcts) == list(ref.fcts)
    assert port.fcts == ref.fcts                         # bitwise floats
    assert port.flow_bytes == ref.flow_bytes and port.tags == ref.tags
    assert port.iteration_time == ref.iteration_time
    assert port.events_processed == ref.events_processed
    assert port.kernel_report == ref.kernel_report
    assert port.extras == ref.extras


# the scenarios of benchmarks/ci_regression.py, at its scales, and a
# degrade_link scenario on the quickstart fabric
def quickstart():
    from examples.quickstart import make_scenario
    return make_scenario()


CI_SCENARIOS = {
    "quickstart": quickstart,
    "gpt32": lambda: ref_api.training_scenario(n_gpus=32, cca="hpcc", scale=1 / 256),
    "moe32": lambda: ref_api.training_scenario(n_gpus=32, moe=True, cca="hpcc",
                                               scale=1 / 512),
    "gpt32tree": lambda: ref_api.training_scenario(n_gpus=32, cca="hpcc", scale=1 / 256,
                                                   collective="tree"),
    "gpt32chaos": lambda: ref_api.training_scenario(n_gpus=32, cca="hpcc", scale=1 / 256, chaos=[
        {"kind": "mice", "seed": 7, "rate": 20000.0, "size": 4e4, "duration": 0.002},
        {"kind": "straggler", "seed": 3, "count": 2, "factor": 1.5}]),
}
PARITY_SCENARIOS = {**CI_SCENARIOS,
                    "degrade": lambda: wave_scenario().variant(name="deg", chaos=[DEGRADE])}


# --------------------------------------------------------------------- #
# the packet backend, end to end, against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(PARITY_SCENARIOS))
def test_packet_run_equal_to_reference(name):
    ref_scn = PARITY_SCENARIOS[name]()
    ref = ref_api.run(ref_scn, backend="packet")
    port = port_api.run(port_scenario(ref_scn), backend="packet")
    assert_same_run(port, ref)
    assert port.kernel_report is None


def test_ci_packet_counter_equal_to_reference():
    """``quickstart/packet/events_processed`` of benchmarks/ci_regression.py,
    computed by both packages (the wormhole counters are in
    tests/test_torch_wormhole.py)."""
    ref = ref_api.run(quickstart(), backend="packet").events_processed
    port = port_api.run(port_scenario(quickstart()), backend="packet").events_processed
    assert port == ref


def test_record_rtt_and_until_as_in_reference():
    ref_scn = wave_scenario(0.25)
    for opts in ({"record_rtt": (0, 5)}, {"until": 0.021}):
        ref = ref_api.run(ref_scn, backend="packet", **opts)
        port = port_api.run(port_scenario(ref_scn), backend="packet", **opts)
        assert_same_run(port, ref)
        d, rd = port.to_dict(), ref.to_dict()
        assert {**d, "wall_time": 0} == {**rd, "wall_time": 0}
    assert set(port_api.RunResult.from_dict(port.to_dict()).fcts) == set(port.fcts)


def test_packet_and_wormhole_take_no_device(monkeypatch):
    scn = port_scenario(wave_scenario(0.25))
    for backend in ("packet", "wormhole"):
        with pytest.raises(ValueError, match="does not accept opt 'device'"):
            port_api.run(scn, backend=backend, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = port_api.run(scn, backend="packet")
    assert r.fcts and "device" not in r.extras


@pytest.mark.parametrize("backend", ["packet", "wormhole"])
def test_sharded_loop_opts_raise_naming_the_roadmap(backend):
    scn = port_scenario(wave_scenario(0.25))
    for opts in ({"parallel": "partitions"}, {"intra_workers": 2},
                 {"parallel": "partitions", "intra_workers": 4, "validate": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
            port_api.run(scn, backend=backend, **opts)
    # the reference's refusals of misuse stay as they are
    for opts in ({"validate": True}, {"parallel": "lanes"}):
        with pytest.raises(ValueError) as ref_err:
            ref_api.run(wave_scenario(0.25), backend=backend, **opts)
        with pytest.raises(ValueError) as port_err:
            port_api.run(scn, backend=backend, **opts)
        assert str(port_err.value) == str(ref_err.value)
    assert port_api.run(scn, backend=backend, parallel="none").fcts == \
        port_api.run(scn, backend=backend).fcts


# --------------------------------------------------------------------- #
# entry points: defaults, compare(), run_many
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("fn", ["run", "run_many", "compare"])
def test_entry_point_defaults_are_the_references(fn):
    ref_sig = inspect.signature(getattr(ref_api, fn)).parameters
    port_sig = inspect.signature(getattr(port_api, fn)).parameters
    key = "backends" if fn == "compare" else "backend"
    assert port_sig[key].default == ref_sig[key].default
    assert port_sig[key].default == (("packet", "wormhole") if fn == "compare" else "packet")
    if fn == "run_many":
        for name in ("shared_db", "db", "workers"):
            assert port_sig[name].default == ref_sig[name].default


def _rows_without_wall(cmp):
    return [{k: v for k, v in row.items() if k not in ("wall", "wall_speedup")}
            for row in cmp.rows()]


def test_compare_rows_equal_to_reference():
    backends = ("packet", "wormhole", "analytic")
    ref = ref_api.compare(quickstart(), backends=backends)
    port = port_api.compare(port_scenario(quickstart()), backends=backends)
    assert isinstance(port, port_api.Comparison)
    assert (port.scenario, port.baseline) == (ref.scenario, ref.baseline) == \
        ("quickstart", "packet")
    assert list(port.results) == list(ref.results) == list(backends)
    assert _rows_without_wall(port) == _rows_without_wall(ref)
    for b in backends:
        assert_same_run(port[b], ref[b])
    text = port.format()
    assert "wormhole" in text and "fct err%" in text and str(port) == text
    row = port.rows()[0]
    assert row["event_speedup"] > 1.0 and row["fct_err_mean"] < 0.01


def test_compare_semantics_follow_the_reference():
    ref_scn = wave_scenario(0.25)
    scn = port_scenario(ref_scn)
    for kw in ({"backends": ("packet",), "baseline": "wormhole"},
               {"backends": ("packet", "analytic"), "backend_opts": {"wormhole": {}}}):
        with pytest.raises(ValueError) as ref_err:
            ref_api.compare(ref_scn, **kw)
        with pytest.raises(ValueError) as port_err:
            port_api.compare(scn, **kw)
        assert str(port_err.value) == str(ref_err.value)
    # an explicit baseline, shared opts, and a per-backend override of them
    kw = dict(backends=("analytic", "packet"), baseline="packet", until=0.005,
              backend_opts={"analytic": {"until": 1.0}})
    ref = ref_api.compare(ref_scn, **kw)
    port = port_api.compare(scn, **kw)
    assert port.baseline == "packet" and list(port.results) == ["analytic", "packet"]
    for b in ("analytic", "packet"):
        assert_same_run(port[b], ref[b])
    assert port["analytic"].fcts == port_api.run(scn, backend="analytic", until=1.0).fcts
    assert port["packet"].fcts == port_api.run(scn, backend="packet", until=0.005).fcts
    assert _rows_without_wall(port) == _rows_without_wall(ref)
    # an opt one backend does not take fails as in the reference
    with pytest.raises(ValueError, match="does not accept opt 'until'"):
        port_api.compare(scn, backends=("packet", "fluid"), until=0.005,
                         backend_opts={"fluid": {"device": "cpu"}})


def test_run_many_collapses_identical_runs_as_the_reference():
    ref_scns = [wave_scenario(0.25, name="a"), wave_scenario(0.5, name="b"),
                wave_scenario(0.25, name="a")]
    ref = ref_api.run_many(ref_scns, backend="packet")
    port = port_api.run_many([port_scenario(s) for s in ref_scns], backend="packet")
    assert port[2] is port[0] and port[1] is not port[0]
    for p, r in zip(port, ref):
        assert_same_run(p, r)
    for backend in ("packet", "analytic"):
        for kw in ({"shared_db": True}, {"db": port_api.SimDB()}):
            with pytest.raises(ValueError, match="wormhole features"):
                port_api.run_many([port_scenario(ref_scns[0])], backend=backend, **kw)


# --------------------------------------------------------------------- #
# mirrors of tests/test_event_loop.py, on both packages
# --------------------------------------------------------------------- #
def _sim(pkg, **kw):
    return pkg.PacketSim(pkg.leaf_spine_clos(16, leaf_down=4, n_spines=2), **kw)


def test_until_preserves_same_timestamp_tie_order(pkg):
    sim = _sim(pkg)
    log = []
    sim.call_at(5e-3, lambda now: log.append("first"))
    sim.call_at(5e-3, lambda now: log.append("second"))
    sim.run(until=1e-3)
    assert log == []
    sim.run()
    assert log == ["first", "second"]


def _until_scenario(pkg):
    sim = _sim(pkg)
    for i in range(6):
        sim.add_flow(pkg.FlowSpec(i, i, 8 + i % 2, 4e5, (i % 3) * 1e-4, "dctcp"))
    sim.record_rtt_fids = {0, 3}
    return sim


def test_until_resume_matches_uninterrupted_run(pkg):
    one = _until_scenario(pkg)
    one.run()
    two = _until_scenario(pkg)
    for until in (2e-4, 5e-4, 9e-4):
        two.run(until=until)
    two.run()
    assert one.all_done() and two.all_done()
    assert {f: r.fct for f, r in one.results.items()} == \
           {f: r.fct for f, r in two.results.items()}
    assert one.events_processed == two.events_processed
    for fid in (0, 3):
        assert one.flows[fid].rtt_samples == two.flows[fid].rtt_samples


def _timeout_run(pkg, force: bool):
    topo = pkg.leaf_spine_clos(4, leaf_down=4, n_spines=1, bw=1e8)
    sim = pkg.PacketSim(topo, sample_interval=2e-5, ecn_k=1e12)
    sim.add_flow(pkg.FlowSpec(0, 0, 1, 3e5, 0.0, "dctcp"))
    if force:
        sim.run(until=1e-3)
        f = sim.flows[0]
        assert not f.done and f.inflight > 0
        f.last_ack_t = -1.0
    sim.run()
    assert sim.all_done()
    return sim


def test_timeout_voids_superseded_inflight_events(pkg):
    base = _timeout_run(pkg, force=False)
    assert base.timeouts == 0
    hit = _timeout_run(pkg, force=True)
    assert hit.timeouts >= 1
    f = hit.flows[0]
    assert f.delivered == pytest.approx(f.spec.size)
    assert hit.results[0].fct > base.results[0].fct


def _deep_buffer_run(pkg):
    topo = pkg.leaf_spine_clos(16, leaf_down=16, n_spines=1, bw=1e8)
    sim = pkg.PacketSim(topo, sample_interval=1e-5, ecn_k=1e12, buffer_bytes=1e8)
    for i in range(1, 16):
        sim.add_flow(pkg.FlowSpec(i, i, 0, 2e6, 0.0, "dctcp"))
    sim.add_flow(pkg.FlowSpec(99, 1, 0, 2e3, 4e-3, "dctcp"))
    sim.run()
    return sim


def test_timeout_trips_organically_with_deep_buffers(pkg):
    sim = _deep_buffer_run(pkg)
    assert sim.all_done()
    assert sim.timeouts >= 1
    late = sim.flows[99]
    assert late.delivered == pytest.approx(late.spec.size)
    assert sim.results[99].fct * 1e8 >= late.spec.size


def _sim_state(sim):
    return dict(fcts={f: (r.start, r.fct) for f, r in sim.results.items()},
                events=sim.events_processed, hops=sim.packet_hop_events,
                timeouts=sim.timeouts, seq=sim._seq, now=sim.now,
                busy=list(sim.busy_until), txbytes=list(sim.port_txbytes),
                rtt={fid: list(f.rtt_samples) for fid, f in sim.flows.items()},
                rate_hist={fid: list(f.rate_hist) for fid, f in sim.flows.items()})


@pytest.mark.parametrize("case", ["until", "timeout", "deep_buffers"])
def test_event_loop_state_equal_to_reference(case):
    """The event loop's whole observable state after the mirrored runs:
    every counter, port and per-flow history."""
    def drive(pkg):
        if case == "until":
            sim = _until_scenario(pkg)
            for until in (2e-4, 5e-4, 9e-4):
                sim.run(until=until)
            sim.run()
            return sim
        if case == "timeout":
            return _timeout_run(pkg, force=True)
        return _deep_buffer_run(pkg)
    assert _sim_state(drive(PORT)) == _sim_state(drive(REF))


def test_generic_loop_equal_to_the_specialised_one():
    """A subclass that overrides a packet handler runs the generic loop,
    event for event the same as the inlined one, as in the reference."""
    class Generic(port_packet_sim.PacketSim):
        __slots__ = ()

        def _do_send(self, t, fid, epoch):
            port_packet_sim.PacketSim._do_send(self, t, fid, epoch)

    def drive(cls, topo_mod, flows_mod):
        sim = cls(topo_mod.leaf_spine_clos(16, leaf_down=4, n_spines=2))
        for i in range(6):
            sim.add_flow(flows_mod.FlowSpec(i, i, 8 + i % 2, 4e5, (i % 3) * 1e-4, "hpcc"))
        sim.run()
        return sim
    generic = drive(Generic, port_topology, port_flows)
    assert _sim_state(generic) == _sim_state(drive(port_packet_sim.PacketSim,
                                                   port_topology, port_flows))
    assert _sim_state(generic) == _sim_state(drive(ref_packet_sim.PacketSim,
                                                   ref_topology, ref_flows))


# --------------------------------------------------------------------- #
# mirrors of tests/test_cca.py, on both packages
# --------------------------------------------------------------------- #
CCAS = ["dctcp", "dcqcn", "timely", "hpcc"]


def incast(pkg, cca, n=2, size=3e6, window=16):
    topo = pkg.leaf_spine_clos(8, leaf_down=4, n_spines=2)
    sim = pkg.PacketSim(topo, window=window)
    for i in range(n):
        sim.add_flow(pkg.FlowSpec(i, i, 5, size, 0.0, cca))
    sim.run()
    return sim


@pytest.mark.parametrize("cca", CCAS)
def test_convergence_and_stability(pkg, cca):
    sim = incast(pkg, cca, size=4e6, window=256)
    assert sim.all_done()
    hist = list(sim.flows[0].rate_hist)
    assert len(hist) >= 24
    best = min(pkg.fluctuation(hist[i:i + 8]) for i in range(len(hist) - 8))
    assert best < 0.5, f"{cca} never stabilised (best window fluctuation {best:.2f})"


@pytest.mark.parametrize("cca", CCAS)
def test_fair_share_utilisation(pkg, cca):
    sim = incast(pkg, cca)
    bw = 12.5e9
    fct = max(r.finish for r in sim.results.values())
    agg = 2 * 3e6 / fct
    assert 0.3 * bw <= agg <= 1.01 * bw, f"{cca}: aggregate {agg/1e9:.2f} GB/s"
    fcts = [sim.results[i].fct for i in (0, 1)]
    assert abs(fcts[0] - fcts[1]) / max(fcts) < 0.35


@pytest.mark.parametrize("cca", CCAS)
def test_single_flow_reaches_line_rate(pkg, cca):
    topo = pkg.leaf_spine_clos(8, leaf_down=4, n_spines=2)
    sim = pkg.PacketSim(topo)
    sim.add_flow(pkg.FlowSpec(0, 0, 5, 4e6, 0.0, cca))
    sim.run()
    ideal = 4e6 / 12.5e9
    assert sim.results[0].fct < 3.5 * ideal


def test_conservation_every_byte_delivered(pkg):
    sim = incast(pkg, "dctcp", n=2, size=2.5e6)
    for f in sim.flows.values():
        assert f.done
        assert abs(f.delivered - f.spec.size) < 1e-6


def test_ecn_keeps_queues_bounded(pkg):
    sim = incast(pkg, "dctcp", n=4, size=2e6)
    assert sim.all_done()
    assert all(r.fct > 0 for r in sim.results.values())


def _cca_state(c):
    return {k: getattr(c, k) for k in dir(c)
            if not k.startswith("__") and not callable(getattr(c, k))}


@pytest.mark.parametrize("cca", CCAS)
def test_cca_state_machines_equal_to_reference(cca):
    """Each CCA fed the same ACK stream (marks, RTTs, INT utilisations and
    a loss) holds the reference's state after every ACK, and an incast
    through it ends with the reference's FCTs and rate histories."""
    ref, port = (p.make_cca(cca, 12.5e9, 8e-6) for p in (REF, PORT))
    assert type(port).__name__ == type(ref).__name__
    assert port.uses_int == ref.uses_int
    t = 0.0
    for i in range(400):
        t += 1e-6 * (1 + i % 3)
        ecn = i % 7 == 0
        rtt = 8e-6 * (1 + (i % 11) / 10)
        pkt = 0.0 if i % 97 == 96 else port_cca.MTU
        infos = [m.INTInfo(0.5 + (i % 13) / 10) if c.uses_int else None
                 for m, c in ((ref_cca, ref), (port_cca, port))]
        ref.on_ack(t, pkt, ecn or pkt == 0.0, rtt, infos[0])
        port.on_ack(t, pkt, ecn or pkt == 0.0, rtt, infos[1])
        assert _cca_state(port) == _cca_state(ref), i
        assert (port.rate(), port.cwnd()) == (ref.rate(), ref.cwnd())
    assert port_cca.MTU == ref_cca.MTU
    a, b = incast(PORT, cca), incast(REF, cca)
    assert {f: r.fct for f, r in a.results.items()} == {f: r.fct for f, r in b.results.items()}
    assert [list(f.rate_hist) for f in a.flows.values()] == \
        [list(f.rate_hist) for f in b.flows.values()]
    assert a.events_processed == b.events_processed


# --------------------------------------------------------------------- #
# mirrors of the packet rows of tests/test_chaos.py, on both packages
# --------------------------------------------------------------------- #
def _wave(pkg, *args, **kw):
    return pkg.Scenario.from_dict(wave_scenario(*args, **kw).to_dict())


def test_empty_chaos_is_bit_identical(pkg):
    base = pkg.run(_wave(pkg), backend="packet")
    empty = pkg.run(_wave(pkg).variant(name="waves", chaos=[]), backend="packet")
    assert empty.fcts == base.fcts
    assert empty.events_processed == base.events_processed


def test_chaos_runs_are_reproducible(pkg):
    scn = _wave(pkg).variant(name="rep", chaos=[MICE, DEGRADE])
    a = pkg.run(scn, backend="packet")
    b = pkg.run(pkg.Scenario.from_json(scn.to_json()), backend="packet")
    assert a.fcts == b.fcts and a.events_processed == b.events_processed


def test_mice_seen_identically_by_all_backends(pkg):
    scn = _wave(pkg).variant(name="mice", chaos=[MICE])
    pkt = pkg.run(scn, backend="packet")
    mice_fids = {f for f in pkt.fcts if f >= pkg.CHAOS_FID_BASE}
    assert mice_fids
    for backend in ("wormhole", "analytic", "fluid"):
        opts = pkg.fluid_opts if backend == "fluid" else {}
        r = pkg.run(scn, backend=backend, **opts)
        assert set(r.fcts) == set(pkt.fcts)
    wh = pkg.run(scn, backend="wormhole")
    assert wh.fct_errors_vs(pkt).mean() < 0.01


def test_degrade_and_flap_stretch_fcts(pkg):
    base = pkg.run(_wave(pkg), backend="packet")
    deg = pkg.run(_wave(pkg).variant(name="deg", chaos=[DEGRADE]), backend="packet")
    assert deg.fcts[0] > base.fcts[0] * 1.5
    flap = pkg.run(_wave(pkg).variant(name="flap", chaos=[
        {"kind": "link_flap", "link": HOT_LINK, "t_down": 0.001,
         "t_up": 0.002}]), backend="packet")
    assert flap.fcts[0] > deg.fcts[0] > base.fcts[0]
    assert flap.fcts[4] == pytest.approx(base.fcts[4], rel=1e-6)
    rest = pkg.run(_wave(pkg).variant(name="rest", chaos=[
        {**DEGRADE, "t_end": 0.002}]), backend="packet")
    assert base.fcts[0] < rest.fcts[0] <= deg.fcts[0]


def test_link_chaos_out_of_range_and_flow_level_refusals(pkg):
    bad = _wave(pkg).variant(name="oob", chaos=[
        {"kind": "degrade_link", "link": 10_000, "t": 0.001, "factor": 0.5}])
    with pytest.raises(ValueError, match="out of range"):
        pkg.run(bad, backend="packet")
    scn = _wave(pkg).variant(name="ref", chaos=[DEGRADE])
    # the flow-level backends both packages have (``learned`` is not ported)
    for backend in ("analytic", "fluid"):
        opts = pkg.fluid_opts if backend == "fluid" else {}
        with pytest.raises(ValueError, match="no port queues"):
            pkg.run(scn, backend=backend, **opts)
    with pytest.raises(ValueError, match="intra_workers=1"):
        pkg.run(scn, backend="packet", parallel="partitions", intra_workers=2)
    assert pkg.run(_wave(pkg).variant(name="ok", chaos=[MICE]),
                   backend="analytic") is not None


@pytest.mark.parametrize("chaos", ["degrade", "flap", "mice"])
def test_chaos_runs_equal_to_reference(chaos):
    inj = {"degrade": [DEGRADE, MICE],
           "flap": [{"kind": "link_flap", "link": HOT_LINK, "t_down": 0.001,
                     "t_up": 0.002}],
           "mice": [MICE]}[chaos]
    ref_scn = wave_scenario().variant(name=chaos, chaos=inj)
    assert_same_run(port_api.run(port_scenario(ref_scn), backend="packet"),
                    ref_api.run(ref_scn, backend="packet"))


def test_link_set_writes_the_simulators_own_lists():
    """Link chaos retargets ``_link_bw``/``busy_until`` in place: the hot
    loop hoists those lists, so they must stay the simulator's lists."""
    scn = port_scenario(wave_scenario(0.25))
    sim = port_packet_sim.PacketSim(scn.build_topology())
    bw, busy = sim._link_bw, sim.busy_until
    assert type(bw) is list and type(busy) is list
    plan = port_chaos.ChaosPlan.parse([DEGRADE])
    assert plan.has_link_events
    plan.install(sim)
    sim.busy_until[HOT_LINK] = 2e-3
    sim.run()
    assert sim._link_bw is bw and sim.busy_until is busy
    assert bw[HOT_LINK] == float(scn.build_topology().link_bw[HOT_LINK]) * 0.25
    # the queued backlog is re-expressed at the new drain rate
    assert busy[HOT_LINK] == pytest.approx(1e-3 + (2e-3 - 1e-3) * 4)


def test_engine_option_names_are_the_references():
    for name in ("PacketEngine", "WormholeEngine"):
        ref_cls, port_cls = getattr(ref_engines, name), getattr(port_engines, name)
        assert port_cls.option_names == ref_cls.option_names
        assert port_cls.uses_db == ref_cls.uses_db
    assert [f.name for f in dataclasses.fields(port_flows.FlowResult)] == \
        [f.name for f in dataclasses.fields(ref_flows.FlowResult)]
