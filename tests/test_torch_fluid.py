"""The port's fluid engine against the JAX package's, end to end on the CPU.

The same scenarios (or the same numpy arrays) go through
``repro.net.fluid_jax`` / ``repro.api`` and through ``repro_torch`` with
``device="cpu"``.  The bar is rtol 1e-4, the reference's own
kernel-vs-inline bar (``tests/test_kernels.py``): both sides are float32
and differ only in summation order inside the incidence products."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import available_backends as ref_available_backends
from repro.api import run as ref_run
from repro.api import run_many as ref_run_many
from repro.api.scenario import training_scenario as ref_training_scenario
from repro.kernels.steady_scan.ref import steady_scan_ref
from repro.net import fluid_jax
from repro.net.topology import leaf_spine_clos as ref_clos
from repro_torch.api import Scenario, available_backends, run, run_many
from repro_torch.kernels.cca_step import fluid_scan, fluid_scan_plain
from repro_torch.kernels.steady_scan import steady_scan, steady_scan_plain
from repro_torch.net import fluid
from repro_torch.net.topology import leaf_spine_clos
from test_api import wave_scenario

RTOL = 1e-4
MICE = {"kind": "mice", "seed": 7, "rate": 2000.0, "size": 4e4,
        "duration": 0.004}
DEGRADE = {"kind": "degrade_link", "link": 25, "t": 0.001, "factor": 0.25}
CLOS_FLOWS = [(0, 0, 5, 4e6), (1, 1, 5, 4e6)]


def _clos_scenarios():
    ref = fluid_jax.FluidScenario.from_flows(ref_clos(8, leaf_down=4, n_spines=2),
                                             CLOS_FLOWS)
    port = fluid.FluidScenario.from_flows(leaf_spine_clos(8, leaf_down=4, n_spines=2),
                                          CLOS_FLOWS)
    return ref, port


def _assert_fcts_close(port_res, ref_res):
    assert set(port_res.fcts) == set(ref_res.fcts)
    for fid, fct in ref_res.fcts.items():
        assert port_res.fcts[fid] == pytest.approx(fct, rel=RTOL), fid
    assert port_res.iteration_time == pytest.approx(ref_res.iteration_time, rel=RTOL)
    assert port_res.flow_bytes == ref_res.flow_bytes and port_res.tags == ref_res.tags
    assert port_res.events_processed == ref_res.events_processed


def test_fluid_run_histories_match_reference():
    ref_fs, _ = _clos_scenarios()
    dt, steps = float(np.median(ref_fs.base_rtt)), 300
    arrays = (ref_fs.incidence, ref_fs.line_rate, ref_fs.base_rtt,
              np.full(2, np.inf), ref_fs.link_bw)
    ref = fluid_jax.fluid_run(*(jnp.asarray(x) for x in arrays), dt, steps)
    port = fluid.fluid_run(*(torch.tensor(x, dtype=torch.float32) for x in arrays),
                           dt, steps)
    assert port["rate_hist"].shape == (steps, 2)
    assert port["queue_hist"].shape == (steps, ref_fs.incidence.shape[1])
    np.testing.assert_allclose(port["rate_hist"].numpy(), np.asarray(ref["rate_hist"]),
                               rtol=RTOL)
    # queues start at 0 and drain to 0 on uncongested links: atol is one
    # byte on queues of up to 64 * ecn_k = 4 MB
    np.testing.assert_allclose(port["queue_hist"].numpy(), np.asarray(ref["queue_hist"]),
                               rtol=RTOL, atol=1.0)


def _scan_arrays(F, L, batch=(), seed=3):
    """A random 0/1 incidence (every flow on link 0, so it congests) and
    flow sizes that finish some flows within the run, as float32 numpy."""
    rng = np.random.default_rng(seed)
    M = (rng.random((*batch, F, L)) < 0.3).astype(np.float32)
    M[..., 0] = 1.0
    f = lambda lo, hi, n: rng.uniform(lo, hi, (*batch, n)).astype(np.float32)
    return dict(M=M, line=np.full((*batch, F), 12.5e9, np.float32),
                rtt0=f(5e-6, 2e-5, F), size=f(1e5, 6e5, F), bw=f(2e9, 12.5e9, L))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_fluid_scan_plain_matches_reference_fluid_run(use_kernel, batch):
    """The plain scan from the reference's initial state against the JAX
    ``fluid_run`` (its inline step, and its Pallas step in interpret mode),
    at the bar of ``test_fluid_run_histories_match_reference``."""
    dt, steps = 1e-5, 200
    a = _scan_arrays(20, 12, batch)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    line, bw = t["line"], t["bw"]
    port = fluid_scan_plain(t["M"], line, t["rtt0"], t["size"], bw, line * t["rtt0"],
                            torch.ones_like(line), torch.zeros_like(line),
                            torch.zeros_like(bw), dt=dt, steps=steps)
    assert port["rate_hist"].shape == (*batch, steps, 20)
    assert port["queue_hist"].shape == (*batch, steps, 12)
    for i in np.ndindex(*batch):
        ref = fluid_jax.fluid_run(*(jnp.asarray(a[k][i]) for k in ("M", "line", "rtt0",
                                                                     "size", "bw")),
                                  dt, steps, use_kernel=use_kernel)
        for k, r, atol in (("rate_hist", "rate_hist", 0.0), ("queue_hist", "queue_hist", 1.0),
                           ("rates", "rates", 0.0), ("delivered", "delivered", 1.0),
                           ("queues", "queues", 1.0)):
            np.testing.assert_allclose(port[k][i].numpy(), np.asarray(ref[r]),
                                       rtol=RTOL, atol=atol, err_msg=k)
    done = port["delivered"] >= t["size"]
    assert done.any() and not done.all()             # some flows finished, not all


@pytest.mark.parametrize("batch", [(), (3,)])
def test_fluid_scan_window_matches_reference_detector(batch):
    """``fluid_scan(..., window=w)`` on the CPU against the JAX
    ``steady_scan_ref`` over the JAX ``fluid_run``'s rate history, at the
    histories' bar (atol 1e-6 on the fluctuation, as
    ``test_fluid_converged_rates_match_reference_and_fair_share``)."""
    dt, steps, w = 1e-5, 200, 20
    a = _scan_arrays(20, 12, batch, seed=5)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    line, bw = t["line"], t["bw"]
    port = fluid_scan(t["M"], line, t["rtt0"], t["size"], bw, line * t["rtt0"],
                      torch.ones_like(line), torch.zeros_like(line), torch.zeros_like(bw),
                      dt=dt, steps=steps, window=w)
    fl, mn = steady_scan_plain(port["rate_hist"].transpose(-1, -2), w)
    assert torch.equal(port["win_mean"], mn) and torch.equal(port["win_fluct"], fl)
    for i in np.ndindex(*batch):
        ref = fluid_jax.fluid_run(*(jnp.asarray(a[k][i]) for k in ("M", "line", "rtt0",
                                                                     "size", "bw")), dt, steps)
        ref_fl, ref_mn = steady_scan_ref(jnp.asarray(ref["rate_hist"]).T, w)
        np.testing.assert_allclose(port["win_mean"][i].numpy(), np.asarray(ref_mn), rtol=RTOL)
        np.testing.assert_allclose(port["win_fluct"][i].numpy(), np.asarray(ref_fl),
                                   rtol=RTOL, atol=1e-6)


def test_fluid_run_returns_the_window_stats_only_when_asked():
    a = {k: torch.from_numpy(v) for k, v in _scan_arrays(16, 9).items()}
    args = (a["M"], a["line"], a["rtt0"], a["size"], a["bw"], 1e-5, 50)
    assert "win_mean" not in fluid.fluid_run(*args)
    out = fluid.fluid_run(*args, window=10)
    assert set(out) == {"rates", "delivered", "queues", "rate_hist", "queue_hist",
                        "win_mean", "win_fluct"}
    fl, mn = steady_scan_plain(out["rate_hist"].T, 10)
    assert torch.equal(out["win_mean"], mn) and torch.equal(out["win_fluct"], fl)


def test_fluid_run_on_cpu_is_the_plain_scan():
    a = {k: torch.from_numpy(v) for k, v in _scan_arrays(16, 9, (2,)).items()}
    launches = fluid_scan.launches
    out = fluid.fluid_run(a["M"], a["line"], a["rtt0"], a["size"], a["bw"], 1e-5, 50)
    assert fluid_scan.launches == launches
    want = fluid_scan_plain(a["M"], a["line"], a["rtt0"], a["size"], a["bw"],
                            a["line"] * a["rtt0"], torch.ones_like(a["line"]),
                            torch.zeros_like(a["line"]), torch.zeros_like(a["bw"]),
                            dt=1e-5, steps=50)
    assert set(out) == {"rates", "delivered", "queues", "rate_hist", "queue_hist"}
    for k, v in out.items():
        assert torch.equal(v, want[k]), k


def test_fluid_converged_rates_match_reference_and_fair_share():
    ref_fs, port_fs = _clos_scenarios()
    ref = fluid_jax.fluid_converged_rates(ref_fs, steps=300)
    port = fluid.fluid_converged_rates(port_fs, steps=300, device="cpu")
    np.testing.assert_allclose(port["rates"].numpy(), ref["rates"], rtol=RTOL)
    np.testing.assert_allclose(port["fluct"].numpy(), ref["fluct"], rtol=RTOL, atol=1e-6)
    assert port["t_conv"] == ref["t_conv"]
    np.testing.assert_allclose(port["hist"].numpy(), ref["hist"], rtol=RTOL)
    # the reference test's physics bars (tests/test_kernels.py)
    rates = port["rates"].numpy()
    np.testing.assert_allclose(rates.sum(), 12.5e9, rtol=0.15)
    np.testing.assert_allclose(rates[0], rates[1], rtol=0.1)


def test_fluid_scenario_takes_reference_arrays_as_they_are():
    """Every phase of moe@32: the reference's FluidScenario, handed to the
    port unchanged, converges to the reference's rates."""
    scn = ref_training_scenario(n_gpus=32, moe=True)
    topo = scn.build_topology()
    for ph in scn.build_phases()[:6]:
        if not ph.flows:
            continue
        fs = fluid_jax.FluidScenario.from_flows(
            topo, [(f.fid, f.src, f.dst, f.size) for f in ph.flows])
        ref = fluid_jax.fluid_converged_rates(fs, steps=200)
        port = fluid.fluid_converged_rates(fs, steps=200, device="cpu")
        np.testing.assert_allclose(port["rates"].numpy(), ref["rates"], rtol=RTOL)
        assert port["t_conv"] == ref["t_conv"]


@pytest.mark.parametrize("moe", [False, True], ids=["gpt@128", "moe@128"])
def test_fluid_scenario_arrays_at_128_gpus_equal_the_reference(moe):
    """Every phase with flows of a 128-GPU job: the port's FluidScenario on
    the port's topology holds the reference's arrays, dtype and all."""
    ref_scn = ref_training_scenario(n_gpus=128, moe=moe)
    ref_topo = ref_scn.build_topology()
    port_topo = Scenario.from_dict(ref_scn.to_dict()).build_topology()
    phases = [ph for ph in ref_scn.build_phases() if ph.flows]
    assert phases
    for ph in phases:
        flows = [(f.fid, f.src, f.dst, f.size) for f in ph.flows]
        ref = fluid_jax.FluidScenario.from_flows(ref_topo, flows)
        port = fluid.FluidScenario.from_flows(port_topo, flows)
        for name in ("incidence", "line_rate", "base_rtt", "size", "link_bw"):
            a, b = getattr(port, name), getattr(ref, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), (ph.name, name)
        assert (port.ecn_k, port.mss) == (ref.ecn_k, ref.mss)


def test_fluid_scenario_arrays_at_1024_gpus_equal_the_reference():
    """``minimax-text-01@1024``'s first all-to-all phase (its last stage's,
    no PP beside it), first PP phase and first DP phase, routed as arrays
    on the port's topology: the reference's arrays, dtype and all, from
    its topology's flow-by-flow routes."""
    from repro.net.topology import TOPOLOGY_BUILDERS as REF_BUILDERS
    from repro_torch.api import training_scenario
    scn = training_scenario(n_gpus=1024, family="minimax-text-01", scale=1.0)
    phases = scn.build_phases()

    def first(has, lacks=None):
        return next(ph for ph in phases
                    if any(f.tag.startswith(has) for f in ph.flows)
                    and not any(lacks and f.tag.startswith(lacks) for f in ph.flows))
    picked = [first("ep.", "pp."), first("pp."), first("dp.")]
    assert len({ph.name for ph in picked}) == 3
    ref_topo = REF_BUILDERS[scn.topology.kind](**scn.topology.params)
    port_topo = scn.build_topology()
    assert port_topo.n_hosts == 1024
    for ph in picked:
        flows = [(f.fid, f.src, f.dst, f.size) for f in ph.flows]
        ref = fluid_jax.FluidScenario.from_flows(ref_topo, flows)
        port = fluid.FluidScenario.from_flows(port_topo, flows)
        for name in ("incidence", "line_rate", "base_rtt", "size", "link_bw"):
            a, b = getattr(port, name), getattr(ref, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), (ph.name, name)
        assert (port.ecn_k, port.mss) == (ref.ecn_k, ref.mss)


@pytest.mark.parametrize("family,n_gpus", [("gpt", 32), ("minimax-text-01", 64)])
def test_fluid_scenario_from_compact_paths_equals_the_reference(family, n_gpus):
    """``FluidScenario.from_flows``, built from the compact ``FluidPaths``
    the fluid engine keys its solves on, holds the reference's arrays for
    every phase with flows, dtype and all."""
    from repro.net.topology import TOPOLOGY_BUILDERS as REF_BUILDERS
    from repro_torch.api import training_scenario
    scn = training_scenario(n_gpus=n_gpus, family=family, scale=1 / 256)
    ref_topo = REF_BUILDERS[scn.topology.kind](**scn.topology.params)
    port_topo = scn.build_topology()
    phases = [ph for ph in scn.build_phases() if ph.flows]
    assert len(phases) > 1
    for ph in phases:
        flows = [(f.fid, f.src, f.dst, f.size) for f in ph.flows]
        ref = fluid_jax.FluidScenario.from_flows(ref_topo, flows)
        port = fluid.FluidScenario.from_flows(port_topo, flows)
        for name in ("incidence", "line_rate", "base_rtt", "size", "link_bw"):
            a, b = getattr(port, name), getattr(ref, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), (ph.name, name)
        assert (port.ecn_k, port.mss) == (ref.ecn_k, ref.mss)


def test_fluid_scenario_arrays_equal_the_reference_on_uneven_links():
    """Bandwidths and delays drawn per link, so a path's rate and delay
    depend on which links it takes and in which order they are summed."""
    from repro.net.topology import Topology as RefTopology
    from repro.net.topology import fat_tree as ref_fat_tree
    from repro_torch.net.topology import Topology
    base = ref_fat_tree(4)
    rng = np.random.default_rng(11)
    arrays = dict(name="uneven", n_hosts=base.n_hosts, n_nodes=base.n_nodes,
                  link_src=base.link_src, link_dst=base.link_dst,
                  link_bw=rng.uniform(1e9, 5e10, base.n_links),
                  link_delay=rng.uniform(1e-7, 1e-5, base.n_links))
    ref_topo, port_topo = RefTopology(**arrays), Topology(**arrays)
    hosts = range(base.n_hosts)
    flows = [(i, s, d, 1e6 + i) for i, (s, d) in
             enumerate((s, d) for s in hosts for d in hosts if s != d)]
    ref = fluid_jax.FluidScenario.from_flows(ref_topo, flows)
    port = fluid.FluidScenario.from_flows(port_topo, flows)
    assert {len(port_topo.route(s, d, fid)) for fid, s, d, _ in flows} == {2, 4, 6}
    for name in ("incidence", "line_rate", "base_rtt", "size", "link_bw"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_fluid_scenario_refuses_a_flow_to_itself_as_the_reference():
    topo, ref_topo = leaf_spine_clos(8, leaf_down=4, n_spines=2), ref_clos(8, leaf_down=4,
                                                                           n_spines=2)
    flows = [(0, 0, 5, 4e6), (1, 3, 3, 4e6)]
    with pytest.raises(ValueError):
        fluid_jax.FluidScenario.from_flows(ref_topo, flows)
    with pytest.raises(ValueError):
        fluid.FluidScenario.from_flows(topo, flows)


def test_sweep_converged_rates_match_reference():
    topo = ref_clos(16, leaf_down=4, n_spines=2)
    flow_sets = [CLOS_FLOWS, [(0, 0, 12, 1e6), (1, 1, 12, 1e6), (2, 2, 13, 1e6)],
                 [(0, 3, 9, 5e5)]]
    scns = [fluid_jax.FluidScenario.from_flows(topo, fl) for fl in flow_sets]
    ref = fluid_jax.sweep_converged_rates(scns, dt=1e-5, steps=150)
    launches = steady_scan.launches
    port = fluid.sweep_converged_rates(scns, dt=1e-5, steps=150, device="cpu")
    assert steady_scan.launches == launches
    assert [len(p) for p in port] == [len(fl) for fl in flow_sets]
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), r, rtol=RTOL)


@pytest.mark.parametrize("name", ["wave", "gpt@32", "moe@32"])
def test_run_matches_reference_fluid_backend(name):
    ref_scn = {"wave": wave_scenario,
               "gpt@32": lambda: ref_training_scenario(n_gpus=32),
               "moe@32": lambda: ref_training_scenario(n_gpus=32, moe=True)}[name]()
    ref = ref_run(ref_scn, backend="fluid")
    port = run(Scenario.from_dict(ref_scn.to_dict()), backend="fluid", device="cpu")
    _assert_fcts_close(port, ref)
    assert port.backend == "fluid" and port.scenario == ref.scenario
    assert port.extras["device"] == "cpu"


def test_run_options_match_reference():
    ref_scn = wave_scenario()
    ref = ref_run(ref_scn, backend="fluid", steps=80, dt=2e-5)
    port = run(Scenario.from_dict(ref_scn.to_dict()), backend="fluid", steps=80, dt=2e-5,
               device="cpu")
    _assert_fcts_close(port, ref)
    with pytest.raises(ValueError, match="does not accept opt 'stpes'"):
        run(Scenario.from_dict(ref_scn.to_dict()), backend="fluid", device="cpu", stpes=80)


def test_run_many_matches_reference_batch():
    """Mirrors tests/test_api.py's vmapped-batch test, and holds the port's
    padded batch to the reference's."""
    ref_scns = [wave_scenario(s, name=f"f{s:g}") for s in (1.0, 2.0)]
    ref = ref_run_many(ref_scns, backend="fluid", dt=1e-5, steps=100)
    scns = [Scenario.from_dict(s.to_dict()) for s in ref_scns]
    port = run_many(scns, backend="fluid", dt=1e-5, steps=100, device="cpu")
    assert [r.scenario for r in port] == ["f1", "f2"]
    for p, r, scn in zip(port, ref, scns):
        assert set(p.fcts) == {f.fid for f in scn.flows}
        _assert_fcts_close(p, r)
        for fid, rate in r.extras["rates"].items():
            assert p.extras["rates"][fid] == pytest.approx(rate, rel=RTOL)
    for fid, fct in port[0].fcts.items():
        assert port[1].fcts[fid] == pytest.approx(2 * fct, rel=0.05)


def test_run_many_workload_scenarios_fall_back_to_run():
    ref_scn = ref_training_scenario(n_gpus=16)
    ref = ref_run(ref_scn, backend="fluid", steps=60)
    (port,) = run_many([Scenario.from_dict(ref_scn.to_dict())], backend="fluid", steps=60,
                       device="cpu")
    _assert_fcts_close(port, ref)


def test_link_chaos_refused_and_mice_seen_as_in_reference():
    scn = Scenario.from_dict(wave_scenario().variant(name="deg", chaos=[DEGRADE]).to_dict())
    with pytest.raises(ValueError, match="no port queues"):
        run(scn, backend="fluid", device="cpu")
    with pytest.raises(ValueError, match="no port queues"):
        run_many([scn], backend="fluid", device="cpu")
    ref_scn = wave_scenario().variant(name="mice", chaos=[MICE])
    ref = ref_run(ref_scn, backend="fluid")
    port = run(Scenario.from_dict(ref_scn.to_dict()), backend="fluid", device="cpu")
    assert any(fid >= 1 << 20 for fid in port.fcts)
    _assert_fcts_close(port, ref)


def test_run_without_device_refuses_to_leave_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scn = Scenario.from_dict(wave_scenario().to_dict())
    with pytest.raises(RuntimeError, match="no.*CUDA|none is available"):
        run(scn, backend="fluid")
    with pytest.raises(RuntimeError, match="none is available"):
        run_many([scn], backend="fluid")
    ref_fs, port_fs = _clos_scenarios()
    with pytest.raises(RuntimeError, match="none is available"):
        fluid.fluid_converged_rates(port_fs)


def test_run_many_refuses_workers_and_registry_is_the_ports_own():
    """(Named when the port refused ``workers``.)  ``workers=2`` fans the
    sweep over spawn workers that resolve ``fluid`` in the port's registry:
    each scenario as a stand-alone ``run()``, equal to the serial runs at
    the card-vs-CPU bar."""
    scns = [Scenario.from_dict(wave_scenario(s, name=f"w{s:g}").to_dict())
            for s in (1.0, 1.2, 1.4)]
    par = run_many(scns, backend="fluid", workers=2, device="cpu")
    assert [r.scenario for r in par] == [s.name for s in scns]
    for p, s in zip(par, scns):
        serial = run(s, backend="fluid", device="cpu")
        assert list(p.fcts) == list(serial.fcts)
        for fid, fct in serial.fcts.items():
            assert p.fcts[fid] == pytest.approx(fct, rel=RTOL)
        assert p.iteration_time == pytest.approx(serial.iteration_time, rel=RTOL)
        assert p.extras["device"] == "cpu"
    assert available_backends() == ref_available_backends() == (
        "analytic", "fluid", "hybrid", "learned", "packet", "wormhole")
    with pytest.raises(ValueError, match="unknown backend 'ns3'"):
        run(scns[0], backend="ns3", device="cpu")
