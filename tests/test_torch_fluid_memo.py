"""The fluid engine's solve of each distinct phase, once a run: a run's FCTs
and iteration time are those of a loop that solves every phase, the
phases with equal solve inputs are solved once and counted as
``fluid.solve_hits``, and phases that differ in a link's bandwidth or
delay are each solved.  The last test runs only on the card (``-m gpu``).

The file imports neither JAX nor the JAX package: the machine with the
card has none."""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.api import FlowSpec, Scenario, TopologySpec, run, training_scenario
from repro_torch.kernels.cca_step import fluid_scan
from repro_torch.net.fluid import FluidScenario, fluid_converged_rates
from repro_torch.net.topology import Topology

SCENARIOS = {
    "gpt@32": lambda: training_scenario(n_gpus=32, scale=1 / 256),
    "minimax-text-01@64": lambda: training_scenario(n_gpus=64, family="minimax-text-01",
                                                    scale=1 / 256),
}


def _dense_phases(scn, topo=None):
    """Each phase with flows: its flows and its ``FluidScenario``."""
    topo = topo or scn.build_topology()
    return [(ph, FluidScenario.from_flows(topo, [(f.fid, f.src, f.dst, f.size)
                                                 for f in ph.flows]))
            for ph in scn.build_phases() if ph.flows]


def distinct_solves(scn, topo=None) -> int:
    """The distinct solve inputs of ``scn``'s phases, told apart by the dense
    arrays a solve reads (the sizes aside, which it lifts to inf)."""
    return len({(fs.incidence.shape, fs.incidence.tobytes(), fs.line_rate.tobytes(),
                 fs.base_rtt.tobytes(), fs.link_bw.tobytes(), fs.ecn_k, fs.mss)
                for _, fs in _dense_phases(scn, topo)})


def per_phase(scn, device, topo=None):
    """The fluid engine's result as a loop that solves every phase: FCTs
    and the iteration time."""
    topo = topo or scn.build_topology()
    phases = scn.build_phases()
    fcts, done = {}, [0.0] * len(phases)
    for i, ph in enumerate(phases):
        start = max((done[d] for d in set(ph.deps)), default=0.0) + ph.compute
        if scn.kind == "flows":
            start += ph.flows[0].start if ph.flows else 0.0
        end = start
        if ph.flows:
            fs = FluidScenario.from_flows(topo, [(f.fid, f.src, f.dst, f.size)
                                                 for f in ph.flows])
            rates = fluid_converged_rates(fs, steps=200, device=device)["rates"].tolist()
            for f, rate in zip(ph.flows, rates):
                fcts[f.fid] = f.size / max(rate, 1e3)
                end = max(end, start + fcts[f.fid])
        done[i] = end
    return fcts, max(done)


def _profiled(fn):
    obs.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    table = obs.table()
    obs.reset()
    return out, table


def _calls(table, name):
    return sum(row.get("calls", row.get("count", 0))
               for (n, _), row in table.items() if n == name)


@pytest.mark.parametrize("name", SCENARIOS)
def test_run_is_a_solve_of_every_phase(name):
    scn = SCENARIOS[name]()
    res = run(scn, backend="fluid", device="cpu")
    fcts, iteration = per_phase(scn, "cpu")
    assert res.fcts == fcts
    assert res.iteration_time == iteration


@pytest.mark.parametrize("name", SCENARIOS)
def test_each_distinct_phase_is_solved_once_and_the_rest_are_hits(name):
    scn = SCENARIOS[name]()
    phases = sum(1 for ph in scn.build_phases() if ph.flows)
    distinct = distinct_solves(scn)
    assert 1 < distinct < phases
    _, table = _profiled(lambda: run(scn, backend="fluid", device="cpu"))
    for span in ("fluid.upload", "fluid.scan", "fluid.t_conv", "fluid.readback"):
        assert _calls(table, span) == distinct, span
    assert table[("fluid.solve_hits", None)] == {"count": phases - distinct}
    assert _calls(table, "fluid.route") == _calls(table, "fluid.incidence") == phases


def test_the_solves_last_one_run():
    """A second run solves its phases again: nothing outlives a run."""
    scn = SCENARIOS["gpt@32"]()
    distinct = distinct_solves(scn)

    def twice():
        return [run(scn, backend="fluid", device="cpu") for _ in range(2)]
    (a, b), table = _profiled(twice)
    assert _calls(table, "fluid.scan") == 2 * distinct
    assert a.fcts == b.fcts


def _two_leaves(change: str | None) -> Topology:
    """Two leaves of four hosts on two spines, every cable alike, except
    where ``change`` makes the cable from its leaf into host 6 faster
    ("bw") or longer ("delay")."""
    base = TopologySpec("clos", {"n_hosts": 8, "leaf_down": 4, "n_spines": 2}).build()
    bw, delay = base.link_bw.copy(), base.link_delay.copy()
    (down,) = np.flatnonzero((base.link_dst == 6) & (base.link_src >= base.n_hosts))
    if change == "bw":
        bw[down] *= 2
    elif change == "delay":
        delay[down] *= 3
    return Topology(name=f"two-leaves-{change}", n_hosts=base.n_hosts, n_nodes=base.n_nodes,
                    link_src=base.link_src, link_dst=base.link_dst, link_bw=bw,
                    link_delay=delay)


@pytest.mark.parametrize("change,solves", [(None, 1), ("bw", 2), ("delay", 2)])
def test_phases_that_differ_in_a_link_are_each_solved(monkeypatch, change, solves):
    """Two waves of the same pattern on either leaf (hosts 0 and 1 into 2,
    then 4 and 5 into 6, each within its leaf): one solve where the cables
    are alike, two where one of the second wave's cables differs in
    bandwidth or in delay."""
    topo = _two_leaves(change)
    flows = [FlowSpec(0, 0, 2, size=4e6), FlowSpec(1, 1, 2, size=2e6),
             FlowSpec(2, 4, 6, size=4e6, start=0.01), FlowSpec(3, 5, 6, size=3e6, start=0.01)]
    scn = Scenario("waves", TopologySpec("clos", {"n_hosts": 8, "leaf_down": 4,
                                                  "n_spines": 2}), flows=flows)
    monkeypatch.setattr(scn, "build_topology", lambda: topo)
    assert distinct_solves(scn, topo) == solves
    res, table = _profiled(lambda: run(scn, backend="fluid", device="cpu"))
    assert _calls(table, "fluid.scan") == solves
    assert _calls(table, "fluid.solve_hits") == 2 - solves
    fcts, iteration = per_phase(scn, "cpu", topo)
    assert res.fcts == fcts and res.iteration_time == iteration
    if change:
        assert res.fcts[2] != res.fcts[0]


@pytest.mark.gpu
def test_the_card_solves_each_distinct_phase_once():
    """gpt@128 at 1/64 on the card: one ``fluid_scan`` launch a distinct
    phase, and FCTs equal to a loop that solves every phase on the card
    (the scan runs in one block in a fixed order, so equal inputs give
    equal bits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the fluid scan runs only on the card")
    scn = training_scenario(n_gpus=128, scale=1 / 64)
    phases = sum(1 for ph in scn.build_phases() if ph.flows)
    distinct = distinct_solves(scn)
    assert distinct == 2 and phases == 28
    run(scn, backend="fluid")                          # builds and loads the kernel
    launches = fluid_scan.launches
    res = run(scn, backend="fluid")
    torch.cuda.synchronize()
    assert fluid_scan.launches == launches + distinct
    fcts, iteration = per_phase(scn, "cuda")
    assert res.fcts == fcts
    assert res.iteration_time == iteration
