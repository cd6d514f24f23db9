"""The port's analytic engine against the JAX package's, end to end on the CPU.

The engine runs on the host in float64 through the exact solver in both
packages, so the bar is bit equality: the same FCTs, iteration time and
event count.  Its solves are also replayed through the dense float32
solver (``maxmin_rates_torch``), held to the exact rates at rtol 1e-4, the
reference's bar for its dense solvers (``tests/test_maxmin.py``)."""
import json

import numpy as np
import pytest
import torch

from repro.api import RunResult as RefRunResult
from repro.api import run as ref_run
from repro.api.scenario import training_scenario as ref_training_scenario
from repro_torch.api import (AnalyticSim, RunResult, Scenario, available_backends,
                             run, training_scenario)
from repro_torch.kernels.maxmin import (SOLVER_COUNTERS, maxmin_rates_arrays,
                                       maxmin_rates_torch, reset_counters)
from repro_torch.net.soa import FlowTable
from repro_torch.workload.driver import WorkloadDriver
from test_api import wave_scenario
from test_chaos import DEGRADE, MICE

STRAGGLER = {"kind": "straggler", "ranks": [0], "factor": 2.0}
CASES = {
    "wave": wave_scenario,
    "gpt@32": lambda: ref_training_scenario(n_gpus=32, scale=1.0),
    "moe@32": lambda: ref_training_scenario(n_gpus=32, moe=True, scale=1.0),
    "gpt@128": lambda: ref_training_scenario(n_gpus=128, scale=1.0),
    "straggler": lambda: ref_training_scenario(n_gpus=32, scale=1 / 256,
                                               chaos=[STRAGGLER]),
    "mice": lambda: wave_scenario().variant(name="mice", chaos=[MICE]),
}


def _port(ref_scn) -> Scenario:
    return Scenario.from_dict(ref_scn.to_dict())


def _assert_bit_equal(port, ref) -> None:
    assert list(port.fcts) == list(ref.fcts)
    assert port.fcts == ref.fcts                       # bitwise floats
    assert port.iteration_time == ref.iteration_time
    assert port.events_processed == ref.events_processed
    assert port.flow_bytes == ref.flow_bytes and port.tags == ref.tags
    assert port.backend == ref.backend == "analytic"
    assert port.scenario == ref.scenario


@pytest.mark.parametrize("name", list(CASES))
def test_run_bit_equal_to_reference(name):
    ref_scn = CASES[name]()
    ref = ref_run(ref_scn, backend="analytic")
    port = run(_port(ref_scn), backend="analytic")
    _assert_bit_equal(port, ref)
    if name == "mice":
        assert any(fid >= 1 << 20 for fid in port.fcts)


def test_straggler_slows_the_iteration():
    base = run(training_scenario(n_gpus=32, scale=1 / 256), backend="analytic")
    slow = run(_port(CASES["straggler"]()), backend="analytic")
    assert slow.iteration_time > base.iteration_time * 1.05


def test_link_chaos_refused_with_reference_message():
    ref_scn = wave_scenario().variant(name="deg", chaos=[DEGRADE])
    with pytest.raises(ValueError) as ref_err:
        ref_run(ref_scn, backend="analytic")
    with pytest.raises(ValueError) as port_err:
        run(_port(ref_scn), backend="analytic")
    assert str(port_err.value) == str(ref_err.value)
    assert "no port queues" in str(port_err.value)


@pytest.mark.parametrize("until", [0.0, 0.005, 0.021, 1.0])
def test_until_is_honoured_as_in_reference(until):
    ref = ref_run(wave_scenario(), backend="analytic", until=until)
    port = run(_port(wave_scenario()), backend="analytic", until=until)
    assert port.fcts == ref.fcts
    assert port.iteration_time == ref.iteration_time
    assert port.events_processed == ref.events_processed
    if until < 0.021:
        assert len(port.fcts) < len(wave_scenario().flows)


def test_runresult_json_roundtrip():
    r = run(_port(wave_scenario()), backend="analytic")
    d = r.to_dict()
    back = RunResult.from_dict(json.loads(json.dumps(d)))
    assert back.to_dict() == d
    assert back.fcts == r.fcts and back.iteration_time == r.iteration_time
    assert back.events_processed == r.events_processed
    # the same canonical form as the reference's record, bar the wall time
    ref = ref_run(wave_scenario(), backend="analytic").to_dict()
    assert {**d, "wall_time": 0} == {**RefRunResult.from_dict(ref).to_dict(), "wall_time": 0}


def test_engine_takes_no_device_and_needs_no_card(monkeypatch):
    scn = _port(wave_scenario())
    with pytest.raises(ValueError, match="does not accept opt 'device'"):
        run(scn, backend="analytic", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run(scn, backend="analytic").fcts
    assert available_backends() == ("analytic", "fluid", "packet", "wormhole")


class RecordingTable(FlowTable):
    """A FlowTable that keeps every solve's CSR paths."""
    __slots__ = ("solves",)

    def __init__(self) -> None:
        super().__init__()
        self.solves = []

    def solve_rates(self, fids, link_bw):
        fids = list(fids)
        _, links, off = self.csr(fids)
        self.solves.append((links, off))
        return super().solve_rates(fids, link_bw)


def _recorded_run(scn: Scenario):
    sim = AnalyticSim(scn.build_topology())
    sim.flow_table = RecordingTable()
    driver = WorkloadDriver(sim, scn.build_phases())
    sim.run()
    assert driver.finished
    return sim, driver


@pytest.mark.parametrize("moe", [False, True], ids=["gpt@32", "moe@32"])
def test_solves_replay_through_the_dense_solver(moe):
    """The hand-built run (simulator + driver) is the engine's run, and
    every solve it makes gives the exact rates through the dense solver."""
    scn = training_scenario(n_gpus=32, moe=moe, scale=1.0)
    sim, driver = _recorded_run(scn)
    reset_counters()
    res = run(scn, backend="analytic")
    assert SOLVER_COUNTERS["invocations"] == len(sim.flow_table.solves) >= 5
    assert {fid: r.fct for fid, r in sim.results.items()} == res.fcts
    assert sim.events_processed == res.events_processed
    assert driver.iteration_time == res.iteration_time
    solves = sim.flow_table.solves
    bw = scn.build_topology().link_bw
    for links, off in solves:
        exact = maxmin_rates_arrays(links, off, bw)
        for impl in ("kernel", "ref"):
            got = maxmin_rates_torch(links, off, bw, impl=impl, device="cpu")
            np.testing.assert_allclose(got, exact, rtol=1e-4)
