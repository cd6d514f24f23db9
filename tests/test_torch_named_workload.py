"""A public model as a simulated training job: ``presets.resolve`` by name
(MiniMax-Text-01 at the Table-1 MoE layouts), the scenario that names it,
the CLI's ``minimax-text-01@N``, and its fluid iteration on the CPU against
the benchmark's plain reference within the benchmark cell's limits, and
the fluid engine's pause of the cyclic collector.

The ``gpt`` and ``moe`` families are held to the JAX package's presets."""
import gc
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest

from repro.workload import presets as ref_presets
from repro_torch.__main__ import _load_scenario
from repro_torch.api import Scenario, run, training_scenario
from repro_torch.api.engines import FluidEngine
from repro_torch.workload import presets
from repro_torch.workload.parallelism import ParallelismConfig
from simbench.harness import port_scenario
from simbench.reference.fluid import FluidReference
from simbench.reference.job import Job

REPO = pathlib.Path(__file__).resolve().parents[1]
NAME = "minimax-text-01"
CONFIG = json.loads((REPO / "simbench" / "configs" / "minimax-text-01-1024.json").read_text())
LIMITS = json.loads((REPO / "simbench" / "limits" / "minimax01-1024.fluid.json").read_text())
LAYOUTS = {64: (4, 2), 128: (4, 4), 256: (8, 4), 1024: (16, 8)}


@pytest.mark.parametrize("n_gpus", sorted(LAYOUTS))
def test_resolve_gives_the_model_at_the_table1_moe_layout(n_gpus):
    spec, par, ep = presets.resolve(NAME, n_gpus)
    dp, pp = LAYOUTS[n_gpus]
    assert par == ParallelismConfig(tp=8, dp=dp, pp=pp, ep=1) and par.world == n_gpus
    assert ep == min(presets.MOE_EP_DOMAIN, dp)
    assert (spec.n_layers, spec.d_model, spec.d_ff, spec.vocab) == (80, 6144, 9216, 200064)
    assert (spec.params, spec.active_params) == (456e9, 45.9e9)
    assert (spec.seq_len, spec.micro_batch, spec.dtype_bytes) == (4096, 1, 2)
    assert (spec.moe_experts, spec.moe_top_k, spec.moe_layer_every) == (32, 2, 1)
    assert spec.n_layers % pp == 0
    model = {k: v for k, v in CONFIG["model"].items() if k != "name"}
    assert all(getattr(spec, k) == v for k, v in model.items())


@pytest.mark.parametrize("n_gpus", [32, 512, 2048])
def test_resolve_refuses_a_gpu_count_off_the_table(n_gpus):
    with pytest.raises(ValueError, match=f"got {n_gpus}"):
        presets.resolve(NAME, n_gpus)


def test_an_unknown_family_lists_every_name():
    with pytest.raises(ValueError, match="have gpt, moe, minimax-text-01"):
        presets.resolve("llama", 64)
    assert presets.FAMILIES == ("gpt", "moe", NAME)


@pytest.mark.parametrize("family", ["gpt", "moe"])
@pytest.mark.parametrize("n_gpus", [32, 64, 128, 256, 512, 1024])
def test_the_families_resolve_as_the_jax_package(family, n_gpus):
    spec, par, ep = presets.resolve(family, n_gpus)
    rspec, rpar, rep = ref_presets.resolve(family, n_gpus)
    assert vars(spec) == vars(rspec)
    assert (par.tp, par.dp, par.pp, par.ep, ep) == (rpar.tp, rpar.dp, rpar.pp, rpar.ep, rep)


def test_the_scenario_names_the_model_and_round_trips():
    scn = training_scenario(n_gpus=1024, family=NAME, scale=1.0, straggler=(17, 1.3))
    assert scn.name == f"{NAME}@1024-hpcc-s1/1-straggler17x1.3"
    assert scn.topology.params["n_servers"] == 128
    back = Scenario.from_dict(scn.to_dict())
    assert back.to_dict() == scn.to_dict() and back.workload == scn.workload
    assert Scenario.from_json(scn.to_json()).workload.family == NAME
    moe = training_scenario(n_gpus=1024, moe=True, scale=1.0, straggler=(17, 1.3))
    assert moe.name != scn.name and moe.workload.family == "moe"
    with pytest.raises(ValueError, match="not both"):
        training_scenario(n_gpus=64, family=NAME, moe=True)


def test_the_cli_loads_the_named_preset():
    args = SimpleNamespace(cca="dctcp", scale="1/64")
    scn = _load_scenario(f"{NAME}@1024", args)
    w = scn.workload
    assert (w.family, w.n_gpus, w.cca, w.scale) == (NAME, 1024, "dctcp", 1 / 64)
    with pytest.raises(SystemExit, match="got 512"):
        _load_scenario(f"{NAME}@512", args)
    with pytest.raises(SystemExit, match="minimax-text-01@N"):
        _load_scenario("llama@64", args)


def test_the_cli_runs_the_named_preset():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "run", f"{NAME}@64",
                           "--backend", "analytic"], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert f"{NAME}@64-hpcc-s1/256" in proc.stdout and "iteration time:" in proc.stdout


def _config_at_64() -> dict:
    """The benchmark's configuration, at the 64-GPU row of the same table."""
    return {**CONFIG, "job": {"family": NAME, "n_gpus": 64},
            "parallelism": {**CONFIG["parallelism"], "dp": 4, "pp": 2, "ep_over_dp": 4},
            "fabric": {**CONFIG["fabric"], "n_servers": 8}}


@pytest.mark.parametrize("straggler", [None, (37, 1.42)])
def test_fluid_cpu_path_matches_the_reference_within_the_cells_limits(straggler):
    config = _config_at_64()
    job = Job(config)
    phases = job.phases(1.0, straggler)
    assert sum(f.tag.startswith("ep.") for ph in phases for f in ph.flows) > 0
    prog = run(port_scenario(config, straggler, "t"), backend="fluid", device="cpu")
    fcts, it_time, _ = FluidReference(job.topology(), config["fluid"]).iteration(phases)
    assert fcts.keys() == prog.fcts.keys()
    assert max(abs(prog.fcts[f] / fcts[f] - 1) for f in fcts) <= LIMITS["fluid_fct_gap"]
    assert abs(prog.iteration_time / it_time - 1) <= LIMITS["fluid_iter_gap"]


@pytest.mark.parametrize("enabled", [True, False])
def test_a_fluid_run_pauses_the_collector_and_leaves_it_as_it_was(monkeypatch, enabled):
    """The fluid engine runs with the cyclic collector off (its flows hold no
    reference cycle), gives the FCTs of a run with it on, and leaves it as
    it found it."""
    scn = training_scenario(n_gpus=32, family="moe", scale=1.0, straggler=(3, 1.2))
    seen = []
    build = Scenario.build_phases
    monkeypatch.setattr(Scenario, "build_phases",
                        lambda self: seen.append(gc.isenabled()) or build(self))
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        paused = run(scn, backend="fluid", device="cpu")
        assert seen == [False] and gc.isenabled() is enabled
        gc.enable()
        plain = FluidEngine.run.__wrapped__(FluidEngine(), scn, device="cpu")
    finally:
        (gc.enable if was else gc.disable)()
    assert seen[-1] is True
    assert paused.fcts == plain.fcts and paused.iteration_time == plain.iteration_time
