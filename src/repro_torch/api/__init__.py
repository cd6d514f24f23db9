"""The port's experiment layer: declarative scenarios in, structured
results out, through engines that run on the CUDA card.

    from repro_torch.api import run, run_many, training_scenario

    scn = training_scenario(n_gpus=128, scale=1.0)
    result = run(scn, backend="fluid")                 # on the card
    result = run(scn, backend="fluid", device="cpu")   # plain versions, CPU
    result = run(scn, backend="analytic")              # on the host, exact

Scenarios serialize to the same JSON as the reference's, so a scenario
file runs unchanged on either package.
"""
from repro_torch.api.analytic import AnalyticSim
from repro_torch.api.engines import (AnalyticEngine, Engine, available_backends,
                                     get_engine, register_engine)
from repro_torch.api.results import RunResult, jsonify
from repro_torch.api.runner import run, run_many
from repro_torch.api.scenario import (Scenario, TopologySpec, WorkloadSpec,
                                      training_scenario)
from repro_torch.net.flows import FlowSpec

__all__ = [
    "Scenario", "TopologySpec", "WorkloadSpec", "FlowSpec",
    "training_scenario",
    "Engine", "register_engine", "get_engine", "available_backends",
    "AnalyticEngine", "AnalyticSim",
    "RunResult", "jsonify",
    "run", "run_many",
]
