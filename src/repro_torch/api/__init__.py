"""The port's experiment layer: declarative scenarios in, structured
results out, through engines that run on the CUDA card or on the host.

    from repro_torch.api import compare, run, run_many, training_scenario

    scn = training_scenario(n_gpus=128, scale=1.0)
    result = run(scn, backend="wormhole")              # on the host
    result = run(scn, backend="fluid")                 # on the card
    result = run(scn, backend="fluid", device="cpu")   # plain versions, CPU
    table = compare(scn, backends=("packet", "wormhole", "fluid"))
    sweep = run_many([scn.variant(name="b", size_scale=1.05), scn],
                     backend="wormhole", shared_db=True)

Scenarios serialize to the same JSON as the reference's, so a scenario
file runs unchanged on either package, and so does a saved ``SimDB``.
"""
from repro_torch.api.analytic import AnalyticSim
from repro_torch.api.engines import (AnalyticEngine, Engine, PacketEngine,
                                     WormholeEngine, available_backends,
                                     get_engine, register_engine)
from repro_torch.api.results import Comparison, RunResult, jsonify, summarize_pair
from repro_torch.api.runner import compare, run, run_many
from repro_torch.api.scenario import (Scenario, TopologySpec, WorkloadSpec,
                                      training_scenario)
from repro_torch.core.memo import SimDB, SimDBMismatch
from repro_torch.net.flows import FlowSpec

__all__ = [
    "Scenario", "TopologySpec", "WorkloadSpec", "FlowSpec",
    "training_scenario",
    "Engine", "register_engine", "get_engine", "available_backends",
    "AnalyticEngine", "AnalyticSim", "PacketEngine", "WormholeEngine",
    "RunResult", "jsonify", "summarize_pair",
    "run", "run_many", "compare", "Comparison",
    "SimDB", "SimDBMismatch",
]
