"""The port's experiment layer: declarative scenarios in, structured
results out, through engines that run on the CUDA card or on the host.

    from repro_torch.api import compare, run, run_many, training_scenario

    scn = training_scenario(n_gpus=128, scale=1.0)
    result = run(scn, backend="wormhole")              # on the host
    result = run(scn, backend="wormhole", parallel="partitions",
                 intra_workers=2)                      # sharded, same result
    result = run(scn, backend="hybrid", fidelity="flow")   # on the host
    result = run(scn, backend="fluid")                 # on the card
    result = run(scn, backend="fluid", device="cpu")   # plain versions, CPU
    result = run(scn, backend="learned", params=path)  # MLP on the card
    table = compare(scn, backends=("packet", "wormhole", "hybrid", "fluid"))
    sweep = run_many([scn.variant(name="b", size_scale=1.05), scn],
                     backend="wormhole", shared_db=True)

Scenarios serialize to the same JSON as the reference's, so a scenario
file runs unchanged on either package, and so does a saved ``SimDB``.
"""
from repro_torch.api.analytic import AnalyticSim
from repro_torch.api.engines import (AnalyticEngine, Engine, HybridEngine,
                                     PacketEngine, WormholeEngine,
                                     available_backends, get_engine,
                                     register_engine)
from repro_torch.api.results import Comparison, RunResult, jsonify, summarize_pair
from repro_torch.api.runner import compare, run, run_many
from repro_torch.api.scenario import (Scenario, TopologySpec, WorkloadSpec,
                                      training_scenario)
from repro_torch.api.store import run_key, scenario_fingerprint
from repro_torch.learned.engine import LearnedEngine
from repro_torch.core.memo import SimDB, SimDBMismatch
from repro_torch.net.flows import FlowSpec
from repro_torch.net.hybrid_sim import FIDELITIES, HybridConfig

__all__ = [
    "Scenario", "TopologySpec", "WorkloadSpec", "FlowSpec",
    "training_scenario",
    "Engine", "register_engine", "get_engine", "available_backends",
    "AnalyticEngine", "AnalyticSim", "PacketEngine", "WormholeEngine",
    "HybridEngine", "HybridConfig", "FIDELITIES", "LearnedEngine",
    "RunResult", "jsonify", "summarize_pair",
    "run", "run_many", "compare", "Comparison",
    "run_key", "scenario_fingerprint",
    "SimDB", "SimDBMismatch",
]
