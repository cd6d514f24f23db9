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

Durable and resumable, as the reference's: a Campaign is a named on-disk
session whose runs commit as they finish, whose identical submissions are
served from its store, and whose SimDB stays warm across sessions; a
store server (``python -m repro_torch serve``) shares one store between
hosts.  The same API drives the CLI, ``python -m repro_torch
{run,sweep,compare,serve,ls,show,rm,backends,fit,lint}``.

    from repro_torch.api import Campaign
    with Campaign.open("experiments/gpt128") as camp:
        camp.sweep(variants, backend="fluid")              # on the card
        camp.sweep(variants, backend="wormhole", workers=2)

Scenarios serialize to the same JSON as the reference's, so a scenario
file runs unchanged on either package, and so does a saved ``SimDB``.
Run records have the reference's format and keys, but a campaign
directory or a store server belongs to one package: neither opens the
other's, so a ``fluid`` or ``learned`` result of one is never served as
the other's cache hit.
"""
from repro_torch.api.analytic import AnalyticSim
from repro_torch.api.campaign import Campaign, RunEvent, RunHandle
from repro_torch.api.engines import (AnalyticEngine, Engine, HybridEngine,
                                     PacketEngine, WormholeEngine,
                                     available_backends, get_engine,
                                     register_engine)
from repro_torch.api.results import Comparison, RunResult, jsonify, summarize_pair
from repro_torch.api.runner import compare, run, run_many
from repro_torch.api.scenario import (Scenario, TopologySpec, WorkloadSpec,
                                      training_scenario)
from repro_torch.api.serve import RemoteBackend, StoreServer
from repro_torch.api.store import (RunStore, StoreBackend, run_key,
                                   scenario_fingerprint)
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
    "Campaign", "RunEvent", "RunHandle",
    "RunStore", "StoreBackend", "run_key", "scenario_fingerprint",
    "RemoteBackend", "StoreServer",
    "SimDB", "SimDBMismatch",
]
