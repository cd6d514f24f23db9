"""Top-level entry points: run one scenario, sweep many, compare backends.

Copy of ``repro.api.runner``, which the port may not import: thin
wrappers over an anonymous in-memory
:class:`~repro_torch.api.campaign.Campaign` — ``run``/``run_many``/``compare``
each open a process-lifetime campaign (nothing written to disk), so they
inherit campaign semantics (identical ``(scenario, backend, opts)``
triples within one call dedup to a single simulation) while keeping the
historical flat-function signatures.  For durable, resumable sessions use
``Campaign.open(path)`` directly.

Two orthogonal parallelism axes (paper §6.1):

* **across scenarios** — ``run_many(..., workers=N)`` dispatches the sweep
  over a process pool; with ``shared_db=True`` one SimDB threads through
  the runs (transients memoized in run 1 fast-forward runs 2..N), and a
  durable ``Campaign.open(dir)`` makes that cache survive across
  sessions.  Each worker runs
  against a snapshot of the shared DB and ships back the delta of newly
  memoized transients, which the parent merges (deduplicating repeats),
  so even a cold parallel sweep converges to one warm DB.  For the fluid
  backend a serial sweep pads into one batch instead (one ``fluid_scan``
  launch per phase for the whole sweep).
* **inside one run** — ``run(..., parallel="partitions",
  intra_workers=M)`` executes the packet/wormhole backends on the
  partition-sharded event loop (``repro_torch.net.sharded_sim``): per-partition
  event lanes advance independently between global barriers and heavy
  UNSTEADY lanes fan out to a worker pool, with results identical to the
  serial loop.  Both axes compose: ``run_many(..., workers=N,
  parallel="partitions", intra_workers=M)``.

The fluid engine runs on the CUDA card unless ``device="cpu"`` is passed;
so does the learned engine's MLP, and so do they in each spawn worker.
``device`` is an engine opt, so it is part of the run key: a CPU record
and a card record never share one.  Packet, wormhole, hybrid and analytic
run on the host.
"""
from __future__ import annotations

from repro_torch.api.campaign import Campaign
from repro_torch.api.engines import get_engine
from repro_torch.api.results import Comparison, RunResult
from repro_torch.api.scenario import Scenario
from repro_torch.core.memo import SimDB

__all__ = ["Comparison", "compare", "run", "run_many"]


def run(scenario: Scenario, backend: str = "packet", **opts) -> RunResult:
    """Evaluate one scenario on one backend (an anonymous single-run
    campaign underneath)."""
    return Campaign.in_memory().submit(scenario, backend=backend,
                                       **opts).result


def run_many(scenarios: list[Scenario], backend: str = "packet",
             shared_db: bool = False, db: SimDB | None = None,
             workers: int = 1, **opts) -> list[RunResult]:
    """Evaluate a sweep (an anonymous campaign sweep underneath; identical
    scenarios in one call are simulated once).

    ``shared_db=True`` (wormhole only) threads one memo DB through the runs
    in order; pass ``db=`` to bring your own (e.g. persisted knowledge from
    an earlier sweep — an explicit ``SimDB.load_or_new``/``save`` pair, or
    better, a durable ``Campaign.open(dir)``, which owns and persists its
    SimDB with no plumbing at all).  ``workers=N``
    fans the scenarios out over N processes; results keep scenario order,
    and each scenario is evaluated exactly as a standalone ``run()`` —
    identical to the serial path for per-scenario engines
    (packet/wormhole/analytic are deterministic), while batching engines
    (fluid's padded batch, which also shares one ``dt`` across the batch)
    use their per-scenario path instead.  With a DB, every worker starts
    from the same initial snapshot (no mid-sweep warm-up, unlike the
    serial path) and the parent merges every worker's insert delta back,
    deduplicating transients memoized by more than one worker — a cold
    parallel sweep still converges to one warm DB."""
    engine = get_engine(backend)           # unknown backends fail up front
    engine.check_opts(opts)
    wants_db = shared_db or db is not None
    if wants_db and backend != "wormhole":
        raise ValueError(
            f"shared_db/db are wormhole features, not {backend!r}")
    if wants_db and db is None:
        db = SimDB()
    camp = Campaign.in_memory(db=db if wants_db else None)
    return camp.sweep(scenarios, backend=backend, workers=workers, **opts)


def compare(scenario: Scenario, backends=("packet", "wormhole"),
            baseline: str | None = None,
            backend_opts: dict | None = None, **opts) -> Comparison:
    """Run ``scenario`` on every backend and tabulate speedups + FCT errors
    against ``baseline`` (default: the first backend).  ``**opts`` go to
    every backend; ``backend_opts={"fluid": {"device": "cpu"}}`` sends
    opts to one backend only (the CLI's ``--opt backend:key=value``)."""
    return Campaign.in_memory().compare(scenario, backends=backends,
                                        baseline=baseline,
                                        backend_opts=backend_opts, **opts)
