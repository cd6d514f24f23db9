"""Top-level entry points: run one scenario, sweep many, compare backends.

The port has no campaign layer yet: ``run``, ``run_many`` and ``compare``
call the engines directly, in this process, and keep nothing.  They follow
the reference's anonymous in-memory campaign all the same: identical
``(scenario, backend, opts)`` triples within one call are simulated once,
and the defaults are the reference's (the ``packet`` oracle, compared with
``wormhole``).  The fluid engine runs on the CUDA card unless
``device="cpu"`` is passed; so does the learned engine's MLP.  Packet,
wormhole, hybrid and analytic run on the host.
"""
from __future__ import annotations

from repro_torch.api.engines import Engine, get_engine
from repro_torch.api.results import Comparison, RunResult
from repro_torch.api.scenario import Scenario
from repro_torch.api.store import run_key
from repro_torch.core.memo import SimDB

__all__ = ["Comparison", "compare", "run", "run_many"]


def run(scenario: Scenario, backend: str = "packet", **opts) -> RunResult:
    """Evaluate one scenario on one backend."""
    engine = get_engine(backend)
    engine.check_opts(opts)
    return engine.run(scenario, **opts)


def run_many(scenarios: list[Scenario], backend: str = "packet",
             shared_db: bool = False, db: SimDB | None = None,
             workers: int = 1, **opts) -> list[RunResult]:
    """Evaluate a sweep; results keep scenario order, and identical
    scenarios in one call are simulated once (the later ones share the
    first one's result), keyed by the reference's ``run_key``; an opt with
    no canonical JSON form (a live SimDB handle) keys its own run.

    ``shared_db=True`` (wormhole only) threads one memo DB through the runs
    in order, so transients memoized in run 1 fast-forward runs 2..N; pass
    ``db=`` to bring your own (``SimDB.load_or_new``/``save`` persist it).
    Without a DB, an engine with a batched path evaluates the sweep in one
    call (the fluid engine's padded batch, which shares one ``dt`` across
    the sweep).  ``workers`` other than 1 is refused: the port's engines run
    in this process."""
    if workers != 1:
        raise ValueError(
            f"run_many(workers={workers}): the port evaluates sweeps in "
            "this process (batched on the device); process fan-out is not "
            "ported")
    engine = get_engine(backend)
    engine.check_opts(opts)
    wants_db = shared_db or db is not None
    if wants_db and backend != "wormhole":
        raise ValueError(
            f"shared_db/db are wormhole features, not {backend!r}")
    if wants_db and db is None:
        db = SimDB()
    scenarios = list(scenarios)
    keys = [run_key(s, backend, opts) for s in scenarios]
    first: dict[str, int] = {}
    for i, k in enumerate(keys):
        first.setdefault(k, i)
    todo = list(first.values())
    results: list[RunResult | None] = [None] * len(scenarios)
    if db is None and type(engine).run_batch is not Engine.run_batch:
        if todo:
            batch = engine.run_batch([scenarios[i] for i in todo], **opts)
            for i, result in zip(todo, batch):
                results[i] = result
    else:
        for i in todo:
            run_opts = dict(opts)
            if db is not None:
                run_opts["db"] = db
            results[i] = engine.run(scenarios[i], **run_opts)
    return [results[first[k]] for k in keys]


def compare(scenario: Scenario, backends=("packet", "wormhole"),
            baseline: str | None = None,
            backend_opts: dict | None = None, **opts) -> Comparison:
    """Run ``scenario`` on every backend and tabulate speedups + FCT errors
    against ``baseline`` (default: the first backend).  ``**opts`` go to
    every backend; ``backend_opts={"fluid": {"device": "cpu"}}`` sends opts
    to one backend only, overriding the shared ones."""
    backends = tuple(backends)
    baseline = baseline if baseline is not None else backends[0]
    if baseline not in backends:
        raise ValueError(
            f"baseline {baseline!r} not in backends {backends}")
    backend_opts = dict(backend_opts or {})
    unknown = set(backend_opts) - set(backends)
    if unknown:
        raise ValueError(
            f"backend_opts for {sorted(unknown)} but backends are "
            f"{backends}")
    results = {b: run(scenario, backend=b, **{**opts, **backend_opts.get(b, {})})
               for b in dict.fromkeys(backends)}
    return Comparison(scenario=scenario.name, baseline=baseline,
                      results=results)
