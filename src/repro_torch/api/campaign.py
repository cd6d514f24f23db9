"""Durable, resumable, observable experiment sessions (paper §5/§6.1).

The paper's headline numbers come from *sweeps*: warm SimDB runs collapse
~500k-event baselines to a handful of events precisely because memoized
state outlives a single ``run()`` call.  A :class:`Campaign` makes that
state — and the results themselves — a named on-disk session instead of
whatever happened to be alive in one process:

    from repro_torch.api import Campaign, training_scenario

    camp = Campaign.open("experiments/cca-sweep")
    handle = camp.submit(training_scenario(n_gpus=64), backend="wormhole")
    camp.sweep(variants, backend="wormhole", workers=2)
    camp.close()

    # next session (or after a crash mid-sweep): completed runs are
    # skipped, the campaign's SimDB starts warm, only the remainder runs
    camp = Campaign.open("experiments/cca-sweep")
    camp.sweep(variants, backend="wormhole", workers=2)

A campaign owns two durable artifacts under its directory:

* a :class:`~repro_torch.api.store.RunStore` (``runs/``) — every completed
  ``(scenario, backend, opts)`` evaluation committed atomically the moment
  it finishes, keyed by content (:func:`~repro_torch.api.store.run_key`).
  Submitting a triple that is already stored returns the cached
  :class:`RunResult` without invoking any engine.
* the campaign ``simdb.json`` — the wormhole memo DB, loaded on open and
  saved after every commit, so cross-run fast-forwarding survives crashes
  and sessions without any ``db_path=`` plumbing.

Progress is observable: ``subscribe(callback)`` streams a
:class:`RunEvent` per run — ``started`` / ``finished`` / ``cache_hit`` —
which the CLI (``python -m repro_torch``) and the benchmarks consume.

``repro_torch.api.run`` / ``run_many`` / ``compare`` are thin wrappers over an
anonymous in-memory campaign (``Campaign.in_memory()``), so the flat
function API keeps working unchanged on top of this layer.

Copy of ``repro.api.campaign``, which the port may not import, with one
addition: a campaign directory names the package that owns it.  Both
packages key runs with the same ``run_key`` and write the same records,
but only ``packet``, ``wormhole``, ``hybrid`` and ``analytic`` results are
bit-equal between them, so a ``fluid`` or ``learned`` record of one must
never be served as the other's cache hit.  The port writes manifest
version 2 with ``"package": "repro_torch"``, which the reference refuses
(it reads only version 1), and the port refuses any manifest that does
not name it.  Spawn workers import only ``repro_torch``; a ``fluid`` or
``learned`` run resolves its device in the worker, so a worker with no
card raises as the parent would.
"""
from __future__ import annotations

import atexit
import dataclasses
import json
import multiprocessing
import os
import pathlib
import socket
import time
import weakref
from concurrent.futures import ProcessPoolExecutor, as_completed
from collections.abc import Callable, Iterable, Iterator
from typing import Any

from repro_torch.api.engines import Engine, get_engine
from repro_torch.api.results import Comparison, RunResult
from repro_torch.api.scenario import Scenario
from repro_torch.api.store import DEFAULT_CLAIM_TTL, RunStore, run_key
from repro_torch.core.memo import FORMAT_VERSION, SimDB
from repro_torch.net.sharded_sim import shutdown_pools

MANIFEST = "campaign.json"
MANIFEST_VERSION = 2
PACKAGE = "repro_torch"


def check_manifest(root: pathlib.Path, name: str | None = None) -> str:
    """Read (or create) the manifest of the campaign directory ``root`` and
    return the campaign's name.  A directory another package made (the
    reference's manifests name no package) is refused, so neither package
    serves the other's records as cache hits."""
    root.mkdir(parents=True, exist_ok=True)
    manifest = root / MANIFEST
    if not manifest.exists():
        name = name or root.name
        manifest.write_text(json.dumps(
            {"manifest_version": MANIFEST_VERSION, "name": name,
             "package": PACKAGE}, indent=1))
        return name
    m = json.loads(manifest.read_text())
    if m.get("package") != PACKAGE:
        raise ValueError(
            f"{root} is not a {PACKAGE} campaign (its manifest names package "
            f"{m.get('package')!r}; a campaign of the JAX package `repro` names "
            f"none): the two packages keep their run records apart, so open it "
            f"with `repro` or pick another directory for `{PACKAGE}`")
    if m.get("manifest_version") != MANIFEST_VERSION:
        raise ValueError(
            f"{manifest} has manifest_version {m.get('manifest_version')!r}, "
            f"not the supported {MANIFEST_VERSION}")
    return name or m.get("name") or root.name


@dataclasses.dataclass
class RunEvent:
    """One progress event on a campaign's observer stream.

    ``kind`` is ``"started"`` (an engine run begins), ``"finished"`` (it
    completed and was committed to the store) or ``"cache_hit"`` (the store
    already held the result — nothing was simulated).  ``index`` is the
    position in the submitted sweep, when the event belongs to one.
    """
    kind: str
    key: str
    scenario: str
    backend: str
    index: int | None = None
    result: RunResult | None = None


@dataclasses.dataclass
class RunHandle:
    """What :meth:`Campaign.submit` returns: the run's store key, whether
    it was served from the store, and the result itself."""
    key: str
    scenario: str
    backend: str
    cached: bool
    result: RunResult


def _worker_run(scn_dict: dict, backend: str, db_dict: dict | None,
                opts: dict):
    """Module-level so ProcessPoolExecutor can pickle it.  Returns the
    RunResult plus (for DB-carrying sweeps) the delta of MemoEntries this
    run inserted and the regime fingerprint the kernel bound.  The backend
    resolves in the port's registry (the worker imports only
    ``repro_torch``, and torch only if the engine runs on a device)."""
    scenario = Scenario.from_dict(scn_dict)
    engine = get_engine(backend)
    if db_dict is None:
        return engine.run(scenario, **opts), None, None
    db = SimDB.from_dict(db_dict)
    mark = db.mark()
    result = engine.run(scenario, db=db, **opts)
    delta = [e.to_dict() for e in db.entries_since(mark)]
    return result, delta, db.fingerprint


# ---------------------------------------------------------------------- #
# open campaigns are flushed (and the shared lane-worker pools torn down)
# at interpreter exit, so a CLI invocation or a crashed-by-exception
# session never leaves spawn workers behind or an unsaved SimDB
# ---------------------------------------------------------------------- #
_LIVE: weakref.WeakSet[Campaign] = weakref.WeakSet()
_ATEXIT_REGISTERED = False


def _register_atexit() -> None:
    global _ATEXIT_REGISTERED
    if not _ATEXIT_REGISTERED:
        atexit.register(_close_all)
        _ATEXIT_REGISTERED = True


def _close_all() -> None:
    for camp in list(_LIVE):
        camp.close()
    shutdown_pools()


class Campaign:
    """A named, durable experiment session over the engine registry."""

    def __init__(self, path: str | os.PathLike | None = None,
                 name: str | None = None, db: SimDB | None = None,
                 store: str | None = None) -> None:
        if isinstance(path, str) and path.startswith(("http://", "https://")):
            # Campaign.open("http://host:port") — a pure-remote campaign
            if store is not None and store.rstrip("/") != path.rstrip("/"):
                raise ValueError(
                    f"path {path!r} is a store URL but store={store!r} "
                    f"names a different server")
            store, path = path, None
        self.path = pathlib.Path(path) if path is not None else None
        self._observers: list[Callable[[RunEvent], Any]] = []
        self._closed = False
        self._remote = None                 # RemoteBackend once attached
        self._db_outbox: list[dict] = []    # memo entries awaiting a push
        self._owner = (f"{socket.gethostname()}:{os.getpid()}:"
                       f"{os.urandom(3).hex()}")
        if self.path is not None:
            if db is not None:
                raise ValueError(
                    "a durable campaign owns its SimDB (simdb.json under "
                    "the campaign directory); merge an external DB with "
                    "campaign.db.merge(...) instead of passing db=")
            self.name = check_manifest(self.path, name)
            self.store = RunStore(self.path / "runs")
            self._db = SimDB.load_or_new(str(self.path / "simdb.json"))
            _LIVE.add(self)
        else:
            self.name = name or ("remote" if store is not None
                                 else "anonymous")
            self.store = RunStore(None)
            self._db = db
        if store is not None:
            self._attach_store(store)
        _register_atexit()

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @classmethod
    def open(cls, path: str | os.PathLike, name: str | None = None,
             store: str | None = None) -> "Campaign":
        """Open (or create) the durable campaign at ``path``.  Re-opening
        resumes: completed runs are served from the store, the SimDB
        starts warm.

        ``path`` may be a store-server URL (``http://host:port``) for a
        pure-remote campaign, or ``store=`` can attach a local directory
        campaign to a shared server: reads check the server first and fall
        back to the local store, commits go to the server (degrading to
        local-only while it is unreachable), and the server's memo DB is
        pulled/merged so wormhole replays start warm on every host."""
        return cls(path=path, name=name, store=store)

    @classmethod
    def in_memory(cls, db: SimDB | None = None,
                  name: str | None = None) -> "Campaign":
        """An anonymous, process-lifetime campaign: same dedup/observer
        semantics, nothing written to disk.  ``db=`` optionally threads a
        caller-managed SimDB through wormhole runs (this is how
        ``run_many(shared_db=True)`` rides on campaigns)."""
        return cls(path=None, db=db, name=name)

    @property
    def db(self) -> SimDB | None:
        """The campaign's memo DB (always present on durable campaigns)."""
        return self._db

    @property
    def remote(self):
        """The attached :class:`~repro_torch.api.serve.RemoteBackend` (None for
        purely local campaigns)."""
        return self._remote

    # ------------------------------------------------------------------ #
    # shared store service
    # ------------------------------------------------------------------ #
    def _attach_store(self, store) -> None:
        """Route the campaign's store through a ``python -m repro_torch serve``
        endpoint.  The current backend becomes the remote's local fallback
        (so prior local history stays visible and outage-time commits have
        somewhere durable to land), the local memo DB is pushed up, and the
        server's is pulled down — warm state compounds both ways."""
        from repro_torch.api.serve import RemoteBackend
        if isinstance(store, RemoteBackend):
            remote = store
        elif isinstance(store, str):
            if self._remote is not None:
                if self._remote.url == store.rstrip("/"):
                    return
                raise ValueError(
                    f"campaign is already attached to {self._remote.url}; "
                    f"cannot switch to {store!r}")
            remote = RemoteBackend(store, fallback=self.store.backend)
        else:
            raise TypeError(
                f"store= must be a server URL or RemoteBackend, "
                f"not {type(store).__name__}")
        hits, misses = self.store.hits, self.store.misses
        self.store = RunStore(backend=remote)
        self.store.hits, self.store.misses = hits, misses
        self._remote = remote
        if self._db is None:
            self._db = SimDB()
        if len(self._db):
            # share everything this host already learned; the server-side
            # merge dedups, so a re-push is idempotent
            self._db_outbox.extend(self._db.to_dict()["entries"])
        pulled = remote.simdb_pull()
        if pulled is not None and len(pulled):
            self._db.merge(pulled)
        self._flush_db_outbox()
        _LIVE.add(self)

    def _flush_db_outbox(self) -> None:
        if self._remote is None or not self._db_outbox:
            return
        fingerprint = self._db.fingerprint if self._db is not None else None
        if self._remote.simdb_push(self._db_outbox, fingerprint):
            self._db_outbox.clear()

    def gc(self, ttl: float | None = None) -> list[str]:
        """Expire run records older than ``ttl`` seconds plus stale claims
        (server-side when attached); returns the removed run keys."""
        return self.store.gc(ttl)

    # ------------------------------------------------------------------ #
    # observers
    # ------------------------------------------------------------------ #
    def subscribe(self, callback: Callable[[RunEvent], Any]):
        """Register a progress observer; returns ``callback`` for later
        :meth:`unsubscribe`."""
        self._observers.append(callback)
        return callback

    def unsubscribe(self, callback) -> None:
        self._observers.remove(callback)

    def _emit(self, event: RunEvent) -> None:
        for cb in list(self._observers):
            cb(event)

    # ------------------------------------------------------------------ #
    # submitting work
    # ------------------------------------------------------------------ #
    def _check_opts(self, opts: dict) -> None:
        if (self.path is not None or self._remote is not None) and \
                "db" in opts:
            raise ValueError(
                "a durable or served campaign owns its SimDB — drop db= "
                "(use repro_torch.api.run/run_many for caller-managed DBs)")

    def _db_for(self, engine: Engine, opts: dict) -> SimDB | None:
        """The campaign DB, iff this engine consumes one and the caller is
        not managing a DB explicitly (in-memory campaigns only)."""
        if not getattr(engine, "uses_db", False):
            return None
        if "db" in opts:
            return None
        return self._db

    def submit(self, scenario: Scenario, backend: str = "packet",
               **opts) -> RunHandle:
        """Evaluate one scenario on one backend — unless the store already
        holds this exact ``(scenario, backend, opts)`` triple, in which
        case the stored result is returned without simulating."""
        engine = get_engine(backend)
        engine.check_opts(opts)
        self._check_opts(opts)
        key = run_key(scenario, backend, opts)
        rec = self.store.get(key)
        if rec is not None:
            result = RunResult.from_dict(rec["result"])
            self._emit(RunEvent("cache_hit", key, scenario.name, backend,
                                result=result))
            return RunHandle(key, scenario.name, backend, True, result)
        run_opts = dict(opts)
        db = self._db_for(engine, opts)
        mark = None
        if db is not None:
            run_opts["db"] = db
            mark = db.mark()
        self._emit(RunEvent("started", key, scenario.name, backend))
        result = engine.run(scenario, **run_opts)
        if mark is not None and self._remote is not None:
            self._db_outbox.extend(e.to_dict()
                                   for e in db.entries_since(mark))
        self._commit(key, scenario, backend, opts, result,
                     db_used=db is not None)
        self._emit(RunEvent("finished", key, scenario.name, backend,
                            result=result))
        return RunHandle(key, scenario.name, backend, False, result)

    def sweep(self, scenarios: Iterable[Scenario], backend: str = "packet",
              workers: int = 1, store: str | None = None,
              claims: bool | None = None,
              claim_ttl: float = DEFAULT_CLAIM_TTL,
              poll: float = 0.5, **opts) -> list[RunResult]:
        """Evaluate a sweep with crash-safe incremental persistence: each
        completed run commits to the store (and the SimDB flushes) the
        moment it finishes, so a killed sweep resumes from its last
        completed run on the next open.  Runs already in the store — from
        an earlier session or an identical scenario earlier in this very
        sweep — are skipped and served as ``cache_hit`` events.  Results
        keep scenario order.

        ``workers=N`` fans uncached scenarios over N spawn processes (each
        runs against a snapshot of the campaign DB; insert deltas merge
        back as runs complete).  Serial sweeps on batch-capable engines
        (fluid's padded batch, one ``fluid_scan`` launch per phase) keep
        their batched evaluation.

        ``store=URL`` attaches the campaign to a shared store server (see
        :meth:`open`).  ``claims`` turns on work stealing (default: on iff
        a server is attached): before running, each uncached scenario is
        claimed via an atomic marker record, scenarios claimed by another
        host are left to it and polled every ``poll`` seconds — their
        results arrive as ``cache_hit`` events — and a claim that outlives
        ``claim_ttl`` seconds is stolen and run here, so hosts sweeping
        overlapping sets split the work and a crashed host's share is
        reclaimed."""
        scenarios = list(scenarios)
        engine = get_engine(backend)
        if store is not None:
            self._attach_store(store)
        engine.check_opts(opts)
        self._check_opts(opts)
        keys = [run_key(s, backend, opts) for s in scenarios]
        results: list[RunResult | None] = [None] * len(scenarios)
        by_key: dict[str, list[int]] = {}
        todo: list[int] = []
        for i, k in enumerate(keys):
            if k in by_key:                  # intra-sweep duplicate
                by_key[k].append(i)
                continue
            by_key[k] = [i]
            rec = self.store.get(k)
            if rec is not None:
                results[i] = RunResult.from_dict(rec["result"])
                self._emit(RunEvent("cache_hit", k, scenarios[i].name,
                                    backend, index=i, result=results[i]))
            else:
                todo.append(i)
        if claims is None:
            claims = self._remote is not None
        foreign: list[int] = []
        if claims and todo:
            mine = []
            for i in todo:
                if self.store.claim(keys[i], self._owner, ttl=claim_ttl):
                    mine.append(i)
                else:
                    foreign.append(i)
            todo = mine
        db = self._db_for(engine, opts)
        if todo and workers > 1:
            self._sweep_parallel(scenarios, keys, todo, results, backend,
                                 db, opts, workers)
        elif todo:
            self._sweep_serial(scenarios, keys, todo, results, engine,
                               backend, db, opts)
        if claims:
            for i in todo:
                self.store.release(keys[i], self._owner)
        if foreign:
            self._await_foreign(scenarios, keys, foreign, results, engine,
                                backend, db, opts, claim_ttl, poll)
        for k, idxs in by_key.items():
            for j in idxs[1:]:
                results[j] = results[idxs[0]]
                self._emit(RunEvent("cache_hit", k, scenarios[j].name,
                                    backend, index=j, result=results[j]))
        return results

    def _sweep_serial(self, scenarios, keys, todo, results, engine,
                      backend, db, opts) -> None:
        # a batch-capable engine (fluid's padded batch, the learned
        # engine's one predict) evaluates the whole uncached remainder in
        # one call; commit granularity is then the batch
        if db is None and type(engine).run_batch is not Engine.run_batch:
            for i in todo:
                self._emit(RunEvent("started", keys[i], scenarios[i].name,
                                    backend, index=i))
            batch = engine.run_batch([scenarios[i] for i in todo], **opts)
            for i, result in zip(todo, batch):
                results[i] = result
                self._commit(keys[i], scenarios[i], backend, opts, result)
                # (batch path only runs when db is None — nothing to flush)
                self._emit(RunEvent("finished", keys[i], scenarios[i].name,
                                    backend, index=i, result=result))
            return
        for i in todo:
            self._emit(RunEvent("started", keys[i], scenarios[i].name,
                                backend, index=i))
            run_opts = dict(opts)
            mark = None
            if db is not None:
                run_opts["db"] = db
                mark = db.mark()
            result = engine.run(scenarios[i], **run_opts)
            if mark is not None and self._remote is not None:
                self._db_outbox.extend(e.to_dict()
                                       for e in db.entries_since(mark))
            results[i] = result
            self._commit(keys[i], scenarios[i], backend, opts, result,
                         db_used=db is not None)
            self._emit(RunEvent("finished", keys[i], scenarios[i].name,
                                backend, index=i, result=result))

    def _await_foreign(self, scenarios, keys, foreign, results, engine,
                       backend, db, opts, claim_ttl, poll) -> None:
        # another host holds claims on these keys: poll for their records
        # (counter-neutral peeks), and steal any claim that expires — a
        # crashed host's share of the sweep finishes here
        pending = list(foreign)
        while pending:
            still: list[int] = []
            for i in pending:
                rec = self.store.peek(keys[i])
                if rec is not None:
                    results[i] = RunResult.from_dict(rec["result"])
                    self._emit(RunEvent("cache_hit", keys[i],
                                        scenarios[i].name, backend, index=i,
                                        result=results[i]))
                    continue
                if self.store.claim(keys[i], self._owner, ttl=claim_ttl):
                    self._sweep_serial(scenarios, keys, [i], results,
                                       engine, backend, db, opts)
                    self.store.release(keys[i], self._owner)
                    continue
                still.append(i)
            if still:
                time.sleep(poll)
            pending = still

    def _sweep_parallel(self, scenarios, keys, todo, results, backend,
                        db, opts, workers) -> None:
        db_dict = db.to_dict() if db is not None else None
        # spawn, not fork: the parent may hold a CUDA context (e.g. a fluid
        # sweep earlier in the session), which a forked child cannot use
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
            futures = {}
            for i in todo:
                self._emit(RunEvent("started", keys[i], scenarios[i].name,
                                    backend, index=i))
                futures[pool.submit(_worker_run, scenarios[i].to_dict(),
                                    backend, db_dict, dict(opts))] = i
            # commit in completion order — the crash-safe increment; the
            # results list still comes back in scenario order
            for fut in as_completed(futures):
                i = futures[fut]
                result, delta, fingerprint = fut.result()
                results[i] = result
                if db is not None and delta is not None:
                    db.merge(SimDB.from_dict({
                        "format_version": FORMAT_VERSION,
                        "fingerprint": fingerprint, "entries": delta}))
                    if self._remote is not None:
                        # the push dedups server-side, so the raw delta
                        # (pre-merge) is fine to forward as-is
                        self._db_outbox.extend(delta)
                self._commit(keys[i], scenarios[i], backend, opts, result,
                             db_used=db is not None)
                self._emit(RunEvent("finished", keys[i], scenarios[i].name,
                                    backend, index=i, result=result))

    def _commit(self, key, scenario, backend, opts, result,
                db_used: bool = False) -> None:
        self.store.put(key, scenario, backend, opts, result)
        if db_used:
            # only runs the campaign DB was threaded into can have grown
            # it — skip the O(DB size) rewrite for everything else
            self._save_db()
            self._flush_db_outbox()

    def _save_db(self) -> None:
        if self.path is not None and self._db is not None and len(self._db):
            self._db.save(str(self.path / "simdb.json"))

    # ------------------------------------------------------------------ #
    # queries over the store
    # ------------------------------------------------------------------ #
    def records(self, backend: str | None = None,
                scenario: "Scenario | str | None" = None) -> Iterator[dict]:
        """Stored run records, optionally filtered by backend and/or
        scenario (a Scenario or its name)."""
        name = scenario.name if isinstance(scenario, Scenario) else scenario
        for rec in self.store.records():
            if backend is not None and rec["backend"] != backend:
                continue
            if name is not None and rec["scenario"]["name"] != name:
                continue
            yield rec

    def results(self, backend: str | None = None,
                scenario: Scenario | str | None = None) -> list[RunResult]:
        """Stored results (post JSON round-trip), same filters as
        :meth:`records`."""
        return [RunResult.from_dict(r["result"])
                for r in self.records(backend=backend, scenario=scenario)]

    def export_dataset(self, backends=None, heldout_frac: float = 0.25):
        """The campaign's stored ground truth as a learned-engine training
        :class:`~repro_torch.learned.dataset.Dataset` — the ``campaign → training
        set`` seam (``repro_torch.learned`` imports lazily; dataset extraction is
        numpy-only).  ``backends`` defaults to every ground-truth family
        present (packet/wormhole/hybrid)."""
        from repro_torch.learned.dataset import GROUND_TRUTH_BACKENDS, build_dataset
        if backends is None:
            backends = GROUND_TRUTH_BACKENDS
        return build_dataset(self, backends=tuple(backends),
                             heldout_frac=heldout_frac)

    def compare(self, scenario: Scenario,
                backends=("packet", "wormhole"),
                baseline: str | None = None,
                backend_opts: dict | None = None, **opts) -> Comparison:
        """Run ``scenario`` on every backend (cache hits for any the store
        already holds) and tabulate speedups + FCT errors against
        ``baseline`` (default: the first backend).

        ``**opts`` go to every backend; ``backend_opts`` maps a backend
        name to opts only it receives (overriding the shared ones) — the
        ``--opt backend:key=value`` CLI form — so one comparison can, say,
        pin ``hybrid``'s fidelity without leaking an unknown opt into
        ``packet``."""
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
        results = {b: self.submit(scenario, backend=b,
                                  **{**opts, **backend_opts.get(b, {})})
                   .result for b in backends}
        return Comparison(scenario=scenario.name, baseline=baseline,
                          results=results)

    def __len__(self) -> int:
        return len(self.store)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def close(self) -> None:
        """End the session: flush the SimDB and (for durable campaigns)
        tear down the shared lane-worker pools so spawn workers never
        outlive the work.  Registered at atexit for every open campaign;
        idempotent."""
        if self._closed:
            return
        self._closed = True
        self._save_db()
        self._flush_db_outbox()
        self.store.close()
        _LIVE.discard(self)
        if self.path is not None:
            shutdown_pools()

    def __enter__(self) -> "Campaign":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        where = str(self.path) if self.path is not None else "in-memory"
        if self._remote is not None:
            where += f" -> {self._remote.url}"
        return (f"Campaign({self.name!r}, {where}, runs={len(self.store)}, "
                f"db_entries={len(self._db) if self._db is not None else 0})")
