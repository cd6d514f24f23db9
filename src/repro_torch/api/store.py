"""Content-addressed store of completed runs — the durable half of a
:class:`~repro_torch.api.campaign.Campaign`.

Every completed ``(scenario, backend, opts)`` evaluation is committed under
its :func:`run_key` — a stable hash of the scenario's canonical JSON form,
the backend name and the JSON-canonicalized engine opts.  Submitting the
same triple again finds the stored record instead of simulating, which is
what makes a half-finished sweep resumable: the store is the ground truth
of what already ran.

Storage is split behind a small transport-agnostic seam:

* :class:`StoreBackend` — the protocol (``get``/``put``/``put_new``/
  ``delete``/``keys``/``records``/``age``): string key -> JSON record.
* :class:`MemoryBackend` — the anonymous campaigns behind
  ``repro_torch.api.run``/``run_many`` (nothing written to disk).
* :class:`LocalDirBackend` — one JSON file per run, written atomically via
  rename, so a killed sweep never leaves a torn record.
* ``repro_torch.api.serve.RemoteBackend`` — the same protocol over HTTP against
  a ``python -m repro_torch serve`` endpoint, so many hosts share one store.

:class:`RunStore` is the policy layer on top of whichever backend: record
canonicalization (results pass through the ``RunResult.to_dict``/
``from_dict`` JSON round-trip on ``put``, so a cached result is
byte-for-byte what a re-opened campaign would read from disk), version
checking, dedup verification on overwrite, advisory *claim* records for
multi-host work stealing, and TTL garbage collection.

Copy of ``repro.api.store``, which the port may not import.  Keys and
records are the reference's byte for byte (``RECORD_VERSION`` 1): the
learned dataset splits train from held-out on ``sha256(run_key)``, so the
same record lands on the same side of the split in both packages, and a
record file either package wrote loads in the other's ``RunStore``.  So
the two packages' records are kept apart above this layer, where a store
is opened: a port campaign directory carries ``"package": "repro_torch"``
in its manifest (``repro_torch.api.campaign``), and the port's store
service answers only clients that name the port (``repro_torch.api.serve``).
"""
from __future__ import annotations

import copy
import itertools
import json
import os
import pathlib
import time
import warnings
from hashlib import sha256
from collections.abc import Iterator

from repro_torch.api.results import RunResult, jsonify
from repro_torch.api.scenario import Scenario

RECORD_VERSION = 1

# claims are plain records living in the same keyspace under this prefix;
# run keys are 40 lowercase hex chars, so the prefix can never collide
CLAIM_PREFIX = "claim--"
DEFAULT_CLAIM_TTL = 600.0


class _Raw(tuple):
    """In-memory put defers record canonicalization to first read."""
    __slots__ = ()

    def __new__(cls, scenario, backend, opts, result):
        return super().__new__(cls, (scenario, backend, opts, result))


def _dict_fingerprint(d: dict) -> str:
    return sha256(json.dumps(d, sort_keys=True,
                             separators=(",", ":")).encode()).hexdigest()


def scenario_fingerprint(scenario: Scenario) -> str:
    """Stable content hash of a scenario's canonical JSON form."""
    return _dict_fingerprint(scenario.to_dict())


# every submit carrying an opt with no canonical JSON form is its own
# experiment — see _key_form
_UNCACHEABLE = itertools.count(1)


def _key_form(x):
    """Canonical key form of an opt value: :func:`jsonify`, except objects
    with no canonical JSON form (live SimDB handles, open files) become a
    process-unique token instead of ``repr`` — a repr can truncate (large
    ndarrays) or embed a reusable memory address, either of which could
    collide two distinct experiments onto one store key.  Such opts are
    uncacheable: every submit keys uniquely."""
    return jsonify(x, fallback=lambda v:
                   f"<uncacheable {type(v).__name__} #{next(_UNCACHEABLE)}>")


def run_key(scenario: Scenario, backend: str, opts: dict) -> str:
    """The store's content address: ``(scenario fingerprint, backend,
    canonicalized opts)`` hashed into one stable hex key.  Opts with no
    canonical JSON form never dedup (each submit is its own experiment)."""
    blob = json.dumps({
        "scenario_fingerprint": scenario_fingerprint(scenario),
        "backend": backend,
        "opts": _key_form(opts),
    }, sort_keys=True, separators=(",", ":"))
    return sha256(blob.encode()).hexdigest()[:40]


def stable_record_fingerprint(record: dict) -> str:
    """Content hash of a run record with its inherently nondeterministic
    fields (wall-clock timings) masked out — what :meth:`RunStore.put`
    compares when a key is committed twice.  Two runs of a deterministic
    engine on the same triple agree on this fingerprint even though their
    ``wall_time`` differs."""
    rec = copy.deepcopy(record)
    result = rec.get("result")
    if isinstance(result, dict):
        result.pop("wall_time", None)
        extras = result.get("extras")
        if isinstance(extras, dict):
            extras.pop("batch_wall", None)
    return _dict_fingerprint(rec)


# ---------------------------------------------------------------------- #
# backends: the transport-agnostic seam
# ---------------------------------------------------------------------- #
class StoreBackend:
    """Protocol for record storage: string key -> JSON-serializable dict.

    Implementations must make ``put`` atomic (a reader never observes a
    torn record) and ``put_new`` an atomic create-if-absent (the primitive
    claims are built on).  ``age`` reports seconds since a key was last
    written (or None when unknown) — the TTL/GC clock.
    """

    def get(self, key: str) -> dict | None:
        raise NotImplementedError

    def put(self, key: str, record: dict) -> None:
        raise NotImplementedError

    def put_new(self, key: str, record: dict) -> bool:
        """Atomically create ``key`` iff absent; True when this call won."""
        raise NotImplementedError

    def delete(self, key: str) -> bool:
        raise NotImplementedError

    def keys(self) -> list[str]:
        raise NotImplementedError

    def records(self) -> Iterator[dict]:
        for key in self.keys():
            rec = self.get(key)
            if rec is not None:
                yield rec

    def age(self, key: str) -> float | None:
        return None

    def close(self) -> None:
        pass


class MemoryBackend(StoreBackend):
    """Process-lifetime dict backing (anonymous campaigns)."""

    def __init__(self) -> None:
        self._mem: dict[str, dict] = {}
        self._written_at: dict[str, float] = {}

    def get(self, key: str) -> dict | None:
        ent = self._mem.get(key)
        if isinstance(ent, _Raw):
            # first read materializes the canonical record — the same JSON
            # form a disk backing would hand back.  Anonymous campaigns
            # behind run()/run_many() never read their own store, so they
            # never pay this.
            ent = json.loads(json.dumps(RunStore._record(key, *ent)))
            self._mem[key] = ent
        return ent

    def put(self, key: str, record: dict) -> None:
        self._mem[key] = record
        self._written_at[key] = time.time()

    def put_lazy(self, key: str, scenario, backend, opts, result) -> None:
        """Defer canonicalization to first read (see :class:`_Raw`)."""
        self._mem[key] = _Raw(scenario, backend, opts, result)
        self._written_at[key] = time.time()

    def put_new(self, key: str, record: dict) -> bool:
        if key in self._mem:
            return False
        self.put(key, record)
        return True

    def delete(self, key: str) -> bool:
        self._written_at.pop(key, None)
        return self._mem.pop(key, None) is not None

    def keys(self) -> list[str]:
        return sorted(self._mem)

    def age(self, key: str) -> float | None:
        t = self._written_at.get(key)
        return None if t is None else max(0.0, time.time() - t)


class LocalDirBackend(StoreBackend):
    """One ``<key>.json`` file per record, committed by atomic rename.

    A truncated or garbled file (torn copy, disk fault — our own writes
    are atomic) reads as absent with a one-shot warning, so one bad record
    can't poison dataset extraction or a resumed sweep; rewriting the key
    heals it.  ``corrupt_keys`` lists the currently-unparsable keys.
    """

    def __init__(self, path: str | os.PathLike) -> None:
        self.path = pathlib.Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self._corrupt: set[str] = set()

    def _file(self, key: str) -> pathlib.Path:
        return self.path / f"{key}.json"

    def get(self, key: str) -> dict | None:
        try:
            with open(self._file(key)) as fh:
                rec = json.load(fh)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, UnicodeDecodeError):
            if key not in self._corrupt:
                self._corrupt.add(key)
                warnings.warn(
                    f"skipping corrupt run record {self._file(key)} "
                    f"(unparsable JSON); see RunStore.corrupt_keys()",
                    RuntimeWarning, stacklevel=4)
            return None
        self._corrupt.discard(key)
        return rec

    def _write_tmp(self, key: str, record: dict) -> pathlib.Path:
        tmp = self.path / f".{key}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(record, fh)
        return tmp

    def put(self, key: str, record: dict) -> None:
        os.replace(self._write_tmp(key, record), self._file(key))

    def put_new(self, key: str, record: dict) -> bool:
        # os.link refuses to clobber, atomically even over NFS — the
        # multi-process-safe create-if-absent that claims ride on
        tmp = self._write_tmp(key, record)
        try:
            os.link(tmp, self._file(key))
            return True
        except FileExistsError:
            return False
        finally:
            os.unlink(tmp)

    def delete(self, key: str) -> bool:
        try:
            os.remove(self._file(key))
            return True
        except FileNotFoundError:
            return False

    def keys(self) -> list[str]:
        return sorted(p.stem for p in self.path.glob("*.json")
                      if not p.name.startswith("."))

    def age(self, key: str) -> float | None:
        try:
            return max(0.0, time.time() - os.stat(self._file(key)).st_mtime)
        except FileNotFoundError:
            return None

    def corrupt_keys(self) -> set[str]:
        return self._corrupt


# ---------------------------------------------------------------------- #
# the policy layer
# ---------------------------------------------------------------------- #
class RunStore:
    """Keyed store of completed runs over a :class:`StoreBackend`.

    ``RunStore(path)`` keeps the historical constructor: ``path=None`` is a
    :class:`MemoryBackend`, a path a :class:`LocalDirBackend`; pass
    ``backend=`` for anything else (a remote store).  ``hits``/``misses``
    count :meth:`get` outcomes — the dedup counters the CI benchmark gate
    tracks."""

    def __init__(self, path: str | os.PathLike | None = None, *,
                 backend: StoreBackend | None = None) -> None:
        if backend is not None and path is not None:
            raise ValueError("pass either path= or backend=, not both")
        if backend is None:
            backend = (LocalDirBackend(path) if path is not None
                       else MemoryBackend())
        self.backend = backend
        self.path = getattr(backend, "path", None)
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------ #
    def get(self, key: str) -> dict | None:
        """The stored record for ``key`` (or None), counting hit/miss."""
        rec = self._peek(key)
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def _peek(self, key: str) -> dict | None:
        rec = self.backend.get(key)
        if rec is None:
            return None
        version = rec.get("record_version")
        if version != RECORD_VERSION:
            raise ValueError(
                f"run record {key} has record_version {version!r}, not the "
                f"supported {RECORD_VERSION}; re-record the run with this "
                f"code version")
        return rec

    def peek(self, key: str) -> dict | None:
        """Like :meth:`get` but without touching the hit/miss counters —
        for polling loops (multi-host sweeps waiting on another owner's
        claim) that would otherwise skew the dedup statistics."""
        return self._peek(key)

    def __contains__(self, key: str) -> bool:
        return self._peek(key) is not None

    @staticmethod
    def _record(key: str, scenario: Scenario, backend: str, opts: dict,
                result: RunResult) -> dict:
        scn_dict = scenario.to_dict()
        return {
            "record_version": RECORD_VERSION,
            "key": key,
            "scenario": scn_dict,
            "scenario_fingerprint": _dict_fingerprint(scn_dict),
            "backend": backend,
            "opts": jsonify(opts),
            "result": result.to_dict(),
        }

    def put(self, key: str, scenario: Scenario, backend: str, opts: dict,
            result: RunResult) -> bool:
        """Commit one completed run.  The record is fully JSON-canonical
        (the result goes through its ``to_dict`` round-trip), and the write
        is atomic — a crash mid-``put`` leaves either the previous state or
        the complete record, never a torn file.

        If the key is already committed, the stored record's content
        fingerprint (wall-clock fields masked) is verified against the new
        one: a match is a *dedup hit* (nothing rewritten, returns True); a
        mismatch warns — a silent overwrite can hide a nondeterministic
        engine — and the new record wins.  Returns whether the write was a
        dedup hit."""
        existing = self.backend.get(key)
        if existing is not None:
            record = self._record(key, scenario, backend, opts, result)
            if stable_record_fingerprint(existing) == \
                    stable_record_fingerprint(record):
                return True
            warnings.warn(
                f"run record {key} already exists with different content "
                f"(beyond wall-clock fields) — the engine {backend!r} may "
                f"be nondeterministic, or two different code versions "
                f"wrote this store; overwriting with the newer record",
                RuntimeWarning, stacklevel=2)
            self.backend.put(key, json.loads(json.dumps(record)))
            return False
        put_lazy = getattr(self.backend, "put_lazy", None)
        if put_lazy is not None:
            put_lazy(key, scenario, backend, opts, result)
        else:
            self.backend.put(key, self._record(key, scenario, backend, opts,
                                               result))
        return False

    def delete(self, key: str) -> bool:
        return self.backend.delete(key)

    # ------------------------------------------------------------------ #
    def keys(self) -> list[str]:
        return [k for k in self.backend.keys()
                if not k.startswith(CLAIM_PREFIX)]

    def records(self) -> Iterator[dict]:
        for key in self.keys():
            rec = self._peek(key)
            if rec is not None:
                yield rec

    def corrupt_keys(self) -> list[str]:
        """Keys whose record files exist but do not parse — a full sweep,
        so the answer is current even before any :meth:`records` pass."""
        for key in self.keys():
            self._peek(key)
        tracked = getattr(self.backend, "corrupt_keys", None)
        return sorted(tracked()) if tracked is not None else []

    def __len__(self) -> int:
        return len(self.keys())

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def close(self) -> None:
        self.backend.close()

    # ------------------------------------------------------------------ #
    # claims: advisory work-stealing markers over the same backend
    # ------------------------------------------------------------------ #
    def claim(self, key: str, owner: str,
              ttl: float = DEFAULT_CLAIM_TTL) -> bool:
        """Try to claim ``key`` for ``owner``: True when this caller now
        holds the claim.  A claim is a plain record under a reserved key
        prefix, created with the backend's atomic ``put_new`` — so two
        sweeping hosts race safely and exactly one wins.  Claims expire
        after ``ttl`` seconds (a crashed worker's claims are stolen, which
        is what makes multi-host sweeps crash-safe); they are *advisory*:
        losing a rare steal race double-runs a scenario, and the
        content-addressed store dedups the second commit."""
        ck = CLAIM_PREFIX + key
        rec = {"owner": owner, "t": time.time(), "ttl": ttl}
        if self.backend.put_new(ck, rec):
            return True
        cur = self.backend.get(ck)
        if cur is None:                       # released between our calls
            return self.backend.put_new(ck, rec)
        if cur.get("owner") == owner:
            return True
        if time.time() - float(cur.get("t", 0.0)) > float(cur.get("ttl",
                                                          DEFAULT_CLAIM_TTL)):
            # stale claim from a dead worker: steal it (the marker lets a
            # served store count steals in its /metrics)
            self.backend.delete(ck)
            return self.backend.put_new(ck, {**rec, "stolen": True})
        return False

    def claim_owner(self, key: str) -> str | None:
        """Current live claim holder for ``key`` (None when unclaimed or
        expired)."""
        cur = self.backend.get(CLAIM_PREFIX + key)
        if cur is None:
            return None
        if time.time() - float(cur.get("t", 0.0)) > float(cur.get("ttl",
                                                          DEFAULT_CLAIM_TTL)):
            return None
        return cur.get("owner")

    def release(self, key: str, owner: str) -> None:
        """Drop ``owner``'s claim on ``key`` (someone else's is left
        alone)."""
        ck = CLAIM_PREFIX + key
        cur = self.backend.get(ck)
        if cur is not None and cur.get("owner") == owner:
            self.backend.delete(ck)

    # ------------------------------------------------------------------ #
    # TTL / GC
    # ------------------------------------------------------------------ #
    def gc(self, ttl: float | None = None) -> list[str]:
        """Compact the store: drop run records older than ``ttl`` seconds
        (None keeps them all) and every expired claim.  Returns the removed
        run keys.  Age comes from the backend's write clock (file mtime on
        disk), so re-committing a key refreshes its lease.  Against a
        remote backend the sweep runs server-side (ages live with the
        files)."""
        server_gc = getattr(self.backend, "server_gc", None)
        if server_gc is not None:
            return server_gc(ttl)
        removed: list[str] = []
        now = time.time()
        for key in self.backend.keys():
            if key.startswith(CLAIM_PREFIX):
                cur = self.backend.get(key)
                if cur is None or now - float(cur.get("t", 0.0)) > \
                        float(cur.get("ttl", DEFAULT_CLAIM_TTL)):
                    self.backend.delete(key)
                continue
            if ttl is None:
                continue
            age = self.backend.age(key)
            if age is not None and age > ttl:
                if self.backend.delete(key):
                    removed.append(key)
        return removed
