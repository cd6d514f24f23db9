"""Shared campaign-store service: one warm store for every host (§6.1).

``python -m repro_torch serve -c DIR`` exposes a campaign directory over HTTP so
remote clients share its content-addressed run records *and* its memo DB —
the paper's warm-replay collapse compounds across machines instead of
staying local.  Everything here is pure stdlib (``http.server`` /
``urllib``): the service rides along in spawn workers and minimal CI
environments without touching torch.

Server (:class:`StoreServer`) endpoints, all JSON:

    GET    /ping                     service info ("repro_torch-store",
                                     record count, DB size)
    GET    /runs                     {"keys": [...]}
    GET    /runs/<key>               one record (404 when absent)
    PUT    /runs/<key>               commit a record (atomic on disk)
    PUT    /runs/<key>?if_absent=1   atomic create — the claim primitive
    DELETE /runs/<key>               drop a record
    GET    /simdb                    pull the full memo DB
    POST   /simdb                    push a delta; merged via SimDB.merge
    POST   /gc                       {"ttl": s} -> expire old records/claims
    GET    /metrics                  operator counters: store hits/misses/
                                     dedup hits, SimDB replay rate, claim
                                     creates/rejects/steals/releases

Client (:class:`RemoteBackend`) speaks the same :class:`~repro_torch.api.store.
StoreBackend` protocol as the local backends, so a
:class:`~repro_torch.api.store.RunStore` — and therefore a whole
:class:`~repro_torch.api.campaign.Campaign` — runs against a server unchanged.
Reads fall through to a local ``fallback`` backend, and on server loss the
client degrades gracefully: after ``retries`` attempts with exponential
backoff it commits locally, remembers the pending keys, probes the server
every ``retry_interval`` seconds, and re-pushes everything pending on
reconnect — no lost or duplicated records (the store is content-addressed,
so a re-pushed record dedups server-side).

Consistency model: records are immutable-by-content (last write wins, and
:meth:`RunStore.put` verifies content equality on overwrite), claims are
advisory with TTL expiry, and the SimDB is merge-only (commutative,
idempotent - every push dedups against the server copy).  There is no
authentication: bind to localhost or a trusted network.

Copy of ``repro.api.serve``, which the port may not import, with the two
packages kept apart (their ``fluid`` and ``learned`` records differ under
the same run key).  The client sends ``X-Repro-Package: repro_torch`` on
every request; the server answers 403 to any request without it (not 404,
which reads as "absent", nor 409, which the reference's client reads as a
SimDB mismatch), so the reference's client degrades to local-only against
a port server and is never served a port record.  The server stamps every
response with the same header, and the client refuses a server whose
answers lack it (the reference's server), so the port is never served a
reference record either.  The server also refuses to serve a campaign
directory another package made (``campaign.check_manifest``).
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import threading
import time
import urllib.error
import urllib.request
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.api.campaign import PACKAGE, check_manifest
from repro_torch.api.store import (CLAIM_PREFIX, RECORD_VERSION, LocalDirBackend,
                                   MemoryBackend, RunStore, StoreBackend,
                                   stable_record_fingerprint)
from repro_torch.core.memo import FORMAT_VERSION, SimDB, SimDBMismatch

_KEY_RE = re.compile(r"^[A-Za-z0-9_-]{1,200}$")
PACKAGE_HEADER = "X-Repro-Package"
SERVICE = "repro_torch-store"


class RemoteStoreError(OSError):
    """The store server could not be reached (after retries) or answered
    with a non-success status."""


class ForeignStoreError(ValueError):
    """The server at the URL is not a ``repro_torch`` store (the reference
    package's, say): the client refuses it rather than share records."""


# ---------------------------------------------------------------------- #
# server
# ---------------------------------------------------------------------- #
class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    owner: "StoreServer"


class _Handler(BaseHTTPRequestHandler):
    # keep-alive matters: a sweep makes hundreds of small requests
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):    # noqa: A003 - stdlib signature
        if not self.server.owner.quiet:
            super().log_message(fmt, *args)

    # -------------------------------------------------------------- #
    def _json(self, obj, status: int = 200) -> None:
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header(PACKAGE_HEADER, PACKAGE)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self):
        length = int(self.headers.get("Content-Length") or 0)
        if length == 0:
            return None
        return json.loads(self.rfile.read(length))

    def _route(self):
        path, _, query = self.path.partition("?")
        parts = [p for p in path.split("/") if p]
        return parts, query

    def _foreign(self) -> bool:
        """Answer 403 (and True) to a client that does not name the port."""
        if self.headers.get(PACKAGE_HEADER) == PACKAGE:
            return False
        # drain the body so a keep-alive connection stays in step
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        self._json({"error": f"this is a {PACKAGE} store; requests must send "
                             f"{PACKAGE_HEADER}: {PACKAGE} (the JAX package "
                             f"`repro` keeps its own store)"}, 403)
        return True

    def _key(self, parts) -> str | None:
        if len(parts) != 2 or not _KEY_RE.match(parts[1]):
            self._json({"error": f"bad path {self.path!r}"}, 400)
            return None
        return parts[1]

    # -------------------------------------------------------------- #
    def do_GET(self) -> None:                                 # noqa: N802
        if self._foreign():
            return
        srv = self.server.owner
        parts, _ = self._route()
        if parts == ["ping"]:
            self._json(srv.info())
        elif parts == ["metrics"]:
            with srv.lock:
                self._json(srv.metrics_payload())
        elif parts == ["runs"]:
            self._json({"keys": srv.backend.keys()})
        elif parts and parts[0] == "runs":
            key = self._key(parts)
            if key is None:
                return
            rec = srv.backend.get(key)
            if not key.startswith(CLAIM_PREFIX):
                # claim polls are coordination noise, not cache traffic
                with srv.lock:
                    srv.metrics["store_gets"] += 1
                    srv.metrics["store_hits" if rec is not None
                                else "store_misses"] += 1
            if rec is None:
                self._json({"error": "not found"}, 404)
            else:
                self._json(rec)
        elif parts == ["simdb"]:
            with srv.lock:
                srv.metrics["simdb_pulls"] += 1
                self._json(srv.db.to_dict())
        else:
            self._json({"error": f"unknown path {self.path!r}"}, 404)

    def do_PUT(self) -> None:                                 # noqa: N802
        if self._foreign():
            return
        srv = self.server.owner
        parts, query = self._route()
        if not parts or parts[0] != "runs":
            self._json({"error": f"unknown path {self.path!r}"}, 404)
            return
        key = self._key(parts)
        if key is None:
            return
        record = self._body()
        if not isinstance(record, dict):
            self._json({"error": "body must be a JSON record"}, 400)
            return
        with srv.lock:
            if "if_absent=1" in query.split("&"):
                created = srv.backend.put_new(key, record)
                if key.startswith(CLAIM_PREFIX):
                    if not created:
                        srv.metrics["claim_rejects"] += 1
                    elif record.get("stolen"):
                        srv.metrics["claim_steals"] += 1
                    else:
                        srv.metrics["claim_creates"] += 1
                self._json({"created": created})
            else:
                if not key.startswith(CLAIM_PREFIX):
                    srv.metrics["store_puts"] += 1
                    prev = srv.backend.get(key)
                    if prev is not None and stable_record_fingerprint(prev) \
                            == stable_record_fingerprint(record):
                        # same content re-committed (work-stealing overlap
                        # or a resumed sweep) — the dedup the store's
                        # content addressing exists for
                        srv.metrics["dedup_hits"] += 1
                srv.backend.put(key, record)
                self._json({"created": True})

    def do_DELETE(self) -> None:                              # noqa: N802
        if self._foreign():
            return
        srv = self.server.owner
        parts, _ = self._route()
        if not parts or parts[0] != "runs":
            self._json({"error": f"unknown path {self.path!r}"}, 404)
            return
        key = self._key(parts)
        if key is None:
            return
        with srv.lock:
            deleted = srv.backend.delete(key)
            if deleted and key.startswith(CLAIM_PREFIX):
                srv.metrics["claim_releases"] += 1
            self._json({"deleted": deleted})

    def do_POST(self) -> None:                                # noqa: N802
        if self._foreign():
            return
        srv = self.server.owner
        parts, _ = self._route()
        if parts == ["simdb"]:
            delta = self._body()
            try:
                with srv.lock:
                    incoming = SimDB.from_dict(delta)
                    added = srv.db.merge(incoming)
                    srv.metrics["simdb_pushes"] += 1
                    srv.metrics["simdb_entries_pushed"] += len(incoming)
                    srv.metrics["simdb_entries_added"] += added
                    srv.save_db()
                    self._json({"added": added, "entries": len(srv.db)})
            except SimDBMismatch as exc:
                self._json({"error": str(exc)}, 409)
        elif parts == ["gc"]:
            body = self._body() or {}
            with srv.lock:
                removed = srv.store.gc(body.get("ttl"))
            self._json({"removed": removed})
        else:
            self._json({"error": f"unknown path {self.path!r}"}, 404)


class StoreServer:
    """Serve a campaign directory's run store + memo DB over HTTP.

    ``root`` follows the campaign layout (``runs/`` + ``simdb.json``), so
    serving an existing campaign shares everything it already learned.
    Mutations are serialized by one lock — claims (``if_absent``) and
    SimDB merges are race-free through a server.  ``ttl`` (seconds)
    enables a background GC sweep expiring old run records."""

    def __init__(self, root: str | os.PathLike, host: str = "127.0.0.1",
                 port: int = 0, ttl: float | None = None,
                 quiet: bool = True) -> None:
        self.root = pathlib.Path(root)
        check_manifest(self.root)
        self.backend = LocalDirBackend(self.root / "runs")
        self.store = RunStore(backend=self.backend)
        self.db = SimDB.load_or_new(str(self.root / "simdb.json"))
        self.ttl = ttl
        self.quiet = quiet
        self.lock = threading.Lock()
        # operator counters (GET /metrics), mutated under self.lock —
        # process-lifetime, not persisted with the campaign
        self.metrics: dict[str, int] = {
            "store_gets": 0, "store_hits": 0, "store_misses": 0,
            "store_puts": 0, "dedup_hits": 0,
            "claim_creates": 0, "claim_rejects": 0, "claim_steals": 0,
            "claim_releases": 0,
            "simdb_pulls": 0, "simdb_pushes": 0,
            "simdb_entries_pushed": 0, "simdb_entries_added": 0,
        }
        self._httpd = _HTTPServer((host, port), _Handler)
        self._httpd.owner = self
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._gc_stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def info(self) -> dict:
        return {"service": SERVICE, "record_version": RECORD_VERSION,
                "runs": len(self.store), "db_entries": len(self.db),
                "ttl": self.ttl}

    def metrics_payload(self) -> dict:
        """Counters + derived rates for ``GET /metrics`` (call under
        ``self.lock``).  ``store_hit_rate`` answers "are user queries
        landing warm?"; ``simdb_replay_rate`` is the fraction of pushed
        memo entries the server already knew — cross-host warm replays."""
        m: dict = dict(self.metrics)
        m["store_hit_rate"] = (m["store_hits"] / m["store_gets"]
                               if m["store_gets"] else None)
        m["simdb_replay_rate"] = (
            1.0 - m["simdb_entries_added"] / m["simdb_entries_pushed"]
            if m["simdb_entries_pushed"] else None)
        m["runs"] = len(self.store)
        m["db_entries"] = len(self.db)
        return m

    def save_db(self) -> None:
        if len(self.db):
            self.db.save(str(self.root / "simdb.json"))

    def gc(self, ttl: float | None = None) -> list[str]:
        with self.lock:
            return self.store.gc(self.ttl if ttl is None else ttl)

    # -------------------------------------------------------------- #
    def _gc_loop(self) -> None:
        interval = max(1.0, min(self.ttl / 2.0, 60.0))
        while not self._gc_stop.wait(interval):
            self.gc()

    def start(self) -> "StoreServer":
        """Serve on background daemon threads; returns self (url bound)."""
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                             name="repro_torch-store-server")
        t.start()
        self._threads.append(t)
        if self.ttl is not None:
            g = threading.Thread(target=self._gc_loop, daemon=True,
                                 name="repro_torch-store-gc")
            g.start()
            self._threads.append(g)
        return self

    def serve_forever(self) -> None:
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        self._gc_stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        with self.lock:
            self.save_db()


# ---------------------------------------------------------------------- #
# client
# ---------------------------------------------------------------------- #
class RemoteBackend(StoreBackend):
    """:class:`StoreBackend` over HTTP against a :class:`StoreServer`.

    Reads check the server first and fall through to ``fallback`` (a local
    backend), so records committed during an outage — or local history
    predating the attachment — stay visible.  Writes go to the server;
    when it is unreachable they degrade to the fallback and are re-pushed
    on reconnect (``pending`` tracks what still needs to go up).  Every
    request names the port, and a server whose answer does not raises
    :class:`ForeignStoreError`."""

    def __init__(self, url: str, timeout: float = 10.0, retries: int = 3,
                 backoff: float = 0.2, retry_interval: float = 5.0,
                 fallback: StoreBackend | None = None) -> None:
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.retries = max(1, retries)
        self.backoff = backoff
        self.retry_interval = retry_interval
        self.fallback = fallback if fallback is not None else MemoryBackend()
        self.pending: set[str] = set()   # keys committed locally while down
        self.reconnects = 0
        self._down_since: float | None = None
        self._last_probe = 0.0

    # -------------------------------------------------------------- #
    # transport
    # -------------------------------------------------------------- #
    def _call(self, method: str, path: str, payload=None,
              retries: int | None = None):
        """One JSON request with retry/backoff.  HTTP 404 returns None;
        other HTTP errors and exhausted network retries raise
        :class:`RemoteStoreError` (the degradation trigger); an answer
        without the port's stamp raises :class:`ForeignStoreError`."""
        body = None if payload is None else json.dumps(payload).encode()
        attempts = self.retries if retries is None else retries
        last: Exception | None = None
        for attempt in range(attempts):
            req = urllib.request.Request(
                self.url + path, data=body, method=method,
                headers={"Content-Type": "application/json",
                         PACKAGE_HEADER: PACKAGE})
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as rsp:
                    self._check_package(rsp.headers)
                    data = rsp.read()
                    return json.loads(data) if data else None
            except urllib.error.HTTPError as exc:
                self._check_package(exc.headers)
                if exc.code == 404:
                    return None
                detail = ""
                try:
                    detail = json.loads(exc.read()).get("error", "")
                except Exception:
                    pass
                raise RemoteStoreError(
                    f"{method} {self.url}{path} -> HTTP {exc.code}"
                    f"{': ' + detail if detail else ''}") from exc
            except (urllib.error.URLError, OSError) as exc:
                last = exc
                if attempt + 1 < attempts:
                    time.sleep(self.backoff * (2 ** attempt))
        raise RemoteStoreError(
            f"{method} {self.url}{path} unreachable after {attempts} "
            f"attempts: {last}") from last

    def _check_package(self, headers) -> None:
        got = headers.get(PACKAGE_HEADER) if headers is not None else None
        if got != PACKAGE:
            raise ForeignStoreError(
                f"store server {self.url} is not a {PACKAGE} store (its "
                f"answer names package {got!r}; the JAX package `repro`'s "
                f"server names none): the two packages keep their run "
                f"records apart, so serve a {PACKAGE} store with "
                f"`python -m {PACKAGE} serve`")

    # -------------------------------------------------------------- #
    # degradation / reconnect
    # -------------------------------------------------------------- #
    @property
    def degraded(self) -> bool:
        return self._down_since is not None

    def _mark_down(self) -> None:
        if self._down_since is None:
            self._down_since = time.time()
            warnings.warn(
                f"store server {self.url} unreachable — degrading to "
                f"local-only commits (retrying every "
                f"{self.retry_interval:g}s; pending records re-push on "
                f"reconnect)", RuntimeWarning, stacklevel=4)
        self._last_probe = time.time()

    def _up(self) -> bool:
        """True when the server should be attempted: healthy, or down but
        due for a probe (which also flushes pending records on success)."""
        if self._down_since is None:
            return True
        if time.time() - self._last_probe < self.retry_interval:
            return False
        self._last_probe = time.time()
        try:
            self._call("GET", "/ping", retries=1)
        except RemoteStoreError:
            return False
        self._down_since = None
        self.reconnects += 1
        self._flush_pending()
        return True

    def _flush_pending(self) -> None:
        for key in sorted(self.pending):
            rec = self.fallback.get(key)
            if rec is None:
                self.pending.discard(key)
                continue
            try:
                self._call("PUT", f"/runs/{key}", rec)
                self.pending.discard(key)
            except RemoteStoreError:
                self._mark_down()
                return

    def ping(self) -> dict | None:
        try:
            return self._call("GET", "/ping", retries=1)
        except RemoteStoreError:
            return None

    def metrics(self) -> dict | None:
        """The server's operator counters (None when unreachable)."""
        try:
            return self._call("GET", "/metrics", retries=1)
        except RemoteStoreError:
            return None

    # -------------------------------------------------------------- #
    # StoreBackend protocol
    # -------------------------------------------------------------- #
    def get(self, key: str) -> dict | None:
        if self._up():
            try:
                rec = self._call("GET", f"/runs/{key}")
                if rec is not None:
                    return rec
            except RemoteStoreError:
                self._mark_down()
        return self.fallback.get(key)

    def put(self, key: str, record: dict) -> None:
        if self._up():
            try:
                self._call("PUT", f"/runs/{key}", record)
                return
            except RemoteStoreError:
                self._mark_down()
        self.fallback.put(key, record)
        self.pending.add(key)

    def put_new(self, key: str, record: dict) -> bool:
        if self._up():
            try:
                rsp = self._call("PUT", f"/runs/{key}?if_absent=1", record)
                return bool(rsp["created"])
            except RemoteStoreError:
                self._mark_down()
        return self.fallback.put_new(key, record)

    def delete(self, key: str) -> bool:
        local = self.fallback.delete(key)
        self.pending.discard(key)
        if self._up():
            try:
                rsp = self._call("DELETE", f"/runs/{key}")
                return bool(rsp["deleted"]) or local
            except RemoteStoreError:
                self._mark_down()
        return local

    def keys(self) -> list[str]:
        if self._up():
            try:
                remote = self._call("GET", "/runs")["keys"]
                return sorted(set(remote) | set(self.fallback.keys()))
            except RemoteStoreError:
                self._mark_down()
        return self.fallback.keys()

    def age(self, key: str) -> float | None:
        # ages live on the server (file mtimes); remote GC goes through
        # server_gc instead of the generic keys+age+delete sweep
        return None

    # -------------------------------------------------------------- #
    # service extensions (RunStore discovers these by duck typing)
    # -------------------------------------------------------------- #
    def server_gc(self, ttl: float | None) -> list[str]:
        """Run TTL GC on the server; returns removed keys ([] when
        degraded — a GC can wait for reconnection)."""
        if not self._up():
            return []
        try:
            return self._call("POST", "/gc", {"ttl": ttl})["removed"]
        except RemoteStoreError:
            self._mark_down()
            return []

    def simdb_pull(self) -> SimDB | None:
        """The server's full memo DB (None when degraded)."""
        if not self._up():
            return None
        try:
            return SimDB.from_dict(self._call("GET", "/simdb"))
        except RemoteStoreError:
            self._mark_down()
            return None

    def simdb_push(self, entries: list[dict], fingerprint: str | None) -> bool:
        """Push a delta of memo entries for the server to merge; True on
        success (False leaves the caller's outbox intact for a retry)."""
        if not entries or not self._up():
            return False
        try:
            self._call("POST", "/simdb", {
                "format_version": FORMAT_VERSION,
                "fingerprint": fingerprint,
                "entries": entries,
            })
            return True
        except RemoteStoreError as exc:
            if "HTTP 409" in str(exc):
                raise SimDBMismatch(
                    f"store server {self.url} holds a SimDB from a "
                    f"different simulator regime: {exc}") from exc
            self._mark_down()
            return False


# ---------------------------------------------------------------------- #
# CLI entry (python -m repro_torch serve)
# ---------------------------------------------------------------------- #
def run_server(root: str, host: str = "127.0.0.1", port: int = 0,
               ttl: float | None = None, quiet: bool = False) -> int:
    """Blocking server loop for the CLI; prints the bound URL first (port
    0 binds an ephemeral port, so callers parse the line)."""
    server = StoreServer(root, host=host, port=port, ttl=ttl, quiet=quiet)
    print(f"serving campaign store at {server.url} "
          f"(root={root}, {len(server.store)} runs, "
          f"{len(server.db)} db entries"
          + (f", ttl={ttl:g}s" if ttl is not None else "") + ")",
          flush=True)
    server.serve_forever()
    return 0
