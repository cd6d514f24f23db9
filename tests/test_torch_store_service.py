"""The port's shared campaign-store service: served RunStore + mergeable
SimDB, on localhost.

Mirrors ``tests/test_store_service.py`` on ``repro_torch``: a sweep through
the served store returns RunResults bit-identical to the same sweep against
a local RunStore; a second host with empty local state gets warm wormhole
replays from the server; server loss mid-sweep degrades to local commits
with no lost or duplicated records on reconnect; two processes sweeping
overlapping scenario sets commit exactly N records; the CLI's ``serve`` and
``--store``.

This file doubles as the multi-host worker harness: run directly
(``python tests/test_torch_store_service.py URL LO HI``) it opens the
served campaign at URL and sweeps the overlap scenarios [LO, HI) with
claims on.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

from repro_torch.api import (Campaign, Engine, FlowSpec, RunResult, Scenario,
                             TopologySpec, compare, register_engine, run,
                             run_key, run_many)
from repro_torch.api.engines import _REGISTRY
from repro_torch.api.serve import RemoteBackend, StoreServer
from repro_torch.api.store import (CLAIM_PREFIX, LocalDirBackend, MemoryBackend,
                                   RunStore)
from repro_torch.core.memo import SimDB

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")


def svc_scenario(scale: float = 1.0, name: str = "svc") -> Scenario:
    flows = [FlowSpec(i, i % 4, 12 + (i % 2), size=2e5 * scale,
                      start=0.0, cca="dctcp") for i in range(4)]
    return Scenario(name, TopologySpec("clos", {"n_hosts": 16, "leaf_down": 4,
                                                "n_spines": 2}), flows=flows)


def waves_scenario(scale: float = 1.0, name: str = "svc-waves") -> Scenario:
    """Two identical flow waves — the repetition wormhole memoizes."""
    flows = []
    fid = 0
    for wave in (0.0, 0.02):
        for i in range(4):
            flows.append(FlowSpec(fid, i, 12 + (i % 2), size=4e6 * scale,
                                  start=wave, cca="dctcp"))
            fid += 1
    return Scenario(name, TopologySpec("clos", {"n_hosts": 16, "leaf_down": 4,
                                                "n_spines": 2}), flows=flows)


def overlap_scenarios(lo: int, hi: int) -> list[Scenario]:
    """The two-host overlap sweep — must build identically in both worker
    processes and the asserting parent (content-addressed keys)."""
    return [svc_scenario(1.0 + 0.05 * i, name=f"ov{i}") for i in range(lo, hi)]


class SvcCountingEngine(Engine):
    """Deterministic engine with wall_time=0.0, so two runs of the same
    scenario produce byte-identical records — the bit-identity probe."""
    calls = 0

    def run(self, scenario, **opts):
        type(self).calls += 1
        return RunResult(backend=self.name, scenario=scenario.name,
                         fcts={f.fid: 1.0 + f.size * 1e-9
                               for f in scenario.flows},
                         flow_bytes={f.fid: f.size for f in scenario.flows},
                         tags={f.fid: f.tag for f in scenario.flows},
                         iteration_time=1.0, events_processed=7,
                         wall_time=0.0, extras={})


@pytest.fixture
def svc_engine():
    register_engine("svc-counting")(SvcCountingEngine)
    SvcCountingEngine.calls = 0
    yield SvcCountingEngine
    _REGISTRY.pop("svc-counting", None)


@pytest.fixture
def server(tmp_path):
    srv = StoreServer(tmp_path / "served").start()
    yield srv
    srv.shutdown()


def _fast(remote: RemoteBackend) -> RemoteBackend:
    remote.retries, remote.backoff, remote.timeout = 1, 0.01, 10.0
    return remote


# --------------------------------------------------------------------- #
# the StoreBackend protocol: one contract, three transports
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["memory", "localdir", "remote"])
def test_backend_protocol_roundtrip(kind, tmp_path):
    srv = None
    if kind == "memory":
        b = MemoryBackend()
    elif kind == "localdir":
        b = LocalDirBackend(tmp_path / "runs")
    else:
        srv = StoreServer(tmp_path / "served").start()
        b = _fast(RemoteBackend(srv.url))
    try:
        ka, kb = "a" * 40, "b" * 40
        rec = {"record_version": 1, "key": ka, "x": [1, 2, {"y": "z"}]}
        assert b.get("0" * 40) is None
        b.put(ka, rec)
        assert b.get(ka) == rec
        assert b.put_new(ka, rec) is False          # already exists
        assert b.put_new(kb, {"record_version": 1, "key": kb}) is True
        assert b.keys() == [ka, kb]
        assert sorted(r["key"] for r in b.records()) == [ka, kb]
        assert b.delete(kb) is True and b.delete(kb) is False
        assert b.keys() == [ka]
        age = b.age(ka)
        if kind == "remote":
            assert age is None                      # ages live server-side
        else:
            assert age is not None and age >= 0.0
        b.close()
    finally:
        if srv is not None:
            srv.shutdown()


# --------------------------------------------------------------------- #
# satellite: put on an existing key verifies content, reports dedup
# --------------------------------------------------------------------- #
def test_put_verifies_content_on_existing_key(tmp_path, svc_engine):
    for store in (RunStore(tmp_path / "runs"), RunStore(None)):
        scn = svc_scenario()
        r1 = SvcCountingEngine().run(scn)
        key = run_key(scn, "svc-counting", {})
        assert store.put(key, scn, "svc-counting", {}, r1) is False  # fresh
        # same content modulo wall-clock: a dedup hit, nothing rewritten
        r2 = dataclasses.replace(r1, wall_time=123.0)
        assert store.put(key, scn, "svc-counting", {}, r2) is True
        assert store.get(key)["result"]["wall_time"] == 0.0
        # conflicting content: warn (nondeterminism canary) and overwrite
        r3 = dataclasses.replace(r1, fcts={0: 9.9})
        with pytest.warns(RuntimeWarning, match="different content"):
            assert store.put(key, scn, "svc-counting", {}, r3) is False
        assert store.get(key)["result"]["fcts"] == {"0": 9.9}


# --------------------------------------------------------------------- #
# claims: atomic, advisory, stealable
# --------------------------------------------------------------------- #
def test_claims_acquire_release_steal(tmp_path):
    store = RunStore(tmp_path / "runs")
    key = "a1" * 20
    assert store.claim(key, "w1") is True
    assert store.claim(key, "w1") is True           # re-entrant for owner
    assert store.claim(key, "w2") is False
    assert store.claim_owner(key) == "w1"
    # claims are invisible to the run-record API
    assert store.keys() == [] and len(store) == 0
    assert list(store.records()) == []
    store.release(key, "w2")                        # not yours: no-op
    assert store.claim_owner(key) == "w1"
    store.release(key, "w1")
    assert store.claim_owner(key) is None
    # expiry: a dead worker's claim is steal-able after its TTL
    assert store.claim(key, "w2", ttl=0.05) is True
    time.sleep(0.1)
    assert store.claim_owner(key) is None
    assert store.claim(key, "w3") is True
    assert store.claim_owner(key) == "w3"


def test_gc_expires_old_records_and_stale_claims(tmp_path, svc_engine):
    store = RunStore(tmp_path / "runs")
    scns = [svc_scenario(1.0 + i, name=f"gc{i}") for i in range(2)]
    keys = [run_key(s, "svc-counting", {}) for s in scns]
    for s, k in zip(scns, keys):
        store.put(k, s, "svc-counting", {}, SvcCountingEngine().run(s))
    store.claim(keys[1], "w", ttl=0.01)
    time.sleep(0.05)
    old = time.time() - 100
    os.utime(tmp_path / "runs" / f"{keys[0]}.json", (old, old))
    assert store.gc(None) == []                     # no TTL: records kept
    removed = store.gc(ttl=50)
    assert removed == [keys[0]]
    assert store.keys() == [keys[1]]
    # the stale claim went with the sweep
    assert not list((tmp_path / "runs").glob(f"{CLAIM_PREFIX}*"))


def test_remote_gc_runs_on_the_server(tmp_path, server, svc_engine):
    camp = Campaign.open(server.url)
    _fast(camp.remote)
    h_old = camp.submit(svc_scenario(1.0, name="old"), backend="svc-counting")
    h_new = camp.submit(svc_scenario(2.0, name="new"), backend="svc-counting")
    old = time.time() - 100
    os.utime(tmp_path / "served" / "runs" / f"{h_old.key}.json", (old, old))
    assert camp.gc(ttl=50) == [h_old.key]
    assert camp.store.peek(h_old.key) is None
    assert camp.store.peek(h_new.key) is not None
    camp.close()


# --------------------------------------------------------------------- #
# acceptance: served sweep is bit-identical to a local sweep
# --------------------------------------------------------------------- #
def test_served_sweep_bit_identical_to_local(tmp_path, server, svc_engine):
    scns = [svc_scenario(1.0 + 0.1 * i, name=f"bi{i}") for i in range(3)]
    local = Campaign.open(tmp_path / "localcamp")
    res_local = local.sweep(scns, backend="svc-counting")
    local_recs = {k: local.store.get(k) for k in local.store.keys()}
    local.close()

    remote = Campaign.open(server.url)
    _fast(remote.remote)
    res_remote = remote.sweep(scns, backend="svc-counting")
    # same results, same run_keys, same record JSON — byte for byte
    assert [r.to_dict() for r in res_remote] == \
        [r.to_dict() for r in res_local]
    remote_recs = {k: remote.store.get(k) for k in remote.store.keys()}
    assert remote_recs == local_recs
    remote.close()
    # and the wire really was JSON: the server's files parse to the same
    for k, rec in local_recs.items():
        on_disk = json.loads(
            (tmp_path / "served" / "runs" / f"{k}.json").read_text())
        assert on_disk == rec


def test_second_host_gets_warm_wormhole_replays(tmp_path, server):
    """Host A runs cold; host B (fresh process, empty local state) sees
    A's record as a cache hit and fast-forwards a *new* variant off the
    served SimDB — events collapse to the warm-sweep level."""
    a = Campaign.open(server.url)
    _fast(a.remote)
    cold = a.submit(waves_scenario(1.0, name="w1"), backend="wormhole").result
    a.close()

    b = Campaign.open(server.url)
    _fast(b.remote)
    assert b.submit(waves_scenario(1.0, name="w1"), backend="wormhole").cached
    warm = b.submit(waves_scenario(1.1, name="w2"), backend="wormhole").result
    assert warm.kernel_report["run_db_hits"] > 0
    assert warm.events_processed < cold.events_processed
    b.close()
    # both hosts' memo entries compounded on the server
    assert len(server.db) > 0


# --------------------------------------------------------------------- #
# acceptance: server loss mid-sweep — degrade, then recover losslessly
# --------------------------------------------------------------------- #
def test_server_loss_mid_sweep_degrades_and_recovers(tmp_path):
    server = StoreServer(tmp_path / "served").start()
    camp = Campaign.open(tmp_path / "local", store=server.url)
    remote = _fast(camp.remote)
    remote.retry_interval = 3600          # stay degraded once down
    scns = [svc_scenario(1.0 + 0.05 * i, name=f"k{i}") for i in range(6)]
    keys = [run_key(s, "analytic", {}) for s in scns]

    finished = []
    def chaos(event):
        if event.kind == "finished":
            finished.append(event.key)
            if len(finished) == 2:
                server.shutdown()         # kill the server mid-sweep
    camp.subscribe(chaos)
    with pytest.warns(RuntimeWarning, match="degrading to local-only"):
        results = camp.sweep(scns, backend="analytic")

    # the sweep completed: every result present, later commits went local
    assert all(r is not None for r in results)
    assert remote.degraded and len(remote.pending) == 4
    local_keys = set(RunStore(tmp_path / "local" / "runs").keys())
    assert local_keys == set(keys[2:]) | set(keys[:2]) - (set(keys[:2]) -
                                                          local_keys)
    assert set(keys[2:]) <= local_keys    # degraded commits are durable

    # restart on the same port; the next store op reconnects and flushes
    server2 = StoreServer(tmp_path / "served", port=server.port).start()
    try:
        remote.retry_interval = 0.0
        assert camp.store.peek(keys[-1]) is not None
        assert not remote.degraded and remote.reconnects == 1
        assert remote.pending == set()
        # no lost, no duplicated records: exactly the 6 sweep keys
        assert set(RunStore(tmp_path / "served" / "runs").keys()) == set(keys)

        # the store is resumable: a fresh host sweeps all-cache-hit
        fresh = Campaign.open(server2.url)
        _fast(fresh.remote)
        kinds = []
        fresh.subscribe(lambda e: kinds.append(e.kind))
        fresh.sweep(scns, backend="analytic")
        assert kinds.count("cache_hit") == 6 and "started" not in kinds
        fresh.close()
        camp.close()
    finally:
        server2.shutdown()


def test_unreachable_server_degrades_from_the_start(tmp_path):
    with pytest.warns(RuntimeWarning, match="degrading to local-only"):
        camp = Campaign.open(tmp_path / "local",
                             store="http://127.0.0.1:9")   # nothing there
    h = camp.submit(svc_scenario(name="iso"), backend="analytic")
    assert h.result is not None and not h.cached
    assert camp.remote.degraded and len(camp.remote.pending) == 1
    # the commit landed in the durable local fallback
    assert len(RunStore(tmp_path / "local" / "runs")) == 1
    camp.close()


def test_attaching_a_second_server_is_refused(tmp_path, server):
    camp = Campaign.open(tmp_path / "local", store=server.url)
    _fast(camp.remote)
    with pytest.raises(ValueError, match="already attached"):
        camp.sweep([svc_scenario()], backend="analytic",
                   store="http://127.0.0.1:9")
    camp.close()


# --------------------------------------------------------------------- #
# acceptance: two hosts, overlapping sweeps, exactly N records
# --------------------------------------------------------------------- #
def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_two_hosts_overlapping_sweeps_commit_exactly_n(tmp_path):
    """Two processes sweep overlapping scenario sets [0,8) and [2,10)
    against one server: claims split the overlap, both finish every
    result, and the store ends with exactly 10 untorn records."""
    server = StoreServer(tmp_path / "served").start()
    try:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             server.url, str(lo), str(hi)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for lo, hi in ((0, 8), (2, 10))]
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, (out, err)
            assert "worker done: 8" in out
    finally:
        server.shutdown()
    store = RunStore(tmp_path / "served" / "runs")
    expected = {run_key(s, "analytic", {}) for s in overlap_scenarios(0, 10)}
    assert set(store.keys()) == expected            # exactly N, no extras
    recs = list(store.records())                    # every record parses
    assert len(recs) == 10 and store.corrupt_keys() == []
    for rec in recs:
        RunResult.from_dict(rec["result"])
    # no leftover claim markers
    assert not list((tmp_path / "served" / "runs").glob(f"{CLAIM_PREFIX}*"))


# --------------------------------------------------------------------- #
# satellite: unified engine-option validation
# --------------------------------------------------------------------- #
def test_unknown_engine_opts_raise_shared_error(svc_engine):
    with pytest.raises(ValueError, match="does not accept"):
        run(svc_scenario(), backend="analytic", fidelity="auto")
    with pytest.raises(ValueError, match="accepted opts: until"):
        run(svc_scenario(), backend="analytic", bogus=1)
    with pytest.raises(ValueError, match="'packet' does not accept"):
        Campaign.in_memory().sweep([svc_scenario()], backend="packet",
                                   fidelity="flow")
    with pytest.raises(ValueError, match="does not accept"):
        run_many([svc_scenario()], backend="hybrid", parallel="partitions")
    # engines that have not declared option_names stay unvalidated
    r = run(svc_scenario(), backend="svc-counting", anything_goes=1)
    assert r is not None


def test_compare_backend_opts_scope_and_validate(svc_engine):
    cmp = compare(svc_scenario(), backends=("analytic", "svc-counting"),
                  backend_opts={"svc-counting": {"private": 1}})
    assert set(cmp.results) == {"analytic", "svc-counting"}
    with pytest.raises(ValueError, match="backend_opts"):
        compare(svc_scenario(), backends=("analytic",),
                backend_opts={"packet": {"until": 1.0}})


# --------------------------------------------------------------------- #
# satellite: db_path=/save_db= shim removed; GET /metrics counters
# --------------------------------------------------------------------- #
def test_db_path_engine_kwargs_removed(tmp_path):
    """The deprecation shim is gone: db_path=/save_db= now fail like
    any unknown engine opt, and the campaign replacement stays silent."""
    with pytest.raises(ValueError, match="does not accept"):
        run(waves_scenario(1.1, name="dep2"), backend="wormhole",
            db_path=str(tmp_path / "db.json"), save_db=False)
    import warnings as _w
    with _w.catch_warnings():
        _w.simplefilter("error", DeprecationWarning)
        with Campaign.open(tmp_path / "camp") as camp:
            camp.submit(waves_scenario(1.2, name="dep3"), backend="wormhole")


def test_metrics_counts_store_claims_and_dedup(server):
    b = _fast(RemoteBackend(server.url))
    m0 = b.metrics()
    assert m0["store_gets"] == 0 and m0["store_hit_rate"] is None
    assert m0["simdb_replay_rate"] is None

    key, ck = "m" * 40, CLAIM_PREFIX + "m" * 40
    rec = {"record_version": 1, "key": key}
    assert b.get(key) is None                       # miss
    b.put(key, rec)
    assert b.get(key) == rec                        # hit
    b.put(key, dict(rec))                           # same content: dedup

    # claim lifecycle: create, reject the loser, release — none of it
    # pollutes the store hit/miss counters
    assert b.put_new(ck, {"owner": "w1", "t": time.time(), "ttl": 600}) is True
    assert b.put_new(ck, {"owner": "w2", "t": time.time(), "ttl": 600}) is False
    assert b.delete(ck) is True

    m = b.metrics()
    assert m["store_gets"] == 2
    assert m["store_misses"] == 1 and m["store_hits"] == 1
    assert m["store_hit_rate"] == 0.5
    assert m["store_puts"] == 2 and m["dedup_hits"] == 1
    assert m["claim_creates"] == 1 and m["claim_rejects"] == 1
    assert m["claim_releases"] == 1 and m["claim_steals"] == 0
    assert m["runs"] == 1


def test_metrics_counts_claim_steals_and_simdb_replay(server):
    remote = _fast(RemoteBackend(server.url))
    store = RunStore(backend=remote)
    key = "s1" * 20
    assert store.claim(key, "w1", ttl=0.05) is True
    time.sleep(0.1)
    assert store.claim(key, "w2") is True           # stale claim: stolen
    m = remote.metrics()
    assert m["claim_creates"] == 1 and m["claim_steals"] == 1

    # the same memo delta pushed twice: the second push is pure replay
    db = SimDB()
    run(waves_scenario(1.0, name="mx"), backend="wormhole", db=db)
    assert len(db) > 0
    payload = db.to_dict()
    assert remote.simdb_push(payload["entries"], payload["fingerprint"])
    m1 = remote.metrics()
    assert m1["simdb_pushes"] == 1
    # merge dedups isomorphic entries, so added <= pushed even when cold
    assert 0 < m1["simdb_entries_added"] == m1["db_entries"]
    assert remote.simdb_push(payload["entries"], payload["fingerprint"])
    assert remote.simdb_pull() is not None
    m = remote.metrics()
    assert m["simdb_pushes"] == 2 and m["simdb_pulls"] == 1
    assert m["simdb_entries_pushed"] == 2 * len(db)
    # the second push was pure replay: nothing new landed
    assert m["simdb_entries_added"] == m1["simdb_entries_added"]
    assert m["simdb_replay_rate"] == pytest.approx(
        1.0 - m["simdb_entries_added"] / m["simdb_entries_pushed"])
    assert m["simdb_replay_rate"] >= 0.5


# --------------------------------------------------------------------- #
# CLI: serve + remote clients
# --------------------------------------------------------------------- #
def _cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch", *args],
                          env=_env(), capture_output=True, text=True,
                          timeout=300)


def test_cli_serve_and_remote_ls_show_rm(tmp_path):
    scn_file = tmp_path / "svc.json"
    scn_file.write_text(svc_scenario(name="cli-svc").to_json())
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "serve", "-c",
         str(tmp_path / "served"), "--port", "0", "-q"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert "serving campaign store at http://" in line, line
        url = line.split()[4]

        out = _cli("run", str(scn_file), "--backend", "analytic", "-c", url)
        assert out.returncode == 0, out.stderr
        out = _cli("run", str(scn_file), "--backend", "analytic", "-c", url)
        assert out.returncode == 0 and "cache hit" in out.stdout

        out = _cli("ls", "-c", url)
        assert out.returncode == 0 and "analytic" in out.stdout
        assert "1 stored runs" in out.stdout
        key = out.stdout.split()[0]

        out = _cli("show", key, "-c", url)
        assert out.returncode == 0
        assert json.loads(out.stdout)["scenario"]["name"] == "cli-svc"

        out = _cli("rm", key, "-c", url)
        assert out.returncode == 0 and "removed 1" in out.stdout
        assert "0 stored runs" in _cli("ls", "-c", url).stdout
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_cli_scoped_opts(tmp_path):
    scn_file = tmp_path / "svc.json"
    scn_file.write_text(svc_scenario(name="cli-opts").to_json())
    # a scoped opt for a backend this command will not run is an error
    out = _cli("run", str(scn_file), "--backend", "analytic",
               "--opt", "packet:until=1.0")
    assert out.returncode != 0 and "scoped" in (out.stdout + out.stderr)
    # compare fans scoped opts to their backend only
    out = _cli("compare", str(scn_file), "--backends", "analytic,packet",
               "--opt", "packet:record_rtt=[0]")
    assert out.returncode == 0, out.stderr
    assert "analytic" in out.stdout and "packet" in out.stdout
    # unknown opt fails loudly with the accepted list
    out = _cli("run", str(scn_file), "--backend", "analytic",
               "--opt", "bogus=1")
    assert out.returncode != 0
    assert "does not accept" in (out.stdout + out.stderr)


if __name__ == "__main__":
    # multi-host worker harness (see module docstring)
    url, lo, hi = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    camp = Campaign.open(url)
    results = camp.sweep(overlap_scenarios(lo, hi), backend="analytic",
                         poll=0.05)
    assert all(r is not None for r in results)
    camp.close()
    print(f"worker done: {len(results)}")
