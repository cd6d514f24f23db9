"""The port's campaigns: durable, resumable, observable experiment sessions.

Mirrors ``tests/test_campaign.py`` on ``repro_torch`` (a counting engine in
the port's registry, the kill-mid-sweep resume with this file run as a
script, the CLI through ``python -m repro_torch``), the five process-parallel
``run_many`` tests of ``tests/test_persist.py``, and the port's own rules:
``fluid`` and ``learned`` never leave the card on their own (through a
campaign, its spawn workers and the CLI), and a campaign directory belongs
to one package.

This file doubles as the crash harness for the kill-mid-sweep test: run
directly (``python tests/test_torch_campaign.py CAMPAIGN_DIR K``) it starts
the sweep and hard-exits (``os._exit``: no atexit, no close, no flush)
after K committed runs.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.api import (Campaign, Engine, FlowSpec, RunResult, Scenario,
                             SimDB, TopologySpec, register_engine, run, run_key,
                             run_many)
from repro_torch.api.engines import _REGISTRY
from repro_torch.api.store import RunStore, scenario_fingerprint
from repro_torch.device import NoCardError

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
CPU = {"device": "cpu"}


def flows_scenario(scale: float = 1.0, name: str = "camp-waves") -> Scenario:
    flows = []
    fid = 0
    for wave in (0.0, 0.02):
        for i in range(4):
            flows.append(FlowSpec(fid, i, 12 + (i % 2), size=4e6 * scale,
                                  start=wave, cca="dctcp"))
            fid += 1
    return Scenario(name, TopologySpec("clos", {"n_hosts": 16, "leaf_down": 4,
                                                "n_spines": 2}), flows=flows)


def wave_scenario(size_scale: float = 1.0, name: str = "waves", **sim) -> Scenario:
    """``tests/test_api.py``'s wave pattern (8 MB flows), as ``test_persist``
    uses it."""
    flows = []
    fid = 0
    for wave in (0.0, 0.02):
        for i in range(4):
            flows.append(FlowSpec(fid, i, 12 + (i % 2), size=8e6 * size_scale,
                                  start=wave, cca="dctcp", tag=f"wave@{wave}"))
            fid += 1
    return Scenario(name, TopologySpec("clos", {"n_hosts": 16, "leaf_down": 4,
                                                "n_spines": 2}),
                    flows=flows, sim=dict(sim))


def sweep_scenarios(n: int = 6) -> list[Scenario]:
    """The kill-mid-sweep scenario list: it must build identically in the
    crash subprocess and the resuming parent (content-addressed keys)."""
    return [flows_scenario(1.0 + 0.1 * i, name=f"sw{i}") for i in range(n)]


class CountingEngine(Engine):
    """Registry-pluggable engine that counts invocations: how the tests
    prove a cache hit never reached an engine."""
    calls = 0

    def run(self, scenario, **opts):
        type(self).calls += 1
        return RunResult(backend=self.name, scenario=scenario.name,
                         fcts={f.fid: 1.0 + f.size * 1e-9 for f in scenario.flows},
                         flow_bytes={f.fid: f.size for f in scenario.flows},
                         tags={f.fid: f.tag for f in scenario.flows},
                         iteration_time=1.0, events_processed=7,
                         wall_time=0.0, extras={"probe": [1, 2]})


@pytest.fixture
def counting_engine():
    register_engine("counting")(CountingEngine)
    CountingEngine.calls = 0
    yield CountingEngine
    _REGISTRY.pop("counting", None)


# --------------------------------------------------------------------- #
# RunStore + keys
# --------------------------------------------------------------------- #
def test_run_key_is_content_addressed():
    a, b = flows_scenario(), flows_scenario()
    assert scenario_fingerprint(a) == scenario_fingerprint(b)
    assert run_key(a, "packet", {}) == run_key(b, "packet", {})
    assert run_key(a, "packet", {}) != run_key(a, "wormhole", {})
    assert run_key(a, "packet", {}) != run_key(a, "packet", {"until": 1.0})
    assert run_key(flows_scenario(1.1), "packet", {}) != run_key(a, "packet", {})
    assert run_key(a, "hybrid", {"fidelity": "auto", "demote_after": 4}) == \
        run_key(a, "hybrid", {"demote_after": 4, "fidelity": "auto"})
    # the device is an opt: a CPU record never answers for the card's
    assert run_key(a, "fluid", CPU) != run_key(a, "fluid", {})


def test_run_key_uncacheable_and_array_opts():
    scn = flows_scenario()
    db = SimDB()
    assert run_key(scn, "wormhole", {"db": db}) != run_key(scn, "wormhole", {"db": db})
    big = np.arange(2000)
    near = big.copy()
    near[1000] = -1                       # differs only in the repr-elided middle
    assert run_key(scn, "packet", {"x": big}) == run_key(scn, "packet", {"x": big.copy()})
    assert run_key(scn, "packet", {"x": big}) != run_key(scn, "packet", {"x": near})


def test_run_store_disk_roundtrip(tmp_path, counting_engine):
    store = RunStore(tmp_path / "runs")
    scn = flows_scenario()
    result = CountingEngine().run(scn)
    key = run_key(scn, "counting", {})
    assert store.get(key) is None and store.misses == 1
    store.put(key, scn, "counting", {}, result)
    assert key in store and len(store) == 1 and store.keys() == [key]
    rec = store.get(key)
    assert store.hits == 1
    assert rec["backend"] == "counting"
    assert rec["scenario"] == scn.to_dict()
    assert RunResult.from_dict(rec["result"]).to_dict() == result.to_dict()
    assert [p.name for p in (tmp_path / "runs").iterdir()] == [f"{key}.json"]
    again = RunStore(tmp_path / "runs")
    assert again.get(key) == rec
    assert again.delete(key) and not again.delete(key)
    assert len(again) == 0


def test_run_store_rejects_foreign_record_version(tmp_path, counting_engine):
    store = RunStore(tmp_path / "runs")
    scn = flows_scenario()
    key = run_key(scn, "counting", {})
    store.put(key, scn, "counting", {}, CountingEngine().run(scn))
    rec = json.loads((tmp_path / "runs" / f"{key}.json").read_text())
    rec["record_version"] = 99
    (tmp_path / "runs" / f"{key}.json").write_text(json.dumps(rec))
    with pytest.raises(ValueError, match="record_version"):
        store.get(key)


def test_records_skips_corrupt_files_with_warning(tmp_path, counting_engine):
    store = RunStore(tmp_path / "runs")
    scns = [flows_scenario(1.0 + 0.1 * i, name=f"c{i}") for i in range(3)]
    keys = [run_key(s, "counting", {}) for s in scns]
    for scn, key in zip(scns, keys):
        store.put(key, scn, "counting", {}, CountingEngine().run(scn))
    bad = tmp_path / "runs" / f"{keys[1]}.json"
    bad.write_text(bad.read_text()[:40])             # torn copy
    with pytest.warns(RuntimeWarning, match="corrupt run record"):
        recs = list(store.records())
    assert [r["key"] for r in recs] == sorted([keys[0], keys[2]])
    assert store.corrupt_keys() == [keys[1]]
    assert store.get(keys[1]) is None and keys[1] not in store
    store.put(keys[1], scns[1], "counting", {}, CountingEngine().run(scns[1]))
    assert store.corrupt_keys() == [] and store.get(keys[1]) is not None
    assert len(list(store.records())) == 3


def test_campaign_resubmit_heals_corrupt_record(tmp_path, counting_engine):
    with Campaign.open(tmp_path / "camp") as camp:
        h = camp.submit(flows_scenario(), backend="counting")
        rec_file = tmp_path / "camp" / "runs" / f"{h.key}.json"
        rec_file.write_text("{not json")
        with pytest.warns(RuntimeWarning, match="corrupt"):
            h2 = camp.submit(flows_scenario(), backend="counting")
    assert not h2.cached and CountingEngine.calls == 2
    assert json.loads(rec_file.read_text())["key"] == h.key


def test_run_store_in_memory_matches_disk_shape(tmp_path, counting_engine):
    scn = flows_scenario()
    result = CountingEngine().run(scn)
    key = run_key(scn, "counting", {})
    mem, disk = RunStore(None), RunStore(tmp_path / "runs")
    mem.put(key, scn, "counting", {}, result)
    disk.put(key, scn, "counting", {}, result)
    assert mem.get(key) == disk.get(key)


# --------------------------------------------------------------------- #
# submit: dedup without invoking the engine
# --------------------------------------------------------------------- #
def test_submit_dedup_skips_engine(tmp_path, counting_engine):
    camp = Campaign.open(tmp_path / "camp", name="dedup")
    events = []
    camp.subscribe(lambda e: events.append(e.kind))
    h1 = camp.submit(flows_scenario(), backend="counting")
    h2 = camp.submit(flows_scenario(), backend="counting")
    assert CountingEngine.calls == 1
    assert not h1.cached and h2.cached and h1.key == h2.key
    assert events == ["started", "finished", "cache_hit"]
    assert h2.result.to_dict() == h1.result.to_dict()
    assert h2.result.to_dict() == json.loads(json.dumps(h1.result.to_dict()))
    assert h2.result.fcts == h1.result.fcts          # int keys restored
    camp.submit(flows_scenario(), backend="counting", until=2.0)
    assert CountingEngine.calls == 2
    camp.close()


def test_submit_dedup_survives_reopen(tmp_path, counting_engine):
    camp = Campaign.open(tmp_path / "camp")
    first = camp.submit(flows_scenario(), backend="counting").result
    camp.close()
    camp2 = Campaign.open(tmp_path / "camp")
    h = camp2.submit(flows_scenario(), backend="counting")
    assert h.cached and CountingEngine.calls == 1
    assert h.result.to_dict() == first.to_dict()
    camp2.close()


def test_sweep_dedups_identical_scenarios_within_one_call(counting_engine):
    camp = Campaign.in_memory()
    kinds = []
    camp.subscribe(lambda e: kinds.append(e.kind))
    results = camp.sweep([flows_scenario(), flows_scenario(),
                          flows_scenario(1.5, name="other")], backend="counting")
    assert CountingEngine.calls == 2
    assert kinds.count("cache_hit") == 1
    assert results[0].fcts == results[1].fcts
    assert results[2].scenario == "other"


# --------------------------------------------------------------------- #
# durable campaign invariants
# --------------------------------------------------------------------- #
def test_durable_campaign_owns_its_simdb(tmp_path):
    with pytest.raises(ValueError, match="owns its SimDB"):
        Campaign(tmp_path / "camp", db=SimDB())
    camp = Campaign.open(tmp_path / "camp")
    with pytest.raises(ValueError, match="owns its SimDB"):
        camp.submit(flows_scenario(), backend="wormhole", db=SimDB())
    with pytest.raises(ValueError, match="owns its SimDB"):
        camp.sweep([flows_scenario()], backend="wormhole", db=SimDB())
    camp.close()


def test_manifest_roundtrip_and_version_check(tmp_path):
    camp = Campaign.open(tmp_path / "camp", name="paper-sweeps")
    camp.close()
    assert Campaign.open(tmp_path / "camp").name == "paper-sweeps"
    manifest = tmp_path / "camp" / "campaign.json"
    assert json.loads(manifest.read_text()) == {
        "manifest_version": 2, "name": "paper-sweeps", "package": "repro_torch"}
    manifest.write_text(json.dumps({"manifest_version": 99, "package": "repro_torch"}))
    with pytest.raises(ValueError, match="manifest_version"):
        Campaign.open(tmp_path / "camp")
    # a manifest that does not name the port is another package's campaign
    manifest.write_text(json.dumps({"manifest_version": 2, "name": "x"}))
    with pytest.raises(ValueError, match="not a repro_torch campaign"):
        Campaign.open(tmp_path / "camp")


def test_campaign_simdb_warms_across_sessions(tmp_path):
    camp = Campaign.open(tmp_path / "camp")
    cold = camp.submit(flows_scenario(1.0, name="v1"), backend="wormhole").result
    camp.close()
    assert (tmp_path / "camp" / "simdb.json").exists()
    camp2 = Campaign.open(tmp_path / "camp")
    warm = camp2.submit(flows_scenario(1.1, name="v2"), backend="wormhole").result
    assert warm.kernel_report["run_db_hits"] > 0
    assert warm.events_processed < cold.events_processed
    camp2.close()


def test_results_and_records_filters(counting_engine):
    camp = Campaign.in_memory()
    camp.submit(flows_scenario(name="a"), backend="counting")
    camp.submit(flows_scenario(name="b"), backend="counting")
    camp.submit(flows_scenario(name="a"), backend="analytic")
    assert len(camp.results()) == 3 and len(camp) == 3
    assert len(camp.results(backend="counting")) == 2
    assert {r["scenario"]["name"] for r in camp.records(backend="analytic")} == {"a"}
    assert len(camp.results(scenario="a")) == 2
    assert all(isinstance(r, RunResult) for r in camp.results())


def test_campaign_compare_hits_store_on_repeat(counting_engine):
    camp = Campaign.in_memory()
    cmp1 = camp.compare(flows_scenario(), backends=("counting", "analytic"))
    calls = CountingEngine.calls
    cmp2 = camp.compare(flows_scenario(), backends=("counting", "analytic"))
    assert CountingEngine.calls == calls
    assert cmp2["counting"].to_dict() == cmp1["counting"].to_dict()
    with pytest.raises(ValueError, match="baseline"):
        camp.compare(flows_scenario(), backends=("counting",), baseline="analytic")


def test_observer_unsubscribe(counting_engine):
    camp = Campaign.in_memory()
    seen = []
    cb = camp.subscribe(lambda e: seen.append(e.kind))
    camp.submit(flows_scenario(), backend="counting")
    camp.unsubscribe(cb)
    camp.submit(flows_scenario(1.2, name="other"), backend="counting")
    assert seen == ["started", "finished"]


def test_fluid_sweep_batches_and_serves_from_the_store(tmp_path):
    """A serial fluid sweep goes through the engine's padded batch (one
    ``fluid_scan`` for the flow scenarios); reopened, it is cache hits."""
    from repro_torch.kernels.cca_step import fluid_scan
    scns = [flows_scenario(1.0 + 0.1 * i, name=f"f{i}") for i in range(3)]
    fluid_scan.launches = 0
    with Campaign.open(tmp_path / "camp") as camp:
        first = camp.sweep(scns, backend="fluid", **CPU)
    assert fluid_scan.launches == 0          # CPU tensors take the plain version
    assert [r.extras["batch_wall"] > 0 for r in first] == [True] * 3
    kinds = []
    with Campaign.open(tmp_path / "camp") as camp:
        camp.subscribe(lambda e: kinds.append(e.kind))
        again = camp.sweep(scns, backend="fluid", **CPU)
    assert kinds == ["cache_hit"] * 3
    assert [r.to_dict() for r in again] == \
        [json.loads(json.dumps(r.to_dict())) for r in first]


# --------------------------------------------------------------------- #
# the acceptance test: kill mid-sweep, re-open, resume
# --------------------------------------------------------------------- #
def _env(**extra):
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_kill_mid_sweep_resume(tmp_path):
    cdir = str(tmp_path / "camp")
    n, k = 6, 3
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), cdir, str(k)],
                          env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 17, (proc.stdout, proc.stderr)

    camp = Campaign.open(cdir)
    assert len(camp.store) == k
    stored_before = {key: camp.store._peek(key) for key in camp.store.keys()}

    events = []
    camp.subscribe(events.append)
    results = camp.sweep(sweep_scenarios(n), backend="analytic")
    kinds = [e.kind for e in events]
    assert kinds.count("cache_hit") == k
    assert kinds.count("started") == kinds.count("finished") == n - k
    assert all(r is not None for r in results)
    hit_keys = {e.key for e in events if e.kind == "cache_hit"}
    assert hit_keys == set(stored_before)
    for e in events:
        if e.kind == "cache_hit":
            assert e.result.to_dict() == stored_before[e.key]["result"]

    h = camp.submit(sweep_scenarios(n)[0], backend="analytic")
    assert h.cached
    assert h.result.to_dict() == results[0].to_dict()
    camp.close()

    camp2 = Campaign.open(cdir)
    kinds2 = []
    camp2.subscribe(lambda e: kinds2.append(e.kind))
    camp2.sweep(sweep_scenarios(n), backend="analytic")
    assert kinds2.count("cache_hit") == n and "started" not in kinds2
    camp2.close()


@pytest.mark.slow
def test_parallel_sweep_resume_with_workers(tmp_path):
    cdir = tmp_path / "camp"
    scns = [flows_scenario(1.0 + 0.1 * i, name=f"p{i}") for i in range(4)]
    camp = Campaign.open(cdir)
    camp.sweep(scns[:2], backend="wormhole", workers=2)
    camp.close()
    camp2 = Campaign.open(cdir)
    kinds = []
    camp2.subscribe(lambda e: kinds.append(e.kind))
    results = camp2.sweep(scns, backend="wormhole", workers=2)
    assert kinds.count("cache_hit") == 2
    assert kinds.count("finished") == 2
    assert [r.scenario for r in results] == [s.name for s in scns]
    assert len(camp2.db) > 0
    camp2.close()


# --------------------------------------------------------------------- #
# process-parallel run_many (tests/test_persist.py, on the port)
# --------------------------------------------------------------------- #
def test_run_many_workers_matches_serial_fcts():
    scns = [wave_scenario(s, name=f"w{s:g}") for s in (1.0, 1.15, 1.3)]
    serial = run_many(scns, backend="wormhole")
    par = run_many(scns, backend="wormhole", workers=2)
    assert [r.scenario for r in par] == [s.name for s in scns]
    for rs, rp in zip(serial, par):
        assert rs.fcts == rp.fcts
        assert rs.events_processed == rp.events_processed


def test_run_many_parallel_delta_merges_into_warm_db():
    scns = [wave_scenario(s, name=f"w{s:g}") for s in (1.0, 1.1)]
    db = SimDB()
    cold = run_many(scns, backend="wormhole", workers=2, db=db)
    assert len(db) > 0
    assert db.fingerprint is not None
    assert len(db) < sum(r.kernel_report["db_inserts"] for r in cold)
    warm = run(wave_scenario(1.2, name="w1.2"), backend="wormhole", db=db)
    assert warm.kernel_report["run_db_hits"] > 0
    assert warm.events_processed < min(r.events_processed for r in cold) / 10


def test_explicit_simdb_roundtrip_cross_session(tmp_path):
    path = str(tmp_path / "simdb.json")
    scns = [wave_scenario(s, name=f"w{s:g}") for s in (1.0, 1.1, 1.2)]
    cold_db = SimDB()
    run_many(scns[:2], backend="wormhole", workers=2, db=cold_db)
    cold_db.save(path)
    assert os.path.exists(path)
    mem_db = SimDB()
    run_many(scns[:2], backend="wormhole", db=mem_db)
    mem_warm = run(scns[2], backend="wormhole", db=mem_db)
    disk_warm = run_many([scns[2]], backend="wormhole", workers=2,
                         db=SimDB.load_or_new(path))[0]
    assert disk_warm.kernel_report["run_db_hits"] > 0
    assert disk_warm.fcts == mem_warm.fcts
    assert disk_warm.events_processed == mem_warm.events_processed
    base = run(scns[2], backend="packet")
    assert disk_warm.fct_errors_vs(base).mean() < 0.01


def test_run_many_db_opts_rejected_for_other_backends():
    with pytest.raises(ValueError, match="wormhole"):
        run_many([wave_scenario()], backend="packet", db=SimDB())
    with pytest.raises(ValueError, match="wormhole"):
        run_many([wave_scenario()], backend="fluid", workers=2, shared_db=True)


def test_removed_db_path_opts_fail_loudly(tmp_path):
    with pytest.raises(ValueError, match="does not accept"):
        run(wave_scenario(), backend="wormhole", db_path=str(tmp_path / "db.json"))
    with pytest.raises(ValueError, match="does not accept"):
        run_many([wave_scenario()], backend="wormhole", save_db=False)


# --------------------------------------------------------------------- #
# no quiet fallback: fluid and learned need the card or device="cpu"
# --------------------------------------------------------------------- #
def test_fluid_and_learned_without_a_card_raise_through_campaigns(monkeypatch, tmp_path):
    """In this process (``torch.cuda.is_available`` patched out) and in the
    spawn workers (no visible card): a run raises, nothing is committed;
    a stored result is still served, since serving runs nothing."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    scns = [flows_scenario(1.0 + 0.1 * i, name=f"n{i}") for i in range(2)]
    with Campaign.open(tmp_path / "camp") as camp:
        for backend in ("fluid", "learned"):
            with pytest.raises(NoCardError, match="none is available"):
                camp.submit(scns[0], backend=backend)
            with pytest.raises(NoCardError, match="none is available"):
                camp.sweep(scns, backend=backend)
        assert len(camp.store) == 0
        camp.sweep(scns, backend="fluid", **CPU)
        assert camp.submit(scns[0], backend="fluid", **CPU).cached
    with pytest.raises(NoCardError, match="none is available"):
        run_many(scns, backend="fluid", workers=2)


def test_learned_engine_through_campaign_sweep(tmp_path):
    """``tests/test_learned.py::test_engine_through_campaign_sweep`` on the
    port: the learned engine rides a campaign (params by path, so the runs
    stay cacheable), fitted from a campaign's own records."""
    from repro_torch.learned import fit, model
    with Campaign.in_memory(name="learned-test") as truth:
        truth.sweep([wave_scenario(0.5 + 0.1 * i, name=f"tw{i}") for i in range(16)],
                    backend="hybrid", fidelity="flow")
        params = fit(truth.export_dataset(), seed=0, hidden=(16, 16), steps=250, **CPU)
    path = tmp_path / "params.json"
    model.save(params, path)
    scns = [wave_scenario(s, name=f"c{s:g}") for s in (0.9, 1.1)]
    with Campaign.open(tmp_path / "camp") as camp:
        first = camp.sweep(scns, backend="learned", params=str(path), **CPU)
        again = camp.sweep(scns, backend="learned", params=str(path), **CPU)
    assert [r.fcts for r in first] == [r.fcts for r in again]
    assert camp.store.hits >= 2


# --------------------------------------------------------------------- #
# CLI (python -m repro_torch) over the same API
# --------------------------------------------------------------------- #
def _cli(*args, cwd=None, **env):
    return subprocess.run([sys.executable, "-m", "repro_torch", *args],
                          env=_env(**env), capture_output=True, text=True,
                          cwd=cwd, timeout=300)


def test_cli_run_ls_show_rm_roundtrip(tmp_path):
    scn_file = tmp_path / "demo.json"
    scn_file.write_text(flows_scenario(name="cli-demo").to_json())
    cdir = str(tmp_path / "camp")

    out = _cli("run", str(scn_file), "--backend", "analytic", "-c", cdir)
    assert out.returncode == 0, out.stderr
    assert "cli-demo" in out.stdout and "running" in out.stdout

    out = _cli("run", str(scn_file), "--backend", "analytic", "-c", cdir)
    assert out.returncode == 0 and "cache hit" in out.stdout

    out = _cli("sweep", str(scn_file), "--backend", "analytic", "-c", cdir)
    assert out.returncode == 0, out.stderr
    assert "1 from the store, 0 simulated" in out.stdout

    out = _cli("ls", "-c", cdir)
    assert out.returncode == 0 and "analytic" in out.stdout
    key = out.stdout.split()[0]

    out = _cli("show", key, "-c", cdir)
    assert out.returncode == 0
    rec = json.loads(out.stdout)
    assert rec["backend"] == "analytic"
    assert rec["scenario"]["name"] == "cli-demo"

    assert _cli("show", "deadbeef", "-c", cdir).returncode == 1
    _cli("run", str(scn_file), "--backend", "packet", "-c", cdir)
    bad = _cli("rm", "", "-c", cdir)
    assert bad.returncode == 1 and "ambiguous" in bad.stderr
    out = _cli("rm", key, "-c", cdir)
    assert out.returncode == 0 and "removed 1" in out.stdout
    assert "1 stored runs" in _cli("ls", "-c", cdir).stdout


def test_cli_engine_opts_reach_the_engine(tmp_path):
    scn_file = tmp_path / "demo.json"
    scn_file.write_text(flows_scenario(name="cli-opts").to_json())
    out = _cli("run", str(scn_file), "--backend", "hybrid", "--opt", "fidelity=flow")
    assert out.returncode == 0, out.stderr
    bad = _cli("run", str(scn_file), "--backend", "hybrid", "--opt", "fidelity=warp")
    assert bad.returncode != 0


def test_cli_fluid_needs_the_card_or_cpu_and_fit_records_its_device(tmp_path):
    """With no visible card, ``--backend fluid`` exits 1 with the reason
    and ``--opt device=cpu`` runs; ``fit --device cpu`` fits from a
    campaign directory and records the device in its params file."""
    scn_file = tmp_path / "demo.json"
    scn_file.write_text(flows_scenario(name="cli-fluid").to_json())
    nocard = {"CUDA_VISIBLE_DEVICES": ""}
    out = _cli("run", str(scn_file), "--backend", "fluid", **nocard)
    assert out.returncode == 1 and "none is available" in out.stderr, out.stderr
    assert "Traceback" not in out.stderr
    out = _cli("run", str(scn_file), "--backend", "fluid", "--opt", "device=cpu", **nocard)
    assert out.returncode == 0 and "iteration time" in out.stdout, out.stderr

    cdir = tmp_path / "camp"
    with Campaign.open(cdir) as camp:
        camp.sweep([wave_scenario(0.5 + 0.1 * i, name=f"tw{i}") for i in range(16)],
                   backend="hybrid", fidelity="flow")
    params = tmp_path / "params.json"
    out = _cli("fit", str(cdir), "--out", str(params), "--steps", "60", **nocard)
    assert out.returncode == 1 and "none is available" in out.stderr
    out = _cli("fit", str(cdir), "--out", str(params), "--steps", "60",
               "--hidden", "16,16", "--device", "cpu", **nocard)
    assert out.returncode == 0, out.stderr
    assert "on cpu" in out.stdout and "held-out mean FCT error" in out.stdout
    assert json.loads(params.read_text())["train"]["device"] == "cpu"


if __name__ == "__main__":
    # crash harness: sweep, then hard-exit (no atexit/close) after K commits
    cdir, k = sys.argv[1], int(sys.argv[2])
    camp = Campaign.open(cdir)
    done = [0]

    def _chaos(event):
        if event.kind == "finished":
            done[0] += 1
            if done[0] >= k:
                os._exit(17)

    camp.subscribe(_chaos)
    camp.sweep(sweep_scenarios(), backend="analytic")
    os._exit(0)                        # not reached when k < len(sweep)
