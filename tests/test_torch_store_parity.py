"""The two packages' run stores: the same records, kept apart.

Both packages key a run with the same ``run_key`` and write the same
record format, so for the host backends (``packet``, ``wormhole``,
``hybrid``, ``analytic``, bit-equal between the packages) the port's
record is the reference's, and a record file either package wrote loads
in the other's ``RunStore``.  ``fluid`` and ``learned`` results differ
between them under the same key, so neither package opens the other's
campaign directory or store server: each direction is tested through the
reference's own ``repro.api.Campaign`` and ``StoreServer``.

Also here: the 10 ``campaign/*`` and ``learned/*`` counters of
``benchmarks/ci_regression.py`` on the port (the fit on the CPU), against
``artifacts/ci_baseline.json`` with its own tolerances.
"""
import json
import os
import pathlib

import pytest

import repro.api as ref_api
import repro.api.serve as ref_serve
import repro.api.store as ref_store
import repro_torch.api as port_api
import repro_torch.api.serve as port_serve
import repro_torch.api.store as port_store
from benchmarks.learned_bench import wave_scenario
from test_torch_packet import port_scenario, quickstart

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = {"device": "cpu"}
RECORD_SCENARIOS = {
    "quickstart": quickstart,
    "gpt32": lambda: ref_api.training_scenario(n_gpus=32, cca="hpcc", scale=1 / 256),
}
HOST_BACKENDS = ("packet", "wormhole", "hybrid", "analytic")


def _records(api, store_mod, scn, backend, tmp_path, tag):
    """The record a durable campaign of ``api`` commits for one run, read
    back from its directory."""
    with api.Campaign.open(tmp_path / tag) as camp:
        key = camp.submit(scn, backend=backend).key
    return key, store_mod.RunStore(tmp_path / tag / "runs").get(key)


@pytest.mark.parametrize("backend", HOST_BACKENDS)
@pytest.mark.parametrize("name", list(RECORD_SCENARIOS))
def test_host_backend_records_equal_to_reference(name, backend, tmp_path):
    """Same key, equal ``stable_record_fingerprint`` (wall fields masked),
    and records equal field for field beside the wall clock."""
    ref_scn = RECORD_SCENARIOS[name]()
    rk, ref = _records(ref_api, ref_store, ref_scn, backend, tmp_path, "ref")
    pk, port = _records(port_api, port_store, port_scenario(ref_scn), backend,
                        tmp_path, "port")
    assert pk == rk
    assert port_store.stable_record_fingerprint(port) == \
        ref_store.stable_record_fingerprint(ref) == \
        port_store.stable_record_fingerprint(ref)
    for rec in (port, ref):
        rec["result"].pop("wall_time")
    assert port == ref


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_record_files_load_in_the_other_package(writer, tmp_path):
    """A record file either package's ``LocalDirBackend`` wrote loads in the
    other's ``RunStore`` as the same record and the same result."""
    ref_scn = quickstart()
    res = ref_api.run(ref_scn, backend="analytic")
    key = ref_store.run_key(ref_scn, "analytic", {})
    assert port_store.run_key(port_scenario(ref_scn), "analytic", {}) == key
    w_store, r_store = (ref_store, port_store) if writer == "reference" \
        else (port_store, ref_store)
    w_api = ref_api if writer == "reference" else port_api
    scn = ref_scn if writer == "reference" else port_scenario(ref_scn)
    w_store.RunStore(tmp_path / "runs").put(
        key, scn, "analytic", {}, w_api.RunResult.from_dict(res.to_dict()))
    back = r_store.RunStore(tmp_path / "runs").get(key)
    assert back == w_store.RunStore(tmp_path / "runs").get(key)
    r_api = port_api if writer == "reference" else ref_api
    assert r_api.RunResult.from_dict(back["result"]).to_dict() == res.to_dict()


# --------------------------------------------------------------------- #
# separation: neither package serves the other's runs
# --------------------------------------------------------------------- #
def test_reference_refuses_a_port_campaign_directory(tmp_path):
    with port_api.Campaign.open(tmp_path / "camp") as camp:
        camp.submit(port_scenario(quickstart()), backend="analytic")
    with pytest.raises(ValueError, match="manifest_version"):
        ref_api.Campaign.open(tmp_path / "camp")


def test_port_refuses_a_reference_campaign_directory(tmp_path):
    with ref_api.Campaign.open(tmp_path / "camp") as camp:
        camp.submit(quickstart(), backend="analytic")
    for open_ in (lambda: port_api.Campaign.open(tmp_path / "camp"),
                  lambda: port_serve.StoreServer(tmp_path / "camp")):
        with pytest.raises(ValueError, match="not a repro_torch campaign.*`repro`"):
            open_()


def test_reference_client_is_never_served_by_a_port_server(tmp_path):
    """The port's server answers 403 to the reference's client, which then
    degrades to local-only: it runs the triple itself, and the server's
    store is left as it was."""
    server = port_serve.StoreServer(tmp_path / "served").start()
    try:
        with port_api.Campaign.open(server.url) as camp:
            port_key = camp.submit(port_scenario(quickstart()), backend="analytic").key
        assert server.info()["service"] == "repro_torch-store"
        with pytest.warns(RuntimeWarning, match="degrading to local-only"):
            ref = ref_api.Campaign.open(tmp_path / "ref", store=server.url)
        ref.remote.retries, ref.remote.backoff = 1, 0.01
        h = ref.submit(quickstart(), backend="analytic")
        assert h.key == port_key and not h.cached
        assert ref.remote.degraded and ref.remote.pending == {port_key}
        ref.close()
        assert port_store.RunStore(tmp_path / "served" / "runs").keys() == [port_key]
    finally:
        server.shutdown()


def test_port_client_refuses_a_reference_server(tmp_path):
    """A reference server holding the same key: the port's client refuses
    it at attach time (no stamp on its answers), directly or through a
    local campaign, and a bare backend refuses it on its first answer."""
    server = ref_serve.StoreServer(tmp_path / "served").start()
    try:
        with ref_api.Campaign.open(server.url) as camp:
            camp.submit(quickstart(), backend="analytic")
        for open_ in (lambda: port_api.Campaign.open(server.url),
                      lambda: port_api.Campaign.open(tmp_path / "local", store=server.url)):
            with pytest.raises(port_serve.ForeignStoreError, match="not a repro_torch store"):
                open_()
        with pytest.raises(port_serve.ForeignStoreError):
            port_serve.RemoteBackend(server.url).keys()
    finally:
        server.shutdown()


# --------------------------------------------------------------------- #
# the campaign/* and learned/* counters of benchmarks/ci_regression.py
# --------------------------------------------------------------------- #
BASELINE = json.loads((REPO / "artifacts" / "ci_baseline.json").read_text())
CI_COUNTERS = [k for k in BASELINE["counters"] if k.split("/")[0] in ("campaign", "learned")]


@pytest.fixture(scope="module")
def port_ci_counters(tmp_path_factory):
    """``campaign_counters`` and ``learned_counters`` of
    ``benchmarks/ci_regression.py``, on the port, with the fit on the CPU."""
    from repro_torch.learned import fit, heldout_fct_error
    variants = [port_scenario(quickstart()).variant(name=f"ci-{s:g}", size_scale=s)
                for s in (1.0, 1.05, 1.1)]
    with port_api.Campaign.open(tmp_path_factory.mktemp("ci") / "camp", name="ci") as camp:
        camp.sweep(variants, backend="wormhole")
        camp.sweep(variants, backend="wormhole")
        out = {"campaign/store_hits": camp.store.hits,
               "campaign/store_misses": camp.store.misses,
               "campaign/runs_committed": len(camp.store),
               "campaign/db_entries": len(camp.db)}
    family = [port_scenario(wave_scenario(float(s), base_size=4e5, name=f"ci-learned-{i}"))
              for i, s in enumerate([0.5 + 0.08 * k for k in range(20)])]
    with port_api.Campaign.in_memory(name="ci-learned") as camp:
        camp.sweep(family, backend="wormhole")
        ds = camp.export_dataset()
    params = fit(ds, seed=0, steps=400, **CPU)
    err = heldout_fct_error(params, ds, **CPU)
    out.update({
        "learned/train_records": ds.n_records - ds.n_heldout_records,
        "learned/heldout_records": ds.n_heldout_records,
        "learned/train_flows": int((~ds.heldout).sum()),
        "learned/heldout_flows": int(ds.heldout.sum()),
        "learned/heldout_err_ppm": -1 if err != err else int(round(err * 1e6)),
        "learned/err_under_10pct": int(err == err and err < 0.10),
    })
    return out


@pytest.mark.parametrize("name", CI_COUNTERS)
def test_ci_campaign_and_learned_counters_hold_the_baseline(name, port_ci_counters):
    """9 counters exact; ``learned/heldout_err_ppm`` within the baseline's
    own tolerance (rel 0.75, abs 500: the fit is the port's, from another
    initialisation)."""
    assert len(CI_COUNTERS) == 10 and set(port_ci_counters) == set(CI_COUNTERS)
    old, new = BASELINE["counters"][name], port_ci_counters[name]
    tol = BASELINE["tolerances"].get(name, {"rel": 0.0, "abs": 0})
    assert tol == ({"rel": 0.75, "abs": 500} if name == "learned/heldout_err_ppm"
                   else {"rel": 0.0, "abs": 0})
    assert abs(new - old) <= max(tol["abs"], tol["rel"] * abs(old)), (name, old, new)


def test_campaign_directory_is_the_ports_own(tmp_path):
    """The manifest a port campaign writes, and the record files beside it."""
    with port_api.Campaign.open(tmp_path / "camp") as camp:
        key = camp.submit(port_scenario(quickstart()), backend="analytic").key
    assert json.loads((tmp_path / "camp" / "campaign.json").read_text())["package"] == \
        "repro_torch"
    assert sorted(os.listdir(tmp_path / "camp" / "runs")) == [f"{key}.json"]
