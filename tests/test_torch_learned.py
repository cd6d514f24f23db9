"""The port's learned engine (``repro_torch.learned``) against the JAX
package's, on the CPU.

The dataset side is numpy and the exact float64 solver in both packages,
so its bar is equality: run keys, flow tables, encodings, datasets (X, y,
split, keys).  The MLP is float32 in both, through ``torch.matmul`` here
and ``jnp`` there, so ``predict`` on shared params is held at rtol 1e-5
(with atol 1e-6 on log slowdowns near 0, where float32 sums of 16-64
products differ in the last bits), FCTs at rtol 1e-5.  The fit cannot
start from the reference's weights (``jax.random`` cannot be reproduced
in torch), so its parity is held twice: from the reference's initial
weights the two trajectories agree after 25 Adam steps, and the port's own
fit meets the reference's held-out bar of 0.10.

The reference's own tests (``tests/test_learned.py``) are mirrored on the
port at the same sizes, bar ``test_engine_through_campaign_sweep`` (the
port has no campaigns yet).  The port has no run store either: its ground
truth, 16 ``hybrid`` ``fidelity="flow"`` runs of its own as in the
reference's fixture, reaches ``build_dataset`` through a ``records()``
iterator of records keyed with the ported ``run_key``.  Everything here
runs with ``device="cpu"``; the card's side is in tests/test_torch_gpu.py.
"""
import json
import os
import types
import warnings

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.api.store as ref_store
import repro.learned as ref_learned
import repro.learned.engine as ref_engine
import repro.learned.model as ref_model
import repro_torch.api as port_api
import repro_torch.api.store as port_store
import repro_torch.learned as port_learned
import repro_torch.learned.engine as port_engine
import repro_torch.learned.model as port_model
from repro_torch.api import FlowSpec, Scenario, TopologySpec, get_engine
from repro_torch.learned import (OutOfDistributionError, build_dataset, fit, flow_table,
                                 heldout_fct_error, heldout_fraction_of, model)

CPU = {"device": "cpu"}


def wave_scenario(size_scale: float = 1.0, cca: str = "dctcp",
                  name: str = "waves") -> Scenario:
    flows, fid = [], 0
    for wave in (0.0, 0.02):
        for i in range(4):
            flows.append(FlowSpec(fid, i, 12 + (i % 2),
                                  size=8e6 * size_scale, start=wave,
                                  cca=cca, tag=f"wave@{wave}"))
            fid += 1
    return Scenario(name, TopologySpec("clos", {"n_hosts": 16, "leaf_down": 4,
                                                "n_spines": 2}),
                    flows=flows)


def record(scenario, backend: str, opts: dict, result) -> dict:
    """A store record of one run, as the reference's RunStore holds it (the
    fields ``build_dataset`` reads), keyed with the ported ``run_key``."""
    return {"key": port_store.run_key(scenario, backend, opts), "backend": backend,
            "scenario_fingerprint": port_store.scenario_fingerprint(scenario),
            "scenario": scenario.to_dict(), "result": result.to_dict()}


def source(records: list) -> types.SimpleNamespace:
    """Anything with a ``records()`` iterator is a dataset source."""
    return types.SimpleNamespace(records=lambda: iter(records))


def swept(scenarios, backend: str, **opts) -> list:
    return [record(s, backend, opts, port_api.run(s, backend=backend, **opts))
            for s in scenarios]


@pytest.fixture(scope="module")
def records():
    """16 hybrid flow-fidelity runs of the port (legitimate ground truth,
    ~ms each): the training source for every fixture fit."""
    return swept([wave_scenario(0.5 + 0.1 * i, name=f"tw{i}") for i in range(16)],
                 "hybrid", fidelity="flow")


@pytest.fixture(scope="module")
def dataset(records):
    return build_dataset(source(records))


@pytest.fixture(scope="module")
def params(dataset):
    return fit(dataset, seed=0, hidden=(16, 16), steps=250, **CPU)


@pytest.fixture(scope="module")
def ref_params(records):
    """The reference's fit on the same records (its dataset is bit-equal)."""
    return ref_learned.fit(ref_learned.build_dataset(source(records)), seed=0,
                           hidden=(16, 16), steps=250)


# --------------------------------------------------------------------- #
# parity with the reference
# --------------------------------------------------------------------- #
def _key_scenarios():
    base = ref_api.Scenario.from_dict(wave_scenario().to_dict())
    return [
        (base, "hybrid", {"fidelity": "flow"}),
        (base.variant(name="b", size_scale=1.3), "hybrid", {}),
        (base, "wormhole", {"config": {"theta": 0.05, "enable_memo": False}}),
        (base, "packet", {"record_rtt": (0, 3), "until": 0.01}),
        (base.variant(name="c", cca="hpcc"), "learned", {"ood": "warn",
                                                         "params": "p.json"}),
        (base.variant(name="d", chaos=[{"kind": "mice", "seed": 3, "rate": 1e4,
                                        "size": 4e4, "duration": 0.002}]), "analytic", {}),
        (ref_api.training_scenario(n_gpus=32, cca="hpcc", scale=1 / 256), "wormhole", {}),
        (ref_api.training_scenario(n_gpus=32, moe=True, scale=1 / 512), "fluid",
         {"steps": 100, "dt": 1e-5}),
        (ref_api.training_scenario(n_gpus=16, collective="tree"), "hybrid",
         {"fidelity": "auto", "demote_after": 4}),
        (base, "fluid", {"weights": np.arange(4.0), "nested": {"x": (1, 2)}}),
    ]


def test_run_key_and_fingerprint_equal_to_reference():
    """The same content address in both packages, so a record lands on
    the same side of the train/held-out split."""
    keys = set()
    for ref_scn, backend, opts in _key_scenarios():
        scn = port_api.Scenario.from_dict(ref_scn.to_dict())
        assert port_store.scenario_fingerprint(scn) == ref_store.scenario_fingerprint(ref_scn)
        key = port_store.run_key(scn, backend, opts)
        assert key == ref_store.run_key(ref_scn, backend, opts)
        assert port_api.run_key is port_store.run_key
        keys.add(key)
        assert heldout_fraction_of(key) == ref_learned.heldout_fraction_of(key)
    assert len(keys) == 10
    # an opt with no canonical JSON form keys uniquely, as there
    db = port_api.SimDB()
    scn = port_api.Scenario.from_dict(wave_scenario().to_dict())
    assert port_store.run_key(scn, "wormhole", {"db": db}) != \
        port_store.run_key(scn, "wormhole", {"db": db})


def test_flow_table_and_encode_bit_equal_to_reference():
    for ref_scn in (ref_api.Scenario.from_dict(wave_scenario(0.7, cca="hpcc").to_dict()),
                    ref_api.training_scenario(n_gpus=32, cca="hpcc", scale=1 / 256),
                    ref_api.training_scenario(n_gpus=32, moe=True, scale=1 / 512)):
        ref_t = ref_learned.flow_table(ref_scn)
        port_t = flow_table(port_api.Scenario.from_dict(ref_scn.to_dict()))
        for f in ("fids", "numeric", "ideal_fct", "size", "phase_of"):
            assert np.array_equal(getattr(port_t, f), getattr(ref_t, f)), f
            assert getattr(port_t, f).dtype == getattr(ref_t, f).dtype
        for f in ("cca", "topo_kind", "tags", "phases", "kind"):
            assert getattr(port_t, f) == getattr(ref_t, f), f
        for vocab in ((["dctcp", "hpcc"], ["clos", "rail"]), (["timely"], ["rail"])):
            X, unknown = port_learned.encode(port_t, *vocab)
            rX, runknown = ref_learned.encode(ref_t, *vocab)
            assert np.array_equal(X, rX) and unknown == runknown
    assert port_learned.NUMERIC_FEATURES == ref_learned.NUMERIC_FEATURES
    assert port_learned.GROUND_TRUTH_BACKENDS == ref_learned.GROUND_TRUTH_BACKENDS


def test_build_dataset_bit_equal_to_reference(records):
    extra = swept([wave_scenario(0.9, cca="hpcc", name="h")], "packet")
    for recs, frac in ((records, 0.25), (records + extra, 0.5)):
        port = build_dataset(source(recs), heldout_frac=frac)
        ref = ref_learned.build_dataset(source(recs), heldout_frac=frac)
        for f in ("X", "y", "ideal_fct", "fct", "heldout"):
            assert np.array_equal(getattr(port, f), getattr(ref, f)), f
            assert getattr(port, f).dtype == getattr(ref, f).dtype
        for f in ("record_key", "cca_vocab", "topo_vocab", "n_numeric", "n_records",
                  "n_heldout_records", "feature_names"):
            assert getattr(port, f) == getattr(ref, f), f
        assert port.heldout.any() and (~port.heldout).any()


def _predict_close(port: np.ndarray, ref: np.ndarray, ideal: np.ndarray) -> None:
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ideal * np.exp(port), ideal * np.exp(ref), rtol=1e-5, atol=0)


def test_predict_equal_to_reference_on_its_params(dataset, ref_params):
    port = port_model.predict(ref_params, dataset.X, **CPU)
    ref = ref_model.predict(ref_params, dataset.X)
    assert port.dtype == np.float64 and port.shape == (len(dataset),)
    _predict_close(port, ref, dataset.ideal_fct)
    X = np.random.default_rng(0).normal(size=(257, dataset.X.shape[1])) * 3.0
    _predict_close(port_model.predict(ref_params, X, **CPU), ref_model.predict(ref_params, X),
                   np.ones(len(X)))
    assert heldout_fct_error(ref_params, dataset, **CPU) == pytest.approx(
        ref_learned.heldout_fct_error(ref_params, dataset), rel=1e-4)


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_params_files_load_in_the_other_package(tmp_path, saver, params, ref_params):
    """A params file either package saved loads in the other with the same
    fingerprint and weights (numpy and JSON on both sides)."""
    for p in (params, ref_params):
        path = tmp_path / f"{p.fingerprint}.json"
        (ref_model if saver == "reference" else port_model).save(p, path)
        loader = port_model if saver == "reference" else ref_model
        back = loader.load(path)
        assert back.fingerprint == p.fingerprint
        assert back.meta == (port_model if saver == "port" else ref_model).load(path).meta
        for (w0, b0), (w1, b1) in zip(back.weights, p.weights):
            assert np.array_equal(w0, w1) and np.array_equal(b0, b1)
        assert port_model.fingerprint_of(back.weights, back.meta) == \
            ref_model.fingerprint_of(back.weights, back.meta) == p.fingerprint
        assert port_engine.load_params(path).fingerprint == p.fingerprint


def test_params_file_records_the_fitting_device(tmp_path, params):
    """``meta["train"]["device"]`` names where the fit ran; the fingerprint
    covers it, and the file still loads in the reference."""
    assert params.meta["train"]["device"] == "cpu"
    path = tmp_path / "p.json"
    port_model.save(params, path)
    back = ref_model.load(path)
    assert back.fingerprint == params.fingerprint
    assert back.meta["train"]["device"] == "cpu"
    meta = json.loads(path.read_text())
    meta["train"]["device"] = "NVIDIA H100 80GB HBM3"
    path.write_text(json.dumps(meta))
    for model in (port_model, ref_model):
        with pytest.raises(ValueError, match="fingerprint"):
            model.load(path)


def test_engine_run_equal_to_reference(tmp_path, ref_params):
    path = tmp_path / "ref.json"
    ref_model.save(ref_params, path)
    scns = [wave_scenario(s, name=f"q{s:g}") for s in (0.55, 1.0, 1.37)]
    port = get_engine("learned").run_batch(scns, params=str(path), **CPU)
    ref = ref_engine.LearnedEngine().run_batch(
        [ref_api.Scenario.from_dict(s.to_dict()) for s in scns], params=str(path))
    for p, r in zip(port, ref):
        assert list(p.fcts) == list(r.fcts)
        np.testing.assert_allclose(list(p.fcts.values()), list(r.fcts.values()), rtol=1e-5)
        assert p.iteration_time == pytest.approx(r.iteration_time, rel=1e-5)
        assert p.flow_bytes == r.flow_bytes and p.tags == r.tags
        assert p.events_processed == r.events_processed == 0
        assert p.extras["learned"]["params_fingerprint"] == ref_params.fingerprint
        assert p.extras["learned"]["ood_violations"] == r.extras["learned"]["ood_violations"]
        assert p.extras["device"] == "cpu"
    assert port_engine.LearnedEngine.option_names == \
        tuple(sorted((*ref_engine.LearnedEngine.option_names, "device")))


def test_fit_from_the_reference_init_follows_its_trajectory(monkeypatch, records):
    """With ``model.init`` returning the reference's initial weights, the
    port's Adam (the reference's update order and float32 rounding) ends
    25 steps within 1e-6 of the reference's weights; the bookkeeping is
    the same."""
    ref_ds = ref_learned.build_dataset(source(records))
    ds = build_dataset(source(records))
    d = ds.X.shape[1]
    monkeypatch.setattr(port_model, "init", lambda seed, d_in, hidden=(64, 64): [
        (np.asarray(w), np.asarray(b)) for w, b in ref_model.init(seed, d_in, hidden)])
    kw = dict(seed=0, hidden=(16, 16), steps=25, eval_every=5)
    port = fit(ds, **kw, **CPU)
    ref = ref_learned.fit(ref_ds, **kw)
    for (w0, b0), (w1, b1) in zip(port.weights, ref.weights):
        np.testing.assert_allclose(w0, w1, rtol=0, atol=1e-6)
        np.testing.assert_allclose(b0, b1, rtol=0, atol=1e-6)
    assert port.weights[0][0].shape == (d, 16)
    pt, rt = port.meta.pop("train"), ref.meta.pop("train")
    assert pt.pop("device") == "cpu"          # the port's params name their device
    for k in ("train_mse", "heldout_mse"):
        assert pt.pop(k) == pytest.approx(rt.pop(k), rel=1e-3)
    assert pt == rt
    for k in ("fingerprint",):
        port.meta.pop(k), ref.meta.pop(k)
    assert port.meta == ref.meta


def test_init_draws_on_the_cpu_and_is_seeded():
    a = port_model.init(0, 10, (16, 16))
    b = port_model.init(0, 10, (16, 16))
    c = port_model.init(1, 10, (16, 16))
    assert [w.shape for w, _ in a] == [(10, 16), (16, 16), (16, 1)]
    assert all(torch.equal(w0, w1) for (w0, _), (w1, _) in zip(a, b))
    assert not torch.equal(a[0][0], c[0][0])
    assert all(w.dtype == torch.float32 and w.device.type == "cpu" for w, _ in a)
    assert all(not b.any() for _, b in a)
    # N(0, 1) / sqrt(fan_in)
    big = port_model.init(0, 400, (400,))[0][0]
    assert float(big.std()) == pytest.approx(1 / 20, rel=0.02)


def test_entry_points_need_the_card_unless_told(monkeypatch, params, dataset):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        get_engine("learned").run(wave_scenario(), params=params)
    with pytest.raises(RuntimeError, match="none is available"):
        port_model.predict(params, dataset.X[:2])
    with pytest.raises(RuntimeError, match="none is available"):
        fit(dataset, steps=1)
    assert get_engine("learned").run(wave_scenario(), params=params, **CPU).fcts


# --------------------------------------------------------------------- #
# mirrors of tests/test_learned.py, on the port
# --------------------------------------------------------------------- #
def test_flow_table_is_pure_scenario_math():
    scn = wave_scenario()
    table = flow_table(scn)
    assert list(table.fids) == [f.fid for f in scn.flows]
    assert np.isfinite(table.numeric).all()
    assert (table.ideal_fct > 0).all()
    assert table.kind == "flows" and len(table.phases) == 2
    assert set(table.phase_of) == {0, 1}
    assert table.cca == ["dctcp"] * 8 and table.topo_kind == "clos"


def test_dataset_shapes_and_split(dataset):
    assert len(dataset) == 16 * 8
    assert dataset.n_records == 16
    assert dataset.X.shape == (128, dataset.n_numeric + len(dataset.cca_vocab)
                               + len(dataset.topo_vocab))
    assert np.allclose(np.exp(dataset.y) * dataset.ideal_fct, dataset.fct)
    for key in set(dataset.record_key):
        rows = [h for k, h in zip(dataset.record_key, dataset.heldout) if k == key]
        assert len(set(rows)) == 1
        assert rows[0] == (heldout_fraction_of(key) < 0.25)


def test_dataset_split_is_deterministic(records, dataset):
    again = build_dataset(source(records))
    assert np.array_equal(dataset.heldout, again.heldout)
    assert np.array_equal(dataset.X, again.X)
    assert np.array_equal(dataset.y, again.y)


def test_dataset_refuses_non_ground_truth_backends(records):
    with pytest.raises(ValueError, match="not packet-level ground truth"):
        build_dataset(source(records), backends=("analytic",))
    with pytest.raises(ValueError, match="no ground-truth records"):
        build_dataset(source(swept([wave_scenario()], "analytic")))


def test_dataset_dedups_scenarios_by_fidelity_rank():
    scn = wave_scenario(name="dup")
    recs = swept([scn], "hybrid", fidelity="flow") + swept([scn], "packet")
    ds = build_dataset(source(recs))
    assert ds.n_records == 1
    truth = port_api.run(wave_scenario(name="dup"), backend="packet")
    assert np.allclose(sorted(ds.fct), sorted(truth.fcts.values()))


def test_fixed_seed_fit_is_deterministic(dataset, params):
    again = fit(dataset, seed=0, hidden=(16, 16), steps=250, **CPU)
    assert again.fingerprint == params.fingerprint
    other_seed = fit(dataset, seed=1, hidden=(16, 16), steps=250, **CPU)
    assert other_seed.fingerprint != params.fingerprint


def test_fit_learns_the_family(dataset, params):
    err = heldout_fct_error(params, dataset, **CPU)
    assert err == err, "fixture split must hold records out"
    assert err < 0.10, f"held-out mean FCT error {err:.3f} over the bound"


def test_params_save_load_roundtrip(tmp_path, params):
    path = tmp_path / "params.json"
    model.save(params, path)
    assert path.exists() and path.with_suffix(".npz").exists()
    back = model.load(path)
    assert back.fingerprint == params.fingerprint
    assert back.meta["cca_vocab"] == params.meta["cca_vocab"]
    for (w0, b0), (w1, b1) in zip(back.weights, params.weights):
        assert np.array_equal(w0, w1) and np.array_equal(b0, b1)
    X = np.zeros((3, params.d_in))
    assert np.allclose(model.predict(back, X, **CPU), model.predict(params, X, **CPU))


def test_load_refuses_foreign_params_version(tmp_path, params):
    path = tmp_path / "params.json"
    model.save(params, path)
    meta = json.loads(path.read_text())
    meta["params_version"] = 99
    path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="params_version"):
        model.load(path)


def test_load_refuses_mismatched_weights(tmp_path, params, dataset):
    path = tmp_path / "params.json"
    model.save(params, path)
    other = fit(dataset, seed=7, hidden=(16, 16), steps=50, **CPU)
    model.save(other, tmp_path / "other.json")
    (tmp_path / "other.npz").rename(tmp_path / "params.npz")
    with pytest.raises(ValueError, match="fingerprint"):
        model.load(path)


def test_missing_params_is_a_clear_error(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"python -m repro_torch fit"):
        get_engine("learned").run(wave_scenario(), params=tmp_path / "nope.json", **CPU)


def test_params_cache_detects_same_size_same_mtime_rewrite(tmp_path, params, dataset):
    from repro_torch.learned.engine import load_params

    path = tmp_path / "params.json"
    npz = tmp_path / "params.npz"
    fixed_ns = (1_700_000_000_000_000_000,) * 2
    pad_to = 4096

    def save_padded(p):
        model.save(p, path)
        raw = path.read_bytes()
        path.write_bytes(raw + b"\n" * (pad_to - len(raw)))
        os.utime(path, ns=fixed_ns)
        os.utime(npz, ns=fixed_ns)

    save_padded(params)
    size_a = path.stat().st_size
    first = load_params(path)
    assert first.fingerprint == params.fingerprint

    other = fit(dataset, seed=1, hidden=(16, 16), steps=250, **CPU)
    assert other.fingerprint != params.fingerprint
    save_padded(other)
    assert path.stat().st_size == size_a
    second = load_params(path)
    assert second.fingerprint == other.fingerprint


def test_engine_runresult_contract(params):
    scn = wave_scenario(1.23, name="query")
    r = get_engine("learned").run(scn, params=params, **CPU)
    assert r.backend == "learned" and r.scenario == "query"
    assert set(r.fcts) == {f.fid for f in scn.flows}
    assert all(v > 0 for v in r.fcts.values())
    assert r.iteration_time and r.iteration_time > 0
    assert r.events_processed == 0
    learned = r.extras["learned"]
    assert learned["params_fingerprint"] == params.fingerprint
    assert learned["ood_violations"] == []
    assert r.extras["predicted_fcts"] == r.fcts
    back = port_api.RunResult.from_dict(json.loads(json.dumps(r.to_dict())))
    assert back.fcts == r.fcts


def test_run_batch_matches_run(params):
    scns = [wave_scenario(s, name=f"b{s:g}") for s in (0.8, 1.0, 1.4)]
    eng = get_engine("learned")
    batch = eng.run_batch(scns, params=params, **CPU)
    for scn, br in zip(scns, batch):
        solo = eng.run(scn, params=params, **CPU)
        assert solo.fcts == pytest.approx(br.fcts)
        assert solo.iteration_time == pytest.approx(br.iteration_time)


def test_out_of_distribution_policies(params):
    far = wave_scenario(80.0, name="far")
    eng = get_engine("learned")
    with pytest.raises(OutOfDistributionError, match="log_size"):
        eng.run(far, params=params, **CPU)
    with pytest.warns(RuntimeWarning, match="extrapolating"):
        r = eng.run(far, params=params, ood="warn", **CPU)
    assert r.extras["learned"]["ood_violations"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r = eng.run(far, params=params, ood="ignore", **CPU)
    assert r.extras["learned"]["ood_violations"]
    with pytest.raises(ValueError, match="ood policy"):
        eng.run(far, params=params, ood="loud", **CPU)


def test_unknown_category_is_out_of_distribution(params):
    alien = wave_scenario(1.0, cca="hpcc", name="alien-cca")
    with pytest.raises(OutOfDistributionError, match="cca"):
        get_engine("learned").run(alien, params=params, **CPU)
