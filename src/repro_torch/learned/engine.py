"""The ``learned`` engine: fitted per-flow FCT prediction as a backend.

Copy of ``repro.learned.engine``, which the port may not import, with one
addition: the MLP runs on the CUDA card unless the caller passes
``device="cpu"`` (the ``device`` opt, as the fluid engine has it), and the
result's ``extras["device"]`` names where it ran.

Registered as the sixth engine family.  A run never simulates: per-flow
features come straight from the scenario (``repro_torch.learned.dataset``), the
fitted MLP predicts each flow's slowdown over its max-min ideal, and the
phase DAG is scheduled analytically on top (the same scheduling the fluid
backend uses), so a well-formed :class:`RunResult` comes back in
microseconds.  ``run_batch`` flattens a whole scenario sweep into one
model invocation — the m4-style serving tier: thousands of what-if
queries per second out of one process (``benchmarks/learned_bench.py``).

Guard rails:

* no fitted params -> a clear error naming how to fit them (the port has
  no CLI yet: ``repro_torch.learned.fit`` and ``model.save``);
* out-of-distribution queries — numeric features outside the training
  envelope, or categories (CCA / topology class) outside the fitted
  vocabulary — raise :class:`OutOfDistributionError` by default
  (``ood="warn"``/``"ignore"`` downgrade it; violations always land in
  ``extras["learned"]["ood_violations"]``).

``RunResult.extras`` carries the per-flow predicted FCTs and the model
fingerprint, so any result can be traced to the exact fit that produced
it and ``compare()``/CI counters work unchanged.
"""
from __future__ import annotations

import os
import time
import warnings
from hashlib import sha256

import numpy as np

from repro_torch.api.engines import Engine, register_engine
from repro_torch.api.results import RunResult
from repro_torch.api.scenario import Scenario
from repro_torch.device import device_name, resolve_device
from repro_torch.learned import dataset as D
from repro_torch.net import chaos

DEFAULT_PARAMS_PATH = "artifacts/learned_params.json"

# serving caches fitted params per (path, size, mtime, content fingerprint)
# so sweeps and repeated runs pay the read once.  mtime+size alone is not a
# safe identity: a same-size rewrite within the filesystem's timestamp
# granularity (or under os.utime) would silently serve the stale model.
_PARAMS_CACHE: dict = {}


def _file_fingerprint(path: str) -> str:
    h = sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class OutOfDistributionError(ValueError):
    """A queried scenario falls outside the fitted model's training
    envelope (feature ranges) or vocabulary (CCA / topology class)."""


def load_params(params):
    """Resolve a ``params=`` opt: a :class:`LearnedParams` passes through,
    a path loads (cached on the file's identity)."""
    from repro_torch.learned.model import LearnedParams, load
    if isinstance(params, LearnedParams):
        return params
    path = os.fspath(params)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no fitted learned-engine params at {path!r} — fit one on "
            f"packet/wormhole/hybrid runs with `repro_torch.learned.fit("
            f"build_dataset(source))` and save it with "
            f"`repro_torch.learned.model.save(params, {path!r})`, or pass "
            f"params=<path|LearnedParams>")
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_size, st.st_mtime_ns,
           _file_fingerprint(path))
    if key not in _PARAMS_CACHE:
        if len(_PARAMS_CACHE) >= 8:
            _PARAMS_CACHE.clear()
        _PARAMS_CACHE[key] = load(path)
    return _PARAMS_CACHE[key]


def _violations(scenario: Scenario, table: D.FlowTable, unknown: list[str],
                meta: dict) -> list[str]:
    """OOD report for one scenario: unknown categories + numeric features
    outside the training envelope (with a 5%-of-range margin, so boundary
    scenarios the fit saw do not flag on float noise)."""
    out = [f"{scenario.name}: {u}" for u in unknown]
    lo = np.asarray(meta["envelope_lo"], np.float64)
    hi = np.asarray(meta["envelope_hi"], np.float64)
    margin = 0.05 * (hi - lo) + 1e-9
    if len(table.fids):
        mn = table.numeric.min(0)
        mx = table.numeric.max(0)
        for j, name in enumerate(D.NUMERIC_FEATURES):
            if mn[j] < lo[j] - margin[j] or mx[j] > hi[j] + margin[j]:
                bad = mn[j] if mn[j] < lo[j] - margin[j] else mx[j]
                out.append(
                    f"{scenario.name}: {name}={bad:.4g} outside fitted "
                    f"range [{lo[j]:.4g}, {hi[j]:.4g}]")
    return out


def _schedule(table: D.FlowTable, fct: np.ndarray) -> tuple[dict, float | None]:
    """Analytic phase-DAG schedule over predicted FCTs (mirrors the fluid
    backend): returns ``{fid: fct}`` and the iteration time."""
    fcts = {int(f): float(v) for f, v in zip(table.fids, fct)}
    done = [0.0] * len(table.phases)
    starts: list[float] = []
    for i, (deps, compute, start_off) in enumerate(table.phases):
        start = max((done[d] for d in set(deps)), default=0.0) + compute
        if table.kind == "flows":
            start += start_off
        end = start
        rows = np.nonzero(table.phase_of == i)[0]
        for r in rows:
            end = max(end, start + float(fct[r]))
        if len(rows):
            starts.append(start)
        done[i] = end
    if not done:
        return fcts, None
    if table.kind == "flows" and starts:
        return fcts, max(done) - min(starts)
    return fcts, max(done)


@register_engine("learned")
class LearnedEngine(Engine):
    """m4-style learned flow-level backend: per-flow FCTs predicted by an
    MLP fitted on this repo's own campaign ground truth (packet /
    wormhole / hybrid records), phase DAG scheduled analytically.

    opts:
      params  path to fitted params (``model.save``; default
              ``artifacts/learned_params.json``) or a live
              ``LearnedParams`` (uncacheable in campaign stores)
      ood     "error" (default) | "warn" | "ignore" — what to do when a
              scenario leaves the training envelope/vocabulary
      device  where the MLP runs: the CUDA card by default (raises with
              none), or ``"cpu"``

    Cheapest backend after ``analytic`` and far closer to the oracle *in
    distribution*; it knows nothing about traffic it was never fitted on,
    which is what the OOD guard is for.
    """
    option_names = ("device", "ood", "params")

    def run(self, scenario: Scenario, **opts) -> RunResult:
        return self.run_batch([scenario], **opts)[0]

    def run_batch(self, scenarios: list[Scenario],
                  params=DEFAULT_PARAMS_PATH, ood: str = "error",
                  device=None, **opts) -> list[RunResult]:
        dev = resolve_device(device)
        if ood not in ("error", "warn", "ignore"):
            raise ValueError(f"unknown ood policy {ood!r} "
                             f"(use 'error', 'warn' or 'ignore')")
        for scn in scenarios:
            chaos.check_backend(chaos.plan_for(scn), self.name)
        if not scenarios:
            return []
        t0 = time.perf_counter()
        lp = load_params(params)
        meta = lp.meta

        tables: list[D.FlowTable] = []
        blocks: list[np.ndarray] = []
        violations: list[list[str]] = []
        for scn in scenarios:
            table = D.flow_table(scn)
            X, unknown = D.encode(table, meta["cca_vocab"],
                                  meta["topo_vocab"])
            tables.append(table)
            blocks.append(X)
            violations.append(_violations(scn, table, unknown, meta))
        flat = [v for vs in violations for v in vs]
        if flat:
            if ood == "error":
                raise OutOfDistributionError(
                    "scenario(s) outside the fitted model's training "
                    "distribution:\n  " + "\n  ".join(flat) +
                    "\n(refit on a campaign covering them, or pass "
                    "ood='warn'/'ignore' to predict anyway)")
            if ood == "warn":
                warnings.warn(
                    f"learned engine extrapolating outside its training "
                    f"distribution: {'; '.join(flat)}", RuntimeWarning,
                    stacklevel=2)

        from repro_torch.learned.model import predict
        X_all = np.concatenate(blocks) if blocks else np.zeros((0, lp.d_in))
        pred = predict(lp, X_all, device=dev) if len(X_all) else np.zeros(0)

        wall_total = None    # filled after the per-scenario assembly
        results = []
        at = 0
        for scn, table, viol in zip(scenarios, tables, violations):
            n = len(table.fids)
            fct = table.ideal_fct * np.exp(pred[at:at + n])
            at += n
            fcts, iteration = _schedule(table, fct)
            extras = {
                "predicted_fcts": dict(fcts),
                "learned": {
                    "params_fingerprint": meta["fingerprint"],
                    "n_flows": n,
                    "ood_violations": viol,
                },
                "device": device_name(dev),
            }
            results.append(RunResult(
                backend=self.name, scenario=scn.name, fcts=fcts,
                flow_bytes={int(f): float(s)
                            for f, s in zip(table.fids, table.size)},
                tags={int(f): t for f, t in zip(table.fids, table.tags)},
                iteration_time=iteration, events_processed=0,
                wall_time=0.0, extras=extras))
        wall_total = time.perf_counter() - t0
        for r in results:
            r.wall_time = wall_total / len(results)
            r.extras["learned"]["batch_wall"] = wall_total
        return results
