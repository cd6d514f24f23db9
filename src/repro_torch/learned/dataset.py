"""Training datasets extracted from stores of packet-level runs (m4-style).

Copy of ``repro.learned.dataset``, which the port may not import.  The port
has no run store or campaign yet: :func:`build_dataset` takes any object
whose ``records()`` yields store records (``key``, ``backend``,
``scenario_fingerprint``, ``scenario``, ``result``), keyed with
:func:`repro_torch.api.store.run_key`, which hashes as the reference's.

A campaign's content-addressed run store already *is* a labeled dataset: every record pairs a canonical scenario JSON with
the :class:`RunResult` an engine produced for it.  This module closes the
``campaign → training set`` half of the learned-engine loop:

* :func:`flow_table` — per-flow features computable from the scenario
  alone (no simulation): flow size, path placement (hops, bottleneck
  bandwidth, propagation delay — the src/dst partition signal), topology
  class, CCA, and concurrent-flow contention summaries within the flow's
  traffic phase, including the max-min fair rate the analytic solver
  assigns.  The same function feeds both training and serving, so the two
  can never drift.
* :func:`build_dataset` — ``(features, targets)`` arrays from any object
  with a ``records()`` iterator (a ``RunStore`` or a ``Campaign``).  Only
  packet-level ground truth counts: records from backends outside
  :data:`GROUND_TRUTH_BACKENDS` are skipped, and duplicate evaluations of
  one scenario collapse to the highest-fidelity record so a scenario can
  never leak across the split.  The train/held-out split is deterministic,
  keyed off each record's ``run_key`` — re-extracting the same store
  always yields the same split.

Targets are ``log(fct / ideal_fct)`` — the log slowdown of the measured
FCT over the max-min ideal ``size / rate`` — so the model learns the
*residual* contention physics the analytic solver misses, not absolute
timescales.  Everything here is numpy-only; torch enters in
``repro_torch.learned.model``/``fit``.  The max-min features come from the
exact float64 host solver, as in the reference, so they are bit-equal.
"""
from __future__ import annotations

import dataclasses
import json
from hashlib import sha256

import numpy as np

from repro_torch.api.results import RunResult
from repro_torch.api.scenario import Scenario
from repro_torch.kernels.maxmin import solve_paths
from repro_torch.net.topology import Topology

# backends whose stored results are packet-level ground truth (analytic /
# fluid / learned records are themselves approximations — training on them
# would teach the model its own error)
GROUND_TRUTH_BACKENDS = ("packet", "wormhole", "hybrid")

NUMERIC_FEATURES = (
    "log_size",            # log10 flow bytes
    "path_len",            # hops — src/dst placement (2 = same leaf)
    "log_bottleneck_bw",   # log10 min link bw on the path
    "log_prop_delay",      # log10 end-to-end propagation delay
    "log_phase_flows",     # log10 concurrent flows in the phase
    "contention_degree",   # max co-located flows on any path link
    "log_maxmin_rate",     # log10 analytic fair-share rate
    "maxmin_share",        # fair-share rate / bottleneck bw
)


# scenario sweeps re-query one fabric thousands of times; rebuilding the
# Topology (and its BFS distance caches) per query would dominate serving
_TOPO_CACHE: dict[str, Topology] = {}


def _topology_for(scenario: Scenario) -> Topology:
    key = json.dumps({"kind": scenario.topology.kind,
                      "params": scenario.topology.params},
                     sort_keys=True, default=str)
    topo = _TOPO_CACHE.get(key)
    if topo is None:
        if len(_TOPO_CACHE) >= 64:
            _TOPO_CACHE.clear()
        topo = _TOPO_CACHE[key] = scenario.build_topology()
    return topo


@dataclasses.dataclass
class FlowTable:
    """Per-flow features of one scenario, grouped by traffic phase —
    the unit both the trainer and the learned engine consume."""
    fids: np.ndarray        # int64 [N]
    numeric: np.ndarray     # float64 [N, len(NUMERIC_FEATURES)]
    cca: list[str]          # [N]
    topo_kind: str
    ideal_fct: np.ndarray   # float64 [N]  size / maxmin rate
    size: np.ndarray        # float64 [N]  bytes
    tags: list[str]         # [N]
    phase_of: np.ndarray    # int64 [N]  index into ``phases``
    phases: list[tuple[tuple[int, ...], float, float]]  # (deps, compute, start)
    kind: str               # "flows" | "workload"


def flow_table(scenario: Scenario) -> FlowTable:
    """Per-flow feature rows for ``scenario`` — pure scenario-side math
    (routing, max-min solve), no simulation."""
    topo = _topology_for(scenario)
    phases = scenario.build_phases()
    fids: list[int] = []
    rows: list[list[float]] = []
    cca: list[str] = []
    ideal: list[float] = []
    size: list[float] = []
    tags: list[str] = []
    phase_of: list[int] = []
    phase_meta: list[tuple[tuple[int, ...], float, float]] = []
    for pi, ph in enumerate(phases):
        start = ph.flows[0].start if (scenario.kind == "flows" and ph.flows) \
            else 0.0
        phase_meta.append((tuple(ph.deps), float(ph.compute), float(start)))
        if not ph.flows:
            continue
        paths = {f.fid: topo.route(f.src, f.dst, f.fid) for f in ph.flows}
        # the vectorized solver directly — same CSR layout every fast lane
        # shares, bit-identical to the historical dict solver
        rates = solve_paths(paths, topo.link_bw)
        link_users: dict[int, int] = {}
        for p in paths.values():
            for l in p:
                link_users[l] = link_users.get(l, 0) + 1
        n_phase = float(len(ph.flows))
        for f in ph.flows:
            p = paths[f.fid]
            bott = float(topo.link_bw[p].min()) if p else 1e12
            prop = float(topo.link_delay[p].sum()) if p else 0.0
            cont = max((link_users[l] for l in p), default=1)
            rate = max(float(rates.get(f.fid, bott)), 1.0)
            fids.append(f.fid)
            rows.append([np.log10(f.size), float(len(p)), np.log10(bott),
                         np.log10(prop + 1e-9), np.log10(n_phase),
                         float(cont), np.log10(rate), rate / bott])
            cca.append(f.cca)
            ideal.append(f.size / rate)
            size.append(f.size)
            tags.append(f.tag)
            phase_of.append(pi)
    return FlowTable(
        fids=np.asarray(fids, np.int64),
        numeric=np.asarray(rows, np.float64).reshape(len(fids),
                                                     len(NUMERIC_FEATURES)),
        cca=cca, topo_kind=scenario.topology.kind,
        ideal_fct=np.asarray(ideal, np.float64),
        size=np.asarray(size, np.float64), tags=tags,
        phase_of=np.asarray(phase_of, np.int64),
        phases=phase_meta, kind=scenario.kind)


def encode(table: FlowTable, cca_vocab: list[str],
           topo_vocab: list[str]) -> tuple[np.ndarray, list[str]]:
    """Numeric block + one-hot categorical blocks under a fixed vocabulary
    (the fitted model's ``meta`` carries the vocab, so serving encodes
    exactly like training did).  Categories outside the vocab encode as
    all-zeros and come back in the second return value — the engine's OOD
    policy decides what to do with them."""
    n = len(table.fids)
    n_num = len(NUMERIC_FEATURES)
    X = np.zeros((n, n_num + len(cca_vocab) + len(topo_vocab)), np.float64)
    X[:, :n_num] = table.numeric
    unknown: set[str] = set()
    cca_ix = {c: i for i, c in enumerate(cca_vocab)}
    for i, c in enumerate(table.cca):
        j = cca_ix.get(c)
        if j is None:
            unknown.add(f"cca={c!r} not in fitted vocab {cca_vocab}")
        else:
            X[i, n_num + j] = 1.0
    topo_ix = {t: i for i, t in enumerate(topo_vocab)}
    j = topo_ix.get(table.topo_kind)
    if j is None:
        if n:
            unknown.add(f"topology={table.topo_kind!r} not in fitted "
                        f"vocab {topo_vocab}")
    else:
        X[:, n_num + len(cca_vocab) + j] = 1.0
    return X, sorted(unknown)


def feature_names(cca_vocab: list[str], topo_vocab: list[str]) -> list[str]:
    return (list(NUMERIC_FEATURES)
            + [f"cca={c}" for c in cca_vocab]
            + [f"topology={t}" for t in topo_vocab])


# ---------------------------------------------------------------------- #
# store -> dataset
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class Dataset:
    """Flat per-flow training arrays plus the record-level bookkeeping the
    fit loop and benchmarks report on."""
    X: np.ndarray               # [N, D] encoded features (raw, unstandardized)
    y: np.ndarray               # [N] log(fct / ideal_fct)
    ideal_fct: np.ndarray       # [N]
    fct: np.ndarray             # [N] ground-truth FCT
    heldout: np.ndarray         # bool [N]
    record_key: list[str]       # [N] owning record's run_key
    cca_vocab: list[str]
    topo_vocab: list[str]
    n_numeric: int
    n_records: int
    n_heldout_records: int

    @property
    def feature_names(self) -> list[str]:
        return feature_names(self.cca_vocab, self.topo_vocab)

    def __len__(self) -> int:
        return len(self.y)


def heldout_fraction_of(run_key: str) -> float:
    """Deterministic position of a record in [0, 1): records with
    ``heldout_fraction_of(key) < heldout_frac`` are held out.  Pure
    content hash — stable across processes, sessions and extraction
    order."""
    return int(sha256(run_key.encode()).hexdigest()[:8], 16) / 0x100000000


def build_dataset(source, backends: tuple[str, ...] = GROUND_TRUTH_BACKENDS,
                  heldout_frac: float = 0.25) -> Dataset:
    """Extract ``(features, targets)`` from ``source`` — anything with a
    ``records()`` iterator of store records (a :class:`RunStore` or a
    :class:`Campaign`).

    Records from backends outside ``backends`` are ignored (they are not
    packet-level ground truth), duplicate evaluations of one scenario
    fingerprint collapse to the highest-fidelity backend present (so one
    scenario can never land on both sides of the split), and flows missing
    from a record's result (never completed) are dropped.
    """
    for b in backends:
        if b not in GROUND_TRUTH_BACKENDS:
            raise ValueError(
                f"backend {b!r} is not packet-level ground truth; "
                f"usable: {GROUND_TRUTH_BACKENDS}")
    rank = {b: i for i, b in enumerate(GROUND_TRUTH_BACKENDS)}
    best: dict[str, dict] = {}
    for rec in source.records():
        if rec["backend"] not in backends:
            continue
        fp = rec["scenario_fingerprint"]
        old = best.get(fp)
        if old is None or rank[rec["backend"]] < rank[old["backend"]]:
            best[fp] = rec
    if not best:
        raise ValueError(
            f"no ground-truth records (backends {backends}) in the store — "
            f"sweep a campaign on a packet-level backend first")

    cca_vocab: set[str] = set()
    topo_vocab: set[str] = set()
    parsed = []
    for fp in sorted(best):
        rec = best[fp]
        scenario = Scenario.from_dict(rec["scenario"])
        result = RunResult.from_dict(rec["result"])
        table = flow_table(scenario)
        cca_vocab.update(table.cca)
        topo_vocab.add(table.topo_kind)
        parsed.append((rec["key"], table, result))
    ccas = sorted(cca_vocab)
    topos = sorted(topo_vocab)

    xs, ys, ideals, fcts, held, keys = [], [], [], [], [], []
    n_heldout_records = 0
    for key, table, result in parsed:
        X, _ = encode(table, ccas, topos)
        have = np.array([fid in result.fcts for fid in table.fids], bool)
        fct = np.array([result.fcts.get(int(fid), np.nan)
                        for fid in table.fids], np.float64)
        ok = have & (fct > 0) & (table.ideal_fct > 0)
        if not ok.any():
            continue
        is_held = heldout_fraction_of(key) < heldout_frac
        n_heldout_records += bool(is_held)
        xs.append(X[ok])
        ys.append(np.log(fct[ok] / table.ideal_fct[ok]))
        ideals.append(table.ideal_fct[ok])
        fcts.append(fct[ok])
        held.append(np.full(int(ok.sum()), is_held, bool))
        keys.extend([key] * int(ok.sum()))
    return Dataset(
        X=np.concatenate(xs), y=np.concatenate(ys),
        ideal_fct=np.concatenate(ideals), fct=np.concatenate(fcts),
        heldout=np.concatenate(held), record_key=keys,
        cca_vocab=ccas, topo_vocab=topos,
        n_numeric=len(NUMERIC_FEATURES), n_records=len(parsed),
        n_heldout_records=n_heldout_records)
