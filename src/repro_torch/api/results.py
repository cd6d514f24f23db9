"""Structured results returned by every engine.

The PyTorch port keeps its own copy of ``repro.api.results``, which the port
may not import; the tests hold the two to identical outputs.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import numpy as np


def jsonify(x: Any, fallback: Callable[[Any], Any] = repr) -> Any:
    """Best-effort canonical JSON form: dataclasses/dicts/sequences recurse,
    dict keys become strings, tuples become lists, numpy arrays/scalars
    unwrap, and anything without a canonical form goes through ``fallback``
    (default ``repr``) — so the output always survives ``json.dumps`` and
    is idempotent on already-JSON trees.  The store's key canonicalizer
    passes a different fallback; keep the recursion shared so record and
    key forms can never diverge on a type."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return jsonify(dataclasses.asdict(x), fallback)
    if isinstance(x, dict):
        return {str(k): jsonify(v, fallback) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonify(v, fallback) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(jsonify(v, fallback) for v in x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    return fallback(x)


@dataclasses.dataclass
class RunResult:
    """What one engine run of one scenario produced.

    ``fcts`` maps flow id -> completion time (seconds); ``iteration_time``
    is the traffic-program makespan (phase-DAG end for workload scenarios,
    last-finish minus first-start for flow scenarios).
    """
    backend: str
    scenario: str
    fcts: dict[int, float]
    flow_bytes: dict[int, float]
    tags: dict[int, str]
    iteration_time: float | None
    events_processed: int
    wall_time: float
    kernel_report: dict | None = None
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ #
    def fct_errors_vs(self, baseline: RunResult) -> np.ndarray:
        """Relative per-flow FCT error against a baseline run of the same
        scenario (flows missing from either side are ignored)."""
        return np.array([abs(self.fcts[fid] - fct) / fct
                         for fid, fct in baseline.fcts.items()
                         if fct > 0 and fid in self.fcts])

    def to_dict(self) -> dict:
        """Canonical JSON form: every key is a string, every value survives
        ``json.dumps``.  ``from_dict(to_dict(r)).to_dict() == to_dict(r)``
        exactly — the round-trip the RunStore persists results through.
        ``extras`` payloads ride along in their JSON shape (tuples as lists,
        non-string keys stringified)."""
        return jsonify(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: dict) -> "RunResult":
        """Inverse of :meth:`to_dict` (flow-id keys come back as ints)."""
        return cls(
            backend=d["backend"], scenario=d["scenario"],
            fcts={int(k): float(v) for k, v in d["fcts"].items()},
            flow_bytes={int(k): float(v)
                        for k, v in d["flow_bytes"].items()},
            tags={int(k): str(v) for k, v in d["tags"].items()},
            iteration_time=(None if d.get("iteration_time") is None
                            else float(d["iteration_time"])),
            events_processed=int(d["events_processed"]),
            wall_time=float(d["wall_time"]),
            kernel_report=d.get("kernel_report"),
            extras=dict(d.get("extras", {})))


@dataclasses.dataclass
class Comparison:
    """Per-backend speedup/accuracy table against a baseline backend."""
    scenario: str
    baseline: str
    results: dict[str, RunResult]

    def __getitem__(self, backend: str) -> RunResult:
        return self.results[backend]

    def rows(self) -> list[dict]:
        base = self.results[self.baseline]
        return [summarize_pair(base, r) for b, r in self.results.items()
                if b != self.baseline]

    def format(self) -> str:
        base = self.results[self.baseline]
        hdr = (f"{'backend':<10} {'events':>10} {'wall s':>8} {'ev x':>7} "
               f"{'wall x':>7} {'fct err%':>9} {'max err%':>9} {'iter ms':>9}")
        lines = [f"scenario {self.scenario!r}  (baseline: {self.baseline})", hdr,
                 "-" * len(hdr)]
        for b, r in self.results.items():
            s = summarize_pair(base, r)
            it = f"{r.iteration_time * 1e3:9.3f}" if r.iteration_time else " " * 9
            if b == self.baseline:
                lines.append(f"{b:<10} {r.events_processed:>10d} "
                             f"{r.wall_time:8.2f} {'1.0':>7} {'1.0':>7} "
                             f"{'-':>9} {'-':>9} {it}")
            else:
                lines.append(
                    f"{b:<10} {r.events_processed:>10d} {r.wall_time:8.2f} "
                    f"{s['event_speedup']:7.1f} {s['wall_speedup']:7.1f} "
                    f"{100 * s['fct_err_mean']:9.3f} "
                    f"{100 * s['fct_err_max']:9.3f} {it}")
        return "\n".join(lines)

    __str__ = format


def summarize_pair(base: RunResult, other: RunResult) -> dict:
    """Speedup / accuracy summary of ``other`` against baseline ``base`` —
    the table quickstart, simulate_cluster and paper_figures all share."""
    errs = other.fct_errors_vs(base)
    out = {
        "backend": other.backend,
        "events": other.events_processed,
        "wall": other.wall_time,
        "event_speedup": base.events_processed / max(other.events_processed, 1),
        "wall_speedup": base.wall_time / max(other.wall_time, 1e-9),
        "fct_err_mean": float(errs.mean()) if errs.size else float("nan"),
        "fct_err_max": float(errs.max()) if errs.size else float("nan"),
        "fct_err_p99": float(np.quantile(errs, 0.99)) if errs.size else float("nan"),
    }
    if base.iteration_time and other.iteration_time is not None:
        out["iter_err"] = (abs(other.iteration_time - base.iteration_time)
                           / base.iteration_time)
    return out
