"""The comparison that decides ``correct``.

After the window has closed, the reference works out again, from the
configuration file and each iteration's straggler draw alone, what the
timed path produced:

* every fluid result of the window against the NumPy fluid model: the
  widest relative gap of a flow's FCT (``fluid_fct_gap``) and of the
  iteration time (``fluid_iter_gap``);
* the wormhole results of ``packet_checks`` iterations, drawn from the
  seed, against the frozen packet oracle: the mean and the widest FCT
  error in percent (the configuration's stated guarantees) and the gap of
  the iteration time (``wormhole_iter_gap``);
* every result of every iteration against the job's flows:
  ``flows_missing`` counts flows absent, added or not finite (limit 0).

Each number is held to its limit (``value <= limit``); the fluid and
iteration-time limits come from ``simbench/limits/<workload>.json``, set
from readings of sound runs and of the control.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from simbench.reference.fluid import FluidReference
from simbench.reference.job import Job
from simbench.reference.packet import run_packet


@dataclasses.dataclass
class Iteration:
    """What the harness kept of one timed iteration."""
    k: int
    straggler: tuple[int, float]
    wall: float = 0.0
    spans: dict = dataclasses.field(default_factory=dict)
    fcts: dict = dataclasses.field(default_factory=dict)
    iteration_time: dict = dataclasses.field(default_factory=dict)
    events: dict = dataclasses.field(default_factory=dict)
    kernel_report: dict = dataclasses.field(default_factory=dict)
    fluid_shapes: list = dataclasses.field(default_factory=list)


def rel_gap(value: float | None, ref: float) -> float:
    """|value / ref - 1|, infinite where a side is missing or not finite."""
    if value is None:
        return math.inf
    d = abs(value - ref) / abs(ref) if ref else abs(value)
    return d if math.isfinite(d) else math.inf


def _missing(prog: dict, ref: dict, it_time) -> int:
    bad = len(prog.keys() ^ ref.keys())
    bad += sum(1 for f in prog.keys() & ref.keys() if not math.isfinite(prog[f]))
    return bad + (0 if it_time is not None and math.isfinite(it_time) else 1)


def packet_sample(seed: int, n_iters: int, n: int) -> list[int]:
    """Which iterations the packet oracle checks: drawn from the seed."""
    rng = np.random.default_rng([seed % 2**64, 1])
    return sorted(rng.choice(n_iters, size=min(n, n_iters), replace=False).tolist())


def verify(config: dict, mix: dict, limits: dict, iters: list[Iteration],
           seed: int) -> tuple[dict, int]:
    """The numbers compared, each ``{"value", "limit"}``, and the count of
    iterations whose results are incomplete."""
    job = Job(config)
    scale = config["message_bytes_scale"]
    backends = mix["backends"]
    checks: dict[str, dict] = {}
    missing = 0
    failed = 0
    fluid = FluidReference(job.topology(), config["fluid"]) if "fluid" in backends else None
    gap = igap = 0.0
    for it in iters:
        phases = job.phases(scale, it.straggler)
        flows = {f.fid for ph in phases for f in ph.flows}
        bad = sum(_missing(it.fcts[b], dict.fromkeys(flows), it.iteration_time[b])
                  for b in backends)
        if fluid is not None:
            ref, ref_t, it.fluid_shapes = fluid.iteration(phases)
            prog = it.fcts["fluid"]
            gap = max([gap] + [rel_gap(prog[f], ref[f]) for f in ref.keys() & prog.keys()])
            igap = max(igap, rel_gap(it.iteration_time["fluid"], ref_t))
        missing += bad
        failed += bad > 0
    if fluid is not None:
        checks["fluid_fct_gap"] = {"value": gap, "limit": limits["fluid_fct_gap"]}
        checks["fluid_iter_gap"] = {"value": igap, "limit": limits["fluid_iter_gap"]}
    if "wormhole" in backends and mix["packet_checks"]:
        means, maxes, igaps = [], [], []
        for i in packet_sample(seed, len(iters), mix["packet_checks"]):
            ref, ref_t, _ = run_packet(job, scale, iters[i].straggler)
            prog = iters[i].fcts["wormhole"]
            errs = [rel_gap(prog[f], ref[f]) for f in ref.keys() & prog.keys()] or [math.inf]
            means.append(100 * sum(errs) / len(errs))
            maxes.append(100 * max(errs))
            igaps.append(rel_gap(iters[i].iteration_time["wormhole"], ref_t))
        g = config["guarantees"]
        checks["wormhole_fct_err_mean_pct"] = {"value": sum(means) / len(means),
                                               "limit": g["wormhole_fct_err_mean_pct"]}
        checks["wormhole_fct_err_max_pct"] = {"value": max(maxes),
                                              "limit": g["wormhole_fct_err_max_pct"]}
        checks["wormhole_iter_gap"] = {"value": max(igaps), "limit": limits["wormhole_iter_gap"]}
    checks["flows_missing"] = {"value": missing, "limit": 0}
    return checks, failed


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
