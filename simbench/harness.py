"""The benchmark of ``repro_torch``: one cell, one seed, one result line.

A cell of ``BENCHMARK.json`` names a configuration (a paper Table-1 job,
``simbench/configs/<config>.json``, with its message-size scale) and a
traffic mix (``simbench/traffic/<mix>.json``: the backends each iteration
runs, in order, the memo DB's use, how many iterations the packet oracle
checks).  Its numbers' limits are ``simbench/limits/<cell>.json``
and every metric is a reader, ``simbench/metrics/<metric>.py``.  The
harness finds all of them by name, so a new cell, mix or metric is a new
file and a new entry, never an edit.

A run: set-up (torch, the card, the program's libraries, one warm
iteration, and in a warm-memo cell the DB warmed by the job's
straggler-free iteration and saved under ``TMPDIR``); then timed
iterations until ``--seconds`` have passed, iteration k simulating the
straggler draw (seed, k) through ``repro_torch.api.runner.run``, each
ending in ``torch.cuda.synchronize()``; then, with the window closed and
the peak memory read, the reference's comparison (``simbench.checks``).
``--trace 1`` runs the window under ``torch.profiler`` and reports the
per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from simbench.checks import Iteration, passed, verify

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    metrics: list[dict]          # this run's metrics: end-to-end or per-layer
    readers: dict                # metric name -> read(ctx)


def _reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        "simbench_metric_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(root: Path, name: str, trace: bool) -> Cell:
    """Everything a cell needs, found by the names in ``BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if name in m.get("workloads", [name])]
    limits_path = root / "simbench" / "limits" / f"{name}.json"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / cfg_entry["file"]).read_text()),
        mix=json.loads((root / "simbench" / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads(limits_path.read_text()) if limits_path.exists() else {},
        metrics=metrics,
        readers={m["name"]: _reader(root / "simbench" / "metrics" / f"{m['name']}.py")
                 for m in metrics})


def straggler_draw(config: dict, seed: int, k: int) -> tuple[int, float]:
    """Iteration k of seed n: which rank runs slow, and by how much."""
    par = config["parallelism"]
    ranks = par["tp"] * par["dp"] * par["pp"] * par["ep"]
    lo, hi = config["assumed"]["straggler_mult"]
    rng = np.random.default_rng([seed % 2**64, 0, k])
    return int(rng.integers(ranks)), float(rng.uniform(lo, hi))


def port_scenario(config: dict, straggler, name: str):
    """The program's Scenario of the configuration's job."""
    from repro_torch.api.scenario import Scenario, TopologySpec, WorkloadSpec
    fabric = dict(config["fabric"])
    par = config["parallelism"]
    return Scenario(
        name=name, topology=TopologySpec(fabric.pop("kind"), fabric),
        workload=WorkloadSpec(
            family=config["job"]["family"], n_gpus=config["job"]["n_gpus"],
            cca=config["cca"], scale=config["message_bytes_scale"], ep_over_dp=par["ep_over_dp"],
            num_microbatches=par["num_microbatches"], straggler=straggler,
            collective=config["collective"]),
        sim=dict(config["sim"]))


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    cell: Cell
    setup_s: float
    window_s: float
    iterations: list[Iteration]
    checks: dict
    trace: object = None         # simbench.devtrace.Trace in a traced run


class Run:
    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device: str) -> None:
        import torch
        self.torch = torch
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        self.backends = cell.mix["backends"]
        self.db_path = None

    def _span(self, name: str):
        if not self.trace:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(name)

    def _sync(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def iterate(self, k: int, straggler) -> Iteration:
        from repro_torch.api import runner
        it = Iteration(k=k, straggler=straggler)
        t0 = time.perf_counter()
        with self._span("simbench.iteration"):
            scn = port_scenario(self.cell.config, straggler, f"{self.cell.name}.{k}")
            for b in self.backends:
                t = time.perf_counter()
                with self._span(f"simbench.{b}"):
                    opts = {}
                    if b == "fluid" and self.device != "cuda":
                        opts["device"] = self.device
                    if b == "wormhole" and self.db_path is not None:
                        from repro_torch.core.memo import SimDB
                        opts["db"] = SimDB.load(self.db_path)
                    res = runner.run(scn, backend=b, **opts)
                it.spans[b] = time.perf_counter() - t
                it.fcts[b] = res.fcts
                it.iteration_time[b] = res.iteration_time
                it.events[b] = res.events_processed
                it.kernel_report[b] = res.kernel_report or {}
            self._sync()
        it.wall = time.perf_counter() - t0
        return it

    def setup(self) -> None:
        """The libraries, one warm iteration (the job without a straggler),
        and a warm-memo cell's DB."""
        if self.cell.mix["warm_db"]:
            from repro_torch.api import runner
            from repro_torch.core.memo import SimDB
            db = SimDB()
            runner.run(port_scenario(self.cell.config, None, "warm-db"),
                       backend="wormhole", db=db)
            fd, self.db_path = tempfile.mkstemp(prefix="simbench-", suffix=".simdb.json")
            os.close(fd)
            db.save(self.db_path)
        self.iterate(-1, None)

    def window(self) -> tuple[list[Iteration], float]:
        iters = []
        t0 = time.perf_counter()
        while True:
            k = len(iters)
            iters.append(self.iterate(k, straggler_draw(self.cell.config, self.seed, k)))
            t = time.perf_counter() - t0
            if t >= self.seconds:
                return iters, t

    def close(self) -> None:
        if self.db_path is not None:
            with contextlib.suppress(FileNotFoundError):
                os.remove(self.db_path)


def _device_info(torch, device: str, chips: int) -> dict:
    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips))}
    return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}


def _forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float) -> tuple[dict, list[Iteration]]:
    """One run of a cell: the result line's object and the timed iterations."""
    run = Run(cell, seed, seconds, trace, device)
    torch = run.torch
    try:
        run.setup()
        setup_s = time.perf_counter() - t_start
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        try:
            iters, window_s = run.window()
        finally:
            if prof is not None:
                prof.stop()
        dev = _device_info(torch, device, cell.chips)
        tr = None
        if prof is not None:
            from simbench.devtrace import from_profiler
            tr = from_profiler(prof)
            del prof
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    finally:
        run.close()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks, failed = verify(cell.config, cell.mix, cell.limits, iters, seed)
    ctx = Context(cell=cell, setup_s=setup_s, window_s=window_s, iterations=iters,
                  checks=checks, trace=tr)
    metrics = {}
    for m in cell.metrics:
        v = cell.readers[m["name"]](ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": failed == 0 and passed(checks), "attempted": len(iters),
           "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    return out, iters


def main(argv=None, *, t_start: float | None = None, root: Path = ROOT,
         check_chip: bool = True, device: str = "cuda") -> int:
    """``--workload --seed --seconds --trace``; prints the result as the last
    line of standard output and the numbers compared, each beside its
    limit, as the last lines of standard error.  ``check_chip=False`` and
    ``device="cpu"`` run the same path on the CPU (the harness's tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="simbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(root, args.workload, bool(args.trace))
    import torch
    if check_chip and (not torch.cuda.is_available()
                       or torch.cuda.device_count() < cell.chips):
        print(f"simbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, iters = execute(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    bad = _forbidden_modules()
    if bad:
        print(f"simbench: the run loaded {', '.join(bad)}; the benchmark measures "
              "repro_torch alone", file=sys.stderr)
        return 3
    walls = [it.wall for it in iters]
    q = np.quantile(walls, [0.25, 0.5, 0.75])
    print(f"window: {len(walls)} iterations, iteration wall median {q[1]:.6g} s, "
          f"quartiles {q[0]:.6g}-{q[2]:.6g} s", file=sys.stderr)
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) {ok}", file=sys.stderr)
    print(json.dumps(_plain(out), allow_nan=False))
    return 0


def _plain(x):
    """JSON-safe numbers: numpy scalars unwrapped, a number that is not
    finite written as the largest float (a gap that could not be measured)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.floating, np.integer)):
        x = x.item()
    if isinstance(x, float) and not math.isfinite(x):
        return sys.float_info.max
    return x
