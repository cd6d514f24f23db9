#!/usr/bin/env python3
"""The fluid engine's scenario wall time, two checkouts of the repo against
each other on one card, in alternating pairs.

    python3 tools/ab_fluid_wall.py --base DIR --change DIR [--pairs 12]
        [--scenarios gpt@128 moe@1024]

Each checkout runs in a worker process of its own (its ``src`` first on the
path, its kernels built into its own ``build/``), which warms every scenario
once and then times ``repro_torch.api.run(scn, backend="fluid")`` on the
card when asked, from the call to ``torch.cuda.synchronize()`` after it.
The driver asks the two workers in turn, base first in even pairs and
change first in odd ones, so that a drift of the host shows on both sides.
Prints one JSON line per scenario: every wall, the median, min and max of
each side, and the median of the paired differences (change less base);
then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys


def worker(root: str, names: list[str]) -> int:
    sys.path.insert(0, str(pathlib.Path(root) / "src"))
    import time

    import torch

    from repro_torch.api import run, training_scenario
    presets = {"gpt@128": dict(n_gpus=128), "moe@128": dict(n_gpus=128, moe=True),
               "moe@1024": dict(n_gpus=1024, moe=True)}
    scenarios = {n: training_scenario(**presets[n], scale=1.0) for n in names}
    for scn in scenarios.values():                  # builds the kernels, warms the caches
        run(scn, backend="fluid")
    print("ready", flush=True)
    for line in sys.stdin:
        scn = scenarios[line.strip()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(scn, backend="fluid")
        torch.cuda.synchronize()
        print(json.dumps(time.perf_counter() - t0), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True)
    ap.add_argument("--change", required=True)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--scenarios", nargs="+", default=["gpt@128", "moe@1024"])
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.scenarios)
    import torch
    if not torch.cuda.is_available():
        print("ab_fluid_wall: no CUDA device", file=sys.stderr)
        return 1
    sides = {}
    try:
        for side in ("base", "change"):
            root = str(pathlib.Path(getattr(args, side)).resolve())
            sides[side] = subprocess.Popen(
                [sys.executable, __file__, "--worker", root, "--base", "-", "--change", "-",
                 "--scenarios", *args.scenarios],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=root)
        for side, proc in sides.items():
            if proc.stdout.readline().strip() != "ready":
                raise RuntimeError(f"the {side} worker did not start")

        def timed(side: str, name: str) -> float:
            proc = sides[side]
            proc.stdin.write(name + "\n")
            proc.stdin.flush()
            return float(json.loads(proc.stdout.readline()))
        for name in args.scenarios:
            walls = {"base": [], "change": []}
            for i in range(args.pairs):
                for side in (("base", "change") if i % 2 == 0 else ("change", "base")):
                    walls[side].append(timed(side, name))
            diffs = [c - b for b, c in zip(walls["base"], walls["change"])]
            row = {"scenario": name, "pairs": args.pairs, "walls_s": walls,
                   "median_diff_s": statistics.median(diffs),
                   "pairs_change_slower": sum(d > 0 for d in diffs)}
            for side, w in walls.items():
                row[side] = dict(median_s=statistics.median(w), min_s=min(w), max_s=max(w))
            print(json.dumps(row), flush=True)
    finally:
        for proc in sides.values():
            proc.stdin.close()
            proc.wait(timeout=120)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
