#!/usr/bin/env python3
"""granite-3-2b's training step of two trees, timed in turns.

    python3 tools/ab_train_step.py --base build/parent [--steps 10]

``--base`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` under ``build/``).  Each tree trains
granite-3-2b at full width and depth as ``chip_smoke.py``'s phase train
does (bf16, remat, batch 4 x 2048, ``TokenPipeline`` seed 0, the tamed
weights of seed 0, ``train_loop.train``) for ``--steps`` steps, in a
process of its own, in the order base, change, change, base.  One JSON
line a run with its step seconds, the median of steps 2 to the last, and
its losses; then one line with the medians of each tree, the change's over
the base's, and whether the two trees' losses are bit-equal; then the
card's name and power limit as ``nvidia-smi`` gives them.  Needs one card
and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CHILD = """
import json, sys
from repro_torch.configs.registry import get
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.api import build_model
from repro_torch.models.crosscheck import tame
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import TrainConfig, train
steps = int(sys.argv[1])
cfg = get("granite-3-2b")
m = build_model(cfg)
pipe = TokenPipeline(vocab=cfg.vocab, seq_len=2048, global_batch=4, seed=0)
tcfg = TrainConfig(steps=steps, log_every=steps,
                   opt=O.AdamWConfig(lr=3e-4, warmup=2, total_steps=steps,
                                     state_dtype=O.STATE_DTYPES[cfg.opt_dtype]))
out = train(m, pipe, tcfg, params=tame(m.init(0)))
print(json.dumps({"step_seconds": out["step_seconds"], "losses": out["losses"]}))
"""


def run(tree: pathlib.Path, steps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    proc = subprocess.run([sys.executable, "-c", CHILD, str(steps)], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, type=pathlib.Path)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    trees = {"base": args.base.resolve(), "change": ROOT}
    medians, losses = {}, {}
    for name in ("base", "change", "change", "base"):
        res = run(trees[name], args.steps)
        med = statistics.median(res["step_seconds"][1:])
        medians.setdefault(name, []).append(med)
        losses.setdefault(name, []).append(res["losses"])
        print(json.dumps({"tree": name, "median_step_s": med, **res}), flush=True)
    base, change = (statistics.mean(medians[k]) for k in ("base", "change"))
    print(json.dumps({"median_step_s": medians, "change_over_base": change / base,
                      "losses_bit_equal": all(a == losses["base"][0]
                                              for a in losses["base"] + losses["change"])}),
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
