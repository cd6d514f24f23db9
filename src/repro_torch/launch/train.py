"""Training driver: ``python -m repro_torch.launch.train --arch granite-3-2b
--steps 200`` trains a (reduced or full) config with the full substrate:
AdamW, microbatching, checkpoints, failure recovery, optional gradient
compression.

    python -m repro_torch.launch.train --arch granite-3-2b --steps 20
    python -m repro_torch.launch.train --arch xlstm-125m --steps 10 --device cpu

The reference's flags (``--reduced`` is the default, ``--no-reduced``
trains the full config), and ``--device``: the CUDA card unless it says
``cpu``; with no card and no ``--device cpu`` it exits 1.  Weights are drawn
from seed 0 and the data pipeline from seed 0, as in the reference's
``launch/train.py``.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs.registry import get
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import NoCardError, resolve_device
from repro_torch.models.api import build_model
from repro_torch.parallel.compression import CompressionConfig
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainConfig, train


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="train the reduced config (the default); --no-reduced "
                         "for the full config")
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions on the CPU; "
                         "default: the CUDA card")
    args = ap.parse_args(argv)

    try:
        dev = resolve_device(args.device)
    except NoCardError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    print(f"{cfg.name}: {model.n_params/1e6:.1f}M params on {dev}")
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=0)
    tcfg = TrainConfig(
        steps=args.steps, microbatches=args.microbatches,
        opt=AdamWConfig(lr=args.lr, warmup=max(10, args.steps // 20),
                        total_steps=args.steps),
        compression=CompressionConfig(kind=args.compression),
        ckpt_dir=args.ckpt_dir, log_every=10,
    )
    out = train(model, pipe, tcfg, device=dev)
    print(f"final loss {out['losses'][-1]:.4f} "
          f"(start {out['losses'][0]:.4f}); stragglers={out['stragglers']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
