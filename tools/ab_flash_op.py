#!/usr/bin/env python3
"""K4's Python entry point of two trees, timed in turns in one process.

    python3 tools/ab_flash_op.py --base build/parent

``--base`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` under ``build/``).  Its
``kernels/flash_attention/ops.py`` is loaded beside this tree's under
another module name; both launch the kernels this tree builds (the CUDA
sources must be the same in both trees, which is checked), so what differs
is only the wrapper: how ``flash_attention`` reaches the kernels (here the
``repro_torch::flash_attention`` operator and its autograd).  Timed with
``chip_smoke.device_ms`` in the order base, change, change, base at
granite-3-2b's prefill shape (forward, no gradient) and its training shape
(forward with lse and autograd's backward), bf16; one JSON line each with
the four device times, the host microseconds a call takes to return, and
whether the two trees' outputs (and gradients) are bit-equal.  Then the card's name
and power limit as ``nvidia-smi`` gives them.  Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import filecmp
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

OPS = pathlib.Path("src/repro_torch/kernels/flash_attention/ops.py")
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "hopper.cuh")


def load_ops(base: pathlib.Path):
    spec = importlib.util.spec_from_file_location("base_flash_ops", base / OPS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True, type=pathlib.Path)
    args = ap.parse_args()
    for name in SOURCES:
        if not filecmp.cmp(ROOT / "src/repro_torch/csrc" / name,
                           args.base / "src/repro_torch/csrc" / name, shallow=False):
            raise SystemExit(f"{name} differs between the trees: use tools/ab_flash_bwd.py")
    import torch

    import chip_smoke as C
    from repro_torch.kernels.flash_attention import ops as change
    base = load_ops(args.base)
    g = torch.Generator(device="cuda").manual_seed(0)
    mk = lambda H: torch.randn(4, 2048, H, 64, device="cuda", generator=g,  # noqa: E731
                               dtype=torch.bfloat16).transpose(1, 2)
    q, k, v = mk(32), mk(8), mk(8)
    do = torch.randn(4, 32, 2048, 64, device="cuda", generator=g, dtype=torch.bfloat16)
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

    def prefill(mod):
        with torch.no_grad():
            return (mod.flash_attention(q, k, v, causal=True),)

    def train(mod):
        o = mod.flash_attention(qg, kg, vg, causal=True)
        return (o, *torch.autograd.grad(o, (qg, kg, vg), do))

    for case, fn in (("granite prefill bf16 4x32/8x2048x64 causal, forward", prefill),
                     ("granite train bf16 4x32/8x2048x64 causal, forward + backward", train)):
        # this tree first: the base's backward failed its first launch in a
        # process (CUDA error 1) when it ran before this tree's (H100, torch 2.11)
        same = all(torch.equal(a, b) for a, b in zip(fn(change), fn(base)))
        times, host = {}, {}
        for name, mod in (("base", base), ("change", change), ("change", change),
                          ("base", base)):
            dev_ms, host_ms = C.device_ms(torch, lambda m=mod: fn(m), n=20)
            times.setdefault(name, []).append(dev_ms)
            host.setdefault(name, []).append(host_ms * 1e3)
        print(json.dumps({"case": case, "ms": times, "host_us": host, "bit_equal": same}),
              flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
