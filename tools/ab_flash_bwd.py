#!/usr/bin/env python3
"""K4's backward and forward of two trees, timed in turns in one process.

    python3 tools/ab_flash_bwd.py --base build/parent

``--base`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` under ``build/``).  Its
``flash_attention_bwd.cu`` and ``flash_attention.cu`` are built with the
port's nvcc flags into ``build/ab/`` and called through the same C
interfaces as this tree's kernels, which ``repro_torch`` builds as usual.
For the bf16 rows of ``chip_smoke.K4_BWD_CASES`` (the backward) and
granite-3-2b's prefill (the forward) both are timed with
``chip_smoke.device_ms`` in the order base, change, change, base; each
case prints one JSON line with the four times and the two trees' largest
difference, over the base output's largest |value|.  Then the card's name
and power limit as ``nvidia-smi`` gives them.  Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

FORWARD_CASES = {"granite prefill bf16 4x32/8x2048x64 causal": ((4, 32, 8, 2048, 64), True, None)}


def build(base: pathlib.Path, name: str) -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, find_nvcc
    src = base / "src" / "repro_torch" / "csrc" / f"{name}.cu"
    out = ROOT / "build" / "ab" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def forward(fn, q, k, v, causal, window):
    """The wrapper's bf16 forward through the C interface ``fn``."""
    import torch
    B, Hq, S, D = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, B, Hq, k.shape[1],
             S, D, 1, *(s for x in (q, k, v, out) for s in x.stride()[:3]), D ** -0.5,
             int(causal), window or 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"forward launch failed: CUDA error {err}")
    return (out,)


def backward(fn, q, k, v, o, do, lse, causal, window):
    """The wrapper's backward through the C interface ``fn``; the scratch
    is as large as either tree's kernels need."""
    import torch
    B, Hq, S, D = q.shape
    Hk = k.shape[1]
    scratch = torch.empty(2 * B * Hq * (-(-S // 128) * 128), dtype=torch.float32, device="cuda")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk, dv = (torch.empty((B, Hk, S, D), dtype=q.dtype, device="cuda") for _ in range(2))
    strides = (ctypes.c_longlong * 24)(*(s for x in (q, k, v, o, do, dq, dk, dv)
                                         for s in x.stride()[:3]))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
             lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             B, Hq, Hk, S, D, 1, strides, D ** -0.5, int(causal), window or 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"backward launch failed: CUDA error {err}")
    return dq, dk, dv


def differ(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max() / y.float().abs().max())
               for x, y in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=pathlib.Path, required=True)
    args = ap.parse_args()
    import torch

    from chip_smoke import K4_BWD_CASES, device_ms, nvidia_smi
    from repro_torch.kernels.flash_attention.ops import (_backward_launcher, _forward,
                                                         _launcher)
    fns = {}
    for name, symbol, change in (
            ("flash_attention", "flash_attention_launch", _launcher()),
            ("flash_attention_bwd", "flash_attention_backward_launch", _backward_launcher())):
        base = getattr(build(args.base, name), symbol)
        base.argtypes, base.restype = change.argtypes, change.restype
        fns[name] = {"base": base, "change": change}

    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [("forward", name, shape, causal, window, True)
             for name, (shape, causal, window) in FORWARD_CASES.items()]
    cases += [("backward", name, shape, causal, window, strided)
              for name, (shape, causal, window, dtype, strided) in K4_BWD_CASES.items()
              if dtype == "bfloat16"]
    for what, name, (B, Hq, Hk, S, D), causal, window, strided in cases:
        q, k, v, do = (torch.randn(B, S, h, D, generator=gen, device="cuda")
                       .to(torch.bfloat16).transpose(1, 2) for h in (Hq, Hk, Hk, Hq))
        if not strided:
            q, k, v, do = (x.contiguous() for x in (q, k, v, do))
        if what == "forward":
            call = {t: (lambda f=f: forward(f, q, k, v, causal, window))
                    for t, f in fns["flash_attention"].items()}
        else:
            o, lse = _forward(q, k, v, causal, window, D ** -0.5, True)
            call = {t: (lambda f=f: backward(f, q, k, v, o, do, lse, causal, window))
                    for t, f in fns["flash_attention_bwd"].items()}
        diff = differ(call["change"](), call["base"]())
        ms = {t: [] for t in ("base", "change")}
        for t in ("base", "change", "change", "base"):
            ms[t].append(device_ms(torch, call[t], n=20)[0])
        print(json.dumps(dict(kernel=what, case=name, shape=[B, Hq, Hk, S, D], base_ms=ms["base"],
                              change_ms=ms["change"],
                              base_over_change=sum(ms["base"]) / sum(ms["change"]),
                              max_normwise_difference=diff)), flush=True)
        del q, k, v, do, call
        torch.cuda.empty_cache()
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
