"""Roofline terms of a dry-run cell on H100s (no real hardware).

    compute term    = FLOPs / (chips × 989 TFLOP/s bf16)
    memory term     = HBM bytes / (chips × 3.35 TB/s)
    collective term = collective bytes per chip / 450 GB/s (NVLink 4, one way)

A port of ``repro.launch.roofline`` with the H100 SXM's data-sheet
constants in place of the reference's TPU ones.  ``collective_bytes``
parses HLO text as the reference's does (kept for parity);
:func:`traced_collective_bytes` is the torch source: the output bytes of the
``_c10d_functional`` collectives recorded while a step is traced, per kind.
Both are per-device bytes (the reference's post-SPMD result shapes; here
the local shards of the DTensors).
"""
from __future__ import annotations

import re

from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12      # bf16 dense per H100 SXM (NVIDIA data sheet)
HBM_BW = 3.35e12         # bytes/s per H100 SXM, HBM3 (NVIDIA data sheet)
ICI_BW = 450e9           # bytes/s one way per H100 SXM: NVLink 4, 900 GB/s both ways (data sheet)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLL_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+\[[\d,]*\][^ ]*))\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(", re.M)
_SHAPE_RE = re.compile(r"(\w+?)\[([\d,]*)\]")

# the _c10d_functional ops DTensor and the functional collectives emit -> kind
TRACED_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _shape_bytes(typed: str) -> float:
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(typed):
        nb = _DTYPE_BYTES.get(dt)
        if nb is None:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * nb
    return total


def collective_bytes(hlo_text: str) -> dict[str, float]:
    """Per-collective-kind result bytes summed over the module (per-device,
    since post-SPMD shapes are per-shard)."""
    out: dict[str, float] = {}
    for m in _COLL_RE.finditer(hlo_text):
        typed = m.group(1) or m.group(2)
        kind = m.group(3)
        # "-start" ops are paired with "-done"; count the start only
        span_txt = hlo_text[m.start():m.start() + 40]
        if "-done(" in span_txt:
            continue
        out[kind] = out.get(kind, 0.0) + _shape_bytes(typed)
    return out


class CollectiveRecorder(TorchDispatchMode):
    """Records the output bytes and the count of every ``_c10d_functional``
    collective dispatched under it, per kind (:data:`TRACED_KINDS`): the
    bytes of the local tensors, one device's.  Real and fake tensors alike."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented            # let DTensor lower the op to its collectives first
        out = func(*args, **(kwargs or {}))
        kind = TRACED_KINDS.get(func._opname) if func.namespace == "_c10d_functional" else None
        if kind is not None:
            self.bytes[kind] = self.bytes.get(kind, 0.0) + float(out.numel() * out.element_size())
            self.counts[kind] = self.counts.get(kind, 0) + 1
        return out


def traced_collective_bytes(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), {kind: bytes}, {kind: count})``: the
    collectives' per-device output bytes and counts while ``fn`` runs."""
    with CollectiveRecorder() as rec:
        out = fn(*args, **kwargs)
    return out, rec.bytes, rec.counts


def roofline(flops: float, hbm_bytes: float, coll_bytes: float,
             chips: int) -> dict:
    """All inputs are whole-job totals except coll_bytes (per-chip)."""
    t_compute = flops / (chips * PEAK_FLOPS)
    t_memory = hbm_bytes / (chips * HBM_BW)
    t_coll = coll_bytes / ICI_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms.update({
        "dominant": dom.replace("_s", ""),
        "roofline_fraction": (t_compute / bound) if bound > 0 else 0.0,
    })
    return terms


def model_flops(n_params: float, n_active: float, tokens: float,
                kind: str) -> float:
    """6·N·D (train) / 2·N·D (prefill/decode) with active params for MoE."""
    if kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens
