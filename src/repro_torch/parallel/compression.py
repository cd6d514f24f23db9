"""Gradient compression with error feedback (distributed-optimization trick
for bandwidth-bound DP at 1000+-node scale).

Two codecs, both with per-leaf error-feedback residuals [Seide'14; Lin'18]:
  * top-k sparsification (keep the k largest-magnitude entries per leaf)
  * int8 quantisation (per-leaf absmax scaling)

The train loop applies ``compress -> (wire) -> decompress`` to the
gradients before the optimizer update; on one device the "wire" is
implicit, so the measurable effect is the accuracy contract (tests) and the
wire-bytes accounting consumed by the workload generator (a compressed DP
phase shrinks the elephant flows by the compression ratio).

A port of ``repro.parallel.compression`` in PyTorch: the same arithmetic in
float32 on the gradients' device.  ``torch.round`` rounds half to even, as
``jnp.round`` does; top-k keeps every entry at least as large as the k-th
largest magnitude, as the reference's ``>=`` threshold does.  Gradient and
residual trees are nested dicts of tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import map_tree


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"            # none | topk | int8
    topk_frac: float = 0.01
    error_feedback: bool = True

    def wire_ratio(self) -> float:
        """Fraction of raw gradient bytes on the wire (for traffic gen)."""
        if self.kind == "topk":
            return self.topk_frac * 3.0   # values + indices overhead
        if self.kind == "int8":
            return 0.25                   # bf16 -> int8 + scales
        return 1.0


def init_residuals(grads):
    return map_tree(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)


def _one(g, r, cfg: CompressionConfig):
    gf = g.float() + r if cfg.error_feedback else g.float()
    if cfg.kind == "int8":
        scale = torch.clamp_min(gf.abs().max(), 1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
    elif cfg.kind == "topk":
        flat = gf.reshape(-1)
        k = max(1, int(cfg.topk_frac * flat.numel()))
        thresh = torch.topk(flat.abs(), k).values[-1]
        deq = torch.where(flat.abs() >= thresh, flat, 0.0).reshape(gf.shape)
    else:
        raise ValueError(cfg.kind)
    new_r = gf - deq if cfg.error_feedback else r
    return deq.to(g.dtype), new_r


def compress_decompress(grads, residuals, cfg: CompressionConfig):
    """Returns (decompressed grads as seen after the wire, new residuals)."""
    if cfg.kind == "none":
        return grads, residuals
    if isinstance(grads, dict):
        out = {k: compress_decompress(grads[k], residuals[k], cfg) for k in sorted(grads)}
        return {k: v[0] for k, v in out.items()}, {k: v[1] for k, v in out.items()}
    return _one(grads, residuals, cfg)
