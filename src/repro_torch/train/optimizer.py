"""AdamW (from scratch — no optax in this environment) with global-norm
clipping, cosine schedule, and configurable state dtype (bf16 for the
≥100B-param configs, ``opt_dtype="bfloat16"``).

A port of ``repro.train.optimizer`` in PyTorch.  The arithmetic is float32
in the reference's order: the schedule from an int32 step, ``b1 ** step``
in float32, the moments and the update per leaf in float32, cast back to
the parameter and state dtypes.  Leaves are taken in sorted-key order,
JAX's flatten order for dicts, so :func:`global_norm` sums in the same
order.  :func:`update` writes the new parameters and moments **in place**
(the reference returns new trees) so a step holds no second copy of them;
it returns the same trees.  A leaf stacked over many layers is updated a
slice of its leading axis at a time (at most :data:`UPDATE_CHUNK`
elements), so the float32 temporaries stay small; every element's
arithmetic is the same.

Sharded leaves (DTensors, :mod:`repro_torch.parallel.sharding`): each
gradient is first placed as its parameter is (a reduce-scatter where
autograd left it partial), :func:`global_norm` stays a DTensor reduction
(its all-reduce is the clip's one collective), and the elementwise update
runs on each leaf's local shard, which is exact for an elementwise rule.
Plain tensors take exactly the unsharded path.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.params import leaves, map_tree

STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
UPDATE_CHUNK = 1 << 24     # elements a float32 temporary of the update holds at most


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000
    state_dtype: torch.dtype = torch.float32


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int, or an int32 tensor), a float32
    tensor on the step's device."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp_max(step / max(cfg.warmup, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_state(params, cfg: AdamWConfig):
    zeros = lambda p: torch.zeros_like(p, dtype=cfg.state_dtype,  # noqa: E731
                                       memory_format=torch.contiguous_format)
    step_device = leaves(params)[0].device
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_device)}


def global_norm(tree):
    tot = None
    for g in leaves(tree):
        sq = torch.sum(torch.square(g.float()))
        tot = sq if tot is None else tot + sq
    return torch.sqrt(tot)


def _local(x):
    """A DTensor's local shard (sharing its storage); a plain tensor itself."""
    return x.to_local() if isinstance(x, DTensor) else x


def _placed_as(g, p):
    """Gradient ``g`` placed as its parameter ``p`` is."""
    if isinstance(p, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _slices(*leaves_):
    """The leaves, whole or as matching slices of their leading axis."""
    x = leaves_[0]
    if x.dim() == 0 or x.numel() <= UPDATE_CHUNK:
        yield leaves_
        return
    rows = max(1, UPDATE_CHUNK * x.shape[0] // x.numel())
    for i in range(0, x.shape[0], rows):
        yield tuple(t[i:i + rows] for t in leaves_)


@torch.no_grad()
def update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``, the
    parameters and the moments updated in place."""
    step = state["step"] + 1
    owners = iter(leaves(params))
    grads = map_tree(lambda g: _placed_as(g, next(owners)), grads)
    gn = global_norm(grads)
    if isinstance(gn, DTensor):
        gn = gn.full_tensor()
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gn, 1e-9), 1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    for p, g, m, v in (s for leaf in zip(leaves(params), leaves(grads), leaves(state["m"]),
                                          leaves(state["v"]))
                       for s in _slices(*map(_local, leaf))):
        g = g.float() * scale
        m2 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v2 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        mhat = m2 / b1c
        vhat = v2 / b2c
        step_v = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step_v)
        m.copy_(m2)
        v.copy_(v2)
    state["step"] = step
    return params, state, {"grad_norm": gn, "lr": lr}
