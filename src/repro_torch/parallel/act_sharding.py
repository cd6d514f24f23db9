"""Activation sharding constraints (sequence parallelism).

The dominant train-time memory term is the per-layer [B, S, d] activation
checkpoint.  Constraining it to (batch=("pod","data"), seq="model") shards
the checkpoints over *all* mesh axes — sequence parallelism in the
Megatron-SP sense; DTensor's sharding propagation inserts the all-gathers
inside attention where the full sequence is genuinely needed.

A port of ``repro.parallel.act_sharding``.  The launcher installs the
constraint (a ``DeviceMesh`` and its placements); model code calls
:func:`constrain` unconditionally — a no-op unless installed, and on plain
tensors.

The other functions are the port's layout decisions where DTensor, unlike
GSPMD, has no strategy for an op or cannot take a layout: each leaves a
plain tensor as it is, so the single-device path is unchanged.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_SPEC = None  # (DeviceMesh, placements) | None


def install(mesh, places=None) -> None:
    global _SPEC
    _SPEC = None if mesh is None else (mesh, tuple(places))


def clear() -> None:
    install(None)


def constrain(x):
    """``x`` redistributed to the installed placements when it is a 3-D
    DTensor and a constraint is installed; ``x`` itself otherwise."""
    if _SPEC is None or x.ndim != 3:
        return x
    if not isinstance(x, DTensor):
        return x
    mesh, places = _SPEC
    return x.redistribute(mesh, places)


def block_input(x):
    """``x`` ``[B, S, ...]`` as a block of the model takes it: its middle
    dims whole and its partial sums reduced, and, where a constraint is
    installed, its batch placed as the constraint places it and nothing
    else sharded.  The projections after it flatten ``[B, S, ...]``, which
    DTensor cannot do to a sharded S on every torch, and a block that
    starts from one layout leaves DTensor's own choices inside it
    predictable.  ``x`` itself for a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    if _SPEC is not None and x.ndim == 3 and x.device_mesh == _SPEC[0]:
        places = [p if p.is_shard(0) else Replicate() for p in _SPEC[1]]
        return x if places == list(x.placements) else x.redistribute(x.device_mesh, places)
    return replicate(x, tuple(range(1, x.ndim - 1)))


def settled(x):
    """``x`` itself; on a DTensor, through an identity redistribution, so
    that its gradient is laid out as ``x`` is before it reaches the op that
    made ``x`` (DTensor otherwise leaves a gradient where the strategies of
    ``x``'s consumers put it, which can be a layout that the producer's
    backward can only reach through a ``_StridedShard``)."""
    return x.redistribute(x.device_mesh, x.placements) if isinstance(x, DTensor) else x


def replicate(x, dims: tuple[int, ...]):
    """``x`` with its shards along tensor ``dims`` gathered and any partial
    sums reduced (a DTensor whose other placements stay), for an op that
    DTensor cannot run on a sharded dim; ``x`` itself when it is a plain
    tensor or already whole there."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    places = [Replicate() if p.is_partial() or (p.is_shard() and p.dim in dims) else p
              for p in x.placements]
    return x if places == list(x.placements) else x.redistribute(x.device_mesh, places)


def splittable(x, dim: int, lead: int):
    """``x`` ready for its ``dim`` to be split into ``(lead, rest)``: the
    shards of that dim gathered where a mesh dim that shards it does not
    divide ``lead`` (DTensor cannot split such a shard); ``x`` itself
    otherwise, and for plain tensors."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    if any(p.is_shard(dim) and lead % x.device_mesh.size(i) for i, p in enumerate(x.placements)):
        return replicate(x, (dim,))
    return x


class _MergeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.heads = tuple(x.shape[-2:])
        return splittable(x, -2, x.shape[-2]).flatten(-2)

    @staticmethod
    def backward(ctx, g):
        return splittable(g, -1, ctx.heads[0]).unflatten(-1, ctx.heads)


def merge_heads(x):
    """``x`` ``[..., H, k]`` as ``[..., H * k]``; on a DTensor its gradient
    is split back into heads where DTensor can split it
    (:func:`splittable`), which a view's backward does not do."""
    return _MergeHeads.apply(x) if isinstance(x, DTensor) else x.flatten(-2)


def on_replicas(fn, *args):
    """``fn(*args)`` for a block that DTensor cannot shard (an op with no
    sharding strategy): DTensor arguments are gathered whole onto every
    rank, ``fn`` runs on the plain tensors, and its tensor outputs come back
    as replicated DTensors (differentiably).  Without a DTensor argument it
    is ``fn(*args)``."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    rep = [Replicate()] * mesh.ndim
    out = fn(*(a.redistribute(mesh, rep).to_local() if isinstance(a, DTensor) else a
               for a in args))

    def wrap(o):
        return DTensor.from_local(o, mesh, rep, run_check=False) \
            if isinstance(o, torch.Tensor) else o
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def by_heads(fn, *args, shared: tuple[int, ...] = ()):
    """``fn(*args)`` for an attention-like core that is independent across
    batch rows and heads: each tensor argument has its batch at dim 0 and
    its heads at dim 2 (``[B, T, H, ...]``), save those at the positions
    ``shared``, which every head reads (``[B, T, ...]``); ``fn`` gives
    ``[B, S, H, ...]``.  On DTensors each argument is laid out with its
    batch placed as the first DTensor argument's, its heads sharded over the
    other mesh dims, the last first, as far as H divides them, and
    everything else whole; ``fn`` runs on each rank's shards and its output
    comes back placed as the heads' arguments are.  So DTensor never
    reshapes a sharded dim inside the core (an einsum's flatten of sharded
    batch and heads makes a ``_StridedShard`` on torch 2.13, whose
    redistribution search takes minutes on a 3-D mesh; torch 2.11 refuses
    it).  A shared argument's gradient is a partial sum over the head
    shards.  Without a DTensor argument it is ``fn(*args)``."""
    lead = next((a for a in args if isinstance(a, DTensor)), None)
    if lead is None:
        return fn(*args)
    mesh, B, H = lead.device_mesh, lead.shape[0], lead.shape[2]
    batch = [Shard(0) if p.is_shard(0) else Replicate() for p in lead.placements]
    per_head, n = list(batch), 1
    for i in reversed(range(mesh.ndim)):
        if not batch[i].is_shard() and H % (n * mesh.size(i)) == 0:
            per_head[i], n = Shard(2), n * mesh.size(i)
    shared_grad = [Partial() if h.is_shard(2) else b for h, b in zip(per_head, batch)]

    def local(i, a):
        if not isinstance(a, DTensor):
            return a
        if i in shared:
            return a.redistribute(mesh, batch).to_local(grad_placements=shared_grad)
        return a.redistribute(mesh, per_head).to_local()
    out = fn(*(local(i, a) for i, a in enumerate(args))).contiguous()
    shape = (B, out.shape[1], H, *out.shape[3:])
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(out, mesh, per_head, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def pointwise(fn, x):
    """``fn(x)`` for an elementwise ``fn`` that DTensor has no strategy for:
    ``x``'s partial sums reduced first (``fn`` of a partial sum is not a
    part of ``fn`` of the sum), then ``fn`` run on each rank's shard and
    placed as ``x`` is (exact; no communication beyond that reduction).  A
    plain ``x`` gives ``fn(x)``."""
    if not isinstance(x, DTensor):
        return fn(x)
    x = replicate(x, ())
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape, stride=x.stride())


def replicated_like(t, ref):
    """``t`` as a replicated DTensor on ``ref``'s mesh when ``ref`` is a
    DTensor (a fresh state that sharded values are written into); ``t``
    itself otherwise."""
    if not isinstance(ref, DTensor):
        return t
    return DTensor.from_local(t, ref.device_mesh, [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


def write_at(t, index: int, value) -> None:
    """``t[:, index] = value`` in place.  On a DTensor whose dim 1 is
    sharded (the cache's sequence, for sequence-parallel decode) only the
    rank that holds ``index`` writes, into its own shard: ``value`` is
    placed as ``t`` is on the other dims, and nothing is gathered."""
    if not isinstance(t, DTensor):
        t[:, index] = value
        return
    mesh = t.device_mesh
    offset, size = 0, t.shape[1]
    for i, p in enumerate(t.placements):
        if p.is_shard(1):
            n, c = mesh.size(i), mesh.get_local_rank(i)
            chunk = -(-size // n)                 # torch.chunk's split, as DTensor's Shard
            offset, size = offset + c * chunk, max(0, min(chunk, size - c * chunk))
    if not offset <= index < offset + size:
        return
    if isinstance(value, DTensor):              # t's placements, dim 1 taken out
        value = value.redistribute(mesh, [
            Replicate() if p.is_shard(1) else Shard(p.dim - 1) if p.is_shard() and p.dim > 1
            else p for p in t.placements]).to_local()
    t.to_local()[:, index - offset] = value
