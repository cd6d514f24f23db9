"""Pipeline parallelism over ``torch.distributed`` point-to-point ops
(GPipe schedule).

A port of ``repro.parallel.pipeline``.  Each rank of the group is one stage
and holds that stage's parameters; microbatches stream through the stages
with a handoff to rank ``(i + 1) % P`` each tick (the reference's
``ppermute``), as ``isend``/``irecv`` pairs.  Bubble fraction =
(P-1)/(M+P-1), so callers should set microbatches M >> stages P.  Runs
under gloo on the CPU as under NCCL on the card.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import map_tree


def pipeline_apply(stage_fn, n_microbatches: int, group=None):
    """``run(stage_params, xs) -> outs``, called on every rank of ``group``
    with that rank's stage parameters: ``stage_fn(stage_params, x_mb) ->
    y_mb`` applied stage after stage.  ``xs``: ``[M, mb, ...]``, the same on
    every rank (only stage 0 reads it); returns the last stage's outputs in
    the same layout, on every rank.

    The reference's schedule: M + P − 1 ticks; at tick t stage 0 ingests
    microbatch ``min(t, M − 1)`` and every other stage the handoff; a stage
    is active while ``0 <= t − stage < M`` and its output is zeroed
    otherwise (bubble ticks compute on what they hold, and are masked); the
    last stage records microbatch ``t − stage``; a final sum over the group
    replicates the outputs."""
    import torch.distributed as dist
    M = n_microbatches

    def run(stage_params, xs):
        P = dist.get_world_size(group)
        stage = dist.get_rank(group)
        nxt = dist.get_global_rank(group, (stage + 1) % P) if group else (stage + 1) % P
        prv = dist.get_global_rank(group, (stage - 1) % P) if group else (stage - 1) % P
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(M + P - 1):
            x = xs[min(t, M - 1)] if stage == 0 else buf
            active = 0 <= t - stage < M
            y = stage_fn(stage_params, x)
            if not active:
                y = torch.zeros_like(y)
            if active and stage == P - 1:
                outs[t - stage] = y
            if P == 1:
                buf = y
                continue
            buf = torch.empty_like(y)
            y = y.contiguous()
            for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, y, nxt, group),
                                               dist.P2POp(dist.irecv, buf, prv, group)]):
                req.wait()
        # only the final stage recorded real outputs; make them replicated
        dist.all_reduce(outs, group=group)
        return outs

    return run


def stage_split(params_stacked, n_stages: int):
    """Reshape a ``[L, ...]``-stacked layer tree into ``[P, L/P, ...]`` so
    that index ``i`` of the leading axis is stage ``i``'s parameters."""
    def one(x):
        L = x.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} stages")
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])
    return map_tree(one, params_stacked)
