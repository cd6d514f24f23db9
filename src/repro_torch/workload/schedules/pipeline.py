"""Pipeline-parallel send/recv schedules with explicit bubbles.

``build_training_program`` already threads GPipe-style microbatch
dependencies through a full TP x EP x DP x PP program; this module emits
the *bare* pipeline — one stage chain, forward activations down, gradient
activations back — so schedules, benches, and tests can study pipeline
bubbles (the head/tail idle slots the dependency DAG forces) without the
rest of the parallelism overlay.

Copy of ``repro.workload.schedules.pipeline``, which the port may not import.
"""
from __future__ import annotations

from repro_torch.workload import collectives as C
from repro_torch.workload.traffic import Phase


def pipeline_phases(stages, n_microbatches, act_bytes, fid, cca="dctcp",
                    tag="pp", t_fwd=0.0, t_bwd=None):
    """GPipe forward+backward over an explicit rank chain.

    Phase (m, s) computes for ``t_fwd`` (``t_bwd`` on the way back,
    defaulting to 2x), then sends its activation to stage s+1 (gradient to
    s-1 on the backward pass).  Dependencies: fwd(m,s) needs fwd(m,s-1)
    and fwd(m-1,s); bwd(m,s) needs the last fwd plus bwd(m,s+1) and
    bwd(m-1,s) — the classic (S-1)-deep warmup/drain bubbles fall out of
    the DAG rather than being scheduled explicitly.
    """
    S = len(stages)
    if S < 2:
        raise ValueError(f"pipeline needs >= 2 stages, got {S}")
    if n_microbatches < 1:
        raise ValueError(f"pipeline needs >= 1 microbatch, got {n_microbatches}")
    if t_bwd is None:
        t_bwd = 2 * t_fwd
    phases: list[Phase] = []
    idx: dict[tuple, int] = {}

    def add(name, flows, deps, compute):
        phases.append(Phase(name, flows, deps, compute))
        return len(phases) - 1

    for m in range(n_microbatches):
        for s in range(S):
            deps = []
            if s > 0:
                deps.append(idx[("f", m, s - 1)])
            if m > 0:
                deps.append(idx[("f", m - 1, s)])
            flows = (C.p2p(stages[s], stages[s + 1], act_bytes, fid, cca,
                           f"{tag}.fwd") if s < S - 1 else [])
            idx[("f", m, s)] = add(f"{tag}.fwd.m{m}.s{s}", flows, deps, t_fwd)
    for m in range(n_microbatches):
        for s in reversed(range(S)):
            deps = [idx[("f", n_microbatches - 1, S - 1)]]
            if s < S - 1:
                deps.append(idx[("b", m, s + 1)])
            if m > 0:
                deps.append(idx[("b", m - 1, s)])
            flows = (C.p2p(stages[s], stages[s - 1], act_bytes, fid, cca,
                           f"{tag}.bwd") if s > 0 else [])
            idx[("b", m, s)] = add(f"{tag}.bwd.m{m}.s{s}", flows, deps, t_bwd)
    return phases


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Analytic GPipe bubble fraction (S-1)/(M+S-1): the share of each
    rank's timeline spent idle at pipeline warmup/drain when every
    microbatch costs the same."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
