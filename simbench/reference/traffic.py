"""Per-iteration traffic programs for LLM training (paper Table 1).

A program is a DAG of phases; each phase models "compute for t seconds, then
launch these flows".  The schedule is GPipe-like with micro-batch-granular
dependencies:

    fwd(m,s)  <- fwd(m,s-1) [p2p arrival], fwd(m-1,s) [stage busy]
    bwd(m,s)  <- bwd(m,s+1), bwd(m-1,s), last fwd
    dp(s)     <- all bwd(·,s): ring all-reduce of the stage's gradients
    (MoE)     EP all-to-all bytes aggregated into each fwd/bwd phase

Flow sizes and compute times carry a common ``scale`` so GB-scale real
workloads stay runnable in the Python oracle; ratios (and therefore Wormhole
speedups/errors) are preserved.

Frozen copy of ``src/repro/workload/traffic.py``, the JAX package's pure-Python
module (no JAX in it), which the port's tests hold the port to; part of
the benchmark's plain reference: its imports are rewritten to stay inside
``simbench``, and it imports neither the program nor the JAX package.
"""
from __future__ import annotations

import dataclasses

from simbench.reference.flows import FlowSpec
from simbench.reference import collectives as C
from simbench.reference.parallelism import ParallelismConfig, build_groups, rank_of


@dataclasses.dataclass
class TrafficModelSpec:
    """The slice of a model config the network cares about."""
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    params: float                    # total parameter count
    active_params: float = 0.0      # per-token active (MoE); 0 -> = params
    seq_len: int = 4096
    micro_batch: int = 1
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_layer_every: int = 1         # every k-th layer is MoE
    dtype_bytes: float = 2.0

    def __post_init__(self) -> None:
        if not self.active_params:
            self.active_params = self.params


@dataclasses.dataclass
class Phase:
    name: str
    flows: list[FlowSpec]
    deps: list[int]
    compute: float = 0.0


def build_training_program(
    spec: TrafficModelSpec,
    par: ParallelismConfig,
    cca: str = "dctcp",
    scale: float = 1.0,
    chip_flops: float = 197e12,
    mfu: float = 0.4,
    num_microbatches: int | None = None,
    straggler: tuple[int, float] | None = None,   # (rank, compute multiplier)
    fid_start: int = 0,
    ep_over_dp: int = 0,   # expert-parallel domains carved from the DP ranks
    collective: str = "ring",        # DP gradient-sync schedule (schedules pkg)
    topo_meta: dict | None = None,   # topology params, for locality-aware schedules
    extra_stragglers: dict[int, float] | None = None,  # rank -> multiplier (chaos)
) -> list[Phase]:
    if collective != "ring":
        # the frozen reference carries the ring gradient sync alone, which
        # is what the benchmark's configurations run
        raise ValueError(f"the benchmark's reference has no {collective!r} schedule")
    groups = build_groups(par)
    if ep_over_dp > 1 and spec.moe_experts:
        # DeepSpeed-style: EP groups reuse DP ranks; gradient rings keep the
        # full DP size, all-to-all domains span ep_over_dp consecutive DP
        # peers (paper Table 1's TP8-EP8-DP-PP overlay)
        eg = []
        for g in groups.dp_groups:
            for i in range(0, len(g), ep_over_dp):
                dom = g[i:i + ep_over_dp]
                if len(dom) > 1:
                    eg.append(dom)
        groups.ep_groups = eg
    fid = C.FidAlloc(fid_start)
    M = num_microbatches if num_microbatches is not None else max(par.pp, 1)
    tokens_mb = spec.micro_batch * spec.seq_len
    stage_layers = max(1, spec.n_layers // par.pp)
    stage_params = spec.params / par.pp
    stage_active = spec.active_params / par.pp

    # per-(microbatch, stage) compute on one rank (TP splits the math)
    t_fwd = 2 * stage_active * tokens_mb / (chip_flops * mfu * par.tp) * scale
    t_bwd = 2 * t_fwd
    act_bytes = spec.micro_batch * spec.seq_len * spec.d_model * spec.dtype_bytes \
        / par.tp * scale
    grad_bytes = stage_params / par.tp / max(par.ep, 1) * spec.dtype_bytes * scale

    moe_layers_stage = 0
    if spec.moe_experts and par.ep >= 1:
        moe_layers_stage = max(1, stage_layers // spec.moe_layer_every)
    a2a_bytes_per_rank = (
        tokens_mb * spec.d_model * spec.dtype_bytes * max(spec.moe_top_k, 1)
        * moe_layers_stage / par.tp * scale
    ) if moe_layers_stage else 0.0

    slow: dict[int, float] = {}
    if straggler:
        slow[int(straggler[0])] = float(straggler[1])
    for r, f in (extra_stragglers or {}).items():
        slow[int(r)] = slow.get(int(r), 1.0) * float(f)
    slow_ranks = sorted(slow)

    def straggle(rank_list: list[int], t: float) -> float:
        for r in slow_ranks:
            if r in rank_list:
                t = t * slow[r]
        return t

    phases: list[Phase] = []
    idx: dict[tuple, int] = {}

    def add(name: str, flows: list[FlowSpec], deps: list[int], compute: float) -> int:
        phases.append(Phase(name, flows, deps, compute))
        return len(phases) - 1

    def stage_ranks(s: int) -> list[int]:
        return [rank_of(par, t, e, d, s)
                for d in range(par.dp) for e in range(par.ep) for t in range(par.tp)]

    # ---------------- forward ---------------- #
    for m in range(M):
        for s in range(par.pp):
            deps = []
            if s > 0:
                deps.append(idx[("f", m, s - 1)])
            if m > 0:
                deps.append(idx[("f", m - 1, s)])
            flows: list[FlowSpec] = []
            if a2a_bytes_per_rank:
                for g in groups.ep_groups:
                    if groups.stage_of[g[0]] == s:
                        flows += C.all_to_all(g, 2 * a2a_bytes_per_rank, fid, cca,
                                              f"ep.fwd.m{m}.s{s}")
            if s < par.pp - 1:
                for (a, b) in groups.pp_pairs[s]:
                    flows += C.p2p(a, b, act_bytes, fid, cca, f"pp.fwd.m{m}.s{s}")
            idx[("f", m, s)] = add(f"fwd.m{m}.s{s}", flows, deps,
                                   straggle(stage_ranks(s), t_fwd))

    # ---------------- backward ---------------- #
    for m in range(M):
        for s in reversed(range(par.pp)):
            deps = [idx[("f", M - 1, par.pp - 1)]]
            if s < par.pp - 1:
                deps.append(idx[("b", m, s + 1)])
            if m > 0:
                deps.append(idx[("b", m - 1, s)])
            flows = []
            if a2a_bytes_per_rank:
                for g in groups.ep_groups:
                    if groups.stage_of[g[0]] == s:
                        flows += C.all_to_all(g, 2 * a2a_bytes_per_rank, fid, cca,
                                              f"ep.bwd.m{m}.s{s}")
            if s > 0:
                for (a, b) in groups.pp_pairs[s - 1]:
                    flows += C.p2p(b, a, act_bytes, fid, cca, f"pp.bwd.m{m}.s{s}")
            idx[("b", m, s)] = add(f"bwd.m{m}.s{s}", flows, deps,
                                   straggle(stage_ranks(s), t_bwd))

    # ---------------- gradient sync (the elephants) ---------------- #
    for s in range(par.pp):
        deps = [idx[("b", m, s)] for m in range(M)]
        flows = []
        for g in groups.dp_groups:
            if groups.stage_of[g[0]] == s:
                flows += C.ring_allreduce(g, grad_bytes, fid, cca, f"dp.s{s}")
        if flows:
            add(f"dp.s{s}", flows, deps, 0.0)
    return phases
