"""Parallelism-group construction and rank→host placement.

Megatron-style rank order (tp fastest, then ep, dp, pp):
    rank = tp_idx + tp·(ep_idx + ep·(dp_idx + dp·pp_idx))

Each GPU is one simulated host (multi-NIC servers, paper §7).  With
tp == gpus_per_server a TP group occupies exactly one server, so TP/SP
traffic stays inside the NVLink domain and is not simulated (the paper's
setting: "existing works on LLM training simulation commonly neglect TP and
SP flows", §7); DP rings then connect the same intra-server position across
servers — i.e. they stay on one rail of a rail-optimized fabric.

Frozen copy of ``src/repro/workload/parallelism.py``, the JAX package's pure-Python
module (no JAX in it), which the port's tests hold the port to; part of
the benchmark's plain reference: its imports are rewritten to stay inside
``simbench``, and it imports neither the program nor the JAX package.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ParallelismConfig:
    tp: int = 8
    dp: int = 1
    pp: int = 1
    ep: int = 1

    @property
    def world(self) -> int:
        return self.tp * self.dp * self.pp * self.ep


@dataclasses.dataclass
class Groups:
    par: ParallelismConfig
    dp_groups: list[list[int]]      # each: ranks forming one DP ring
    ep_groups: list[list[int]]      # each: ranks in one all-to-all domain
    pp_pairs: list[list[tuple[int, int]]]  # per stage boundary: (src, dst) ranks
    stage_of: dict[int, int]        # rank -> pipeline stage


def rank_of(cfg: ParallelismConfig, tp_i: int, ep_i: int, dp_i: int, pp_i: int) -> int:
    return tp_i + cfg.tp * (ep_i + cfg.ep * (dp_i + cfg.dp * pp_i))


def build_groups(cfg: ParallelismConfig) -> Groups:
    dp_groups, ep_groups = [], []
    stage_of: dict[int, int] = {}
    for pp_i in range(cfg.pp):
        for dp_i in range(cfg.dp):
            for ep_i in range(cfg.ep):
                for tp_i in range(cfg.tp):
                    stage_of[rank_of(cfg, tp_i, ep_i, dp_i, pp_i)] = pp_i
    # DP rings: fixed (tp, ep, pp), vary dp
    for pp_i in range(cfg.pp):
        for ep_i in range(cfg.ep):
            for tp_i in range(cfg.tp):
                g = [rank_of(cfg, tp_i, ep_i, dp_i, pp_i) for dp_i in range(cfg.dp)]
                if len(g) > 1:
                    dp_groups.append(g)
    # EP all-to-all domains: fixed (tp, dp, pp), vary ep
    for pp_i in range(cfg.pp):
        for dp_i in range(cfg.dp):
            for tp_i in range(cfg.tp):
                g = [rank_of(cfg, tp_i, ep_i, dp_i, pp_i) for ep_i in range(cfg.ep)]
                if len(g) > 1:
                    ep_groups.append(g)
    # PP boundaries: stage s rank -> same (tp, ep, dp) rank at stage s+1
    pp_pairs = []
    for pp_i in range(cfg.pp - 1):
        pairs = []
        for dp_i in range(cfg.dp):
            for ep_i in range(cfg.ep):
                for tp_i in range(cfg.tp):
                    pairs.append((rank_of(cfg, tp_i, ep_i, dp_i, pp_i),
                                  rank_of(cfg, tp_i, ep_i, dp_i, pp_i + 1)))
        pp_pairs.append(pairs)
    return Groups(par=cfg, dp_groups=dp_groups, ep_groups=ep_groups,
                  pp_pairs=pp_pairs, stage_of=stage_of)
