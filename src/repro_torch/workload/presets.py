"""Paper Table 1 workloads.

| # GPUs | GPT size, parallel      | MoE size, parallel             |
|   64   | 7B,  TP8-DP4-PP2        | 8×7B,  TP8-EP8-DP4-PP2 (*)     |
|  128   | 13B, TP8-DP4-PP4        | 8×13B, TP8-EP8-DP4-PP4 (*)     |
|  256   | 22B, TP8-DP8-PP4        | 8×22B, TP8-EP8-DP8-PP4 (*)     |
| 1024   | 175B, TP8-DP16-PP8      | 32×22B, TP8-EP8-DP16-PP8 (*)   |

(*) The paper's Table-1 MoE rows multiply out past the GPU count if EP is an
extra dimension; as in Megatron/DeepSpeed practice, EP reuses the DP ranks
(expert-parallel groups are a re-grouping of the data-parallel dimension).
We therefore carve EP groups out of DP: ep_from_dp=True splits each DP group
of size dp into dp/ep rings and forms all-to-all domains of size ep.
For the network, what matters is that all-to-all domains of size ep exist —
we model EP groups over the DP dimension with ep ≤ dp, and keep the DP ring
at full size (gradient sync is unchanged by expert placement).

Beside the two families, public models by name (``NAMED``), each at the
Table-1 MoE row's parallelism for its GPU count: MiniMax-Text-01 (80
layers, every one an expert layer of 32 experts, top-2) has the width,
expert count and top-k of the 1024-GPU row's 32×22B.

The PyTorch port keeps its own copy of ``repro.workload.presets``, which the
port may not import; the tests hold the two to identical outputs for the
``gpt`` and ``moe`` families.
"""
from __future__ import annotations

import dataclasses

from repro_torch.workload.parallelism import ParallelismConfig
from repro_torch.workload.traffic import TrafficModelSpec


@dataclasses.dataclass
class Workload:
    name: str
    spec: TrafficModelSpec
    par: ParallelismConfig
    n_gpus: int


def _gpt(name, layers, d_model, d_ff, params):
    return TrafficModelSpec(name=name, n_layers=layers, d_model=d_model,
                            d_ff=d_ff, vocab=50304, params=params)


def _moe(name, layers, d_model, d_ff, params, active, experts=8, top_k=2):
    return TrafficModelSpec(name=name, n_layers=layers, d_model=d_model,
                            d_ff=d_ff, vocab=50304, params=params,
                            active_params=active, moe_experts=experts,
                            moe_top_k=top_k, moe_layer_every=1)


GPT = {
    64: Workload("gpt-7b@64", _gpt("gpt-7b", 32, 4096, 16384, 7e9),
                 ParallelismConfig(tp=8, dp=4, pp=2), 64),
    128: Workload("gpt-13b@128", _gpt("gpt-13b", 40, 5120, 20480, 13e9),
                  ParallelismConfig(tp=8, dp=4, pp=4), 128),
    256: Workload("gpt-22b@256", _gpt("gpt-22b", 48, 6144, 24576, 22e9),
                  ParallelismConfig(tp=8, dp=8, pp=4), 256),
    1024: Workload("gpt-175b@1024", _gpt("gpt-175b", 96, 12288, 49152, 175e9),
                   ParallelismConfig(tp=8, dp=16, pp=8), 1024),
}

# EP groups are carved out of DP (ep ≤ dp): TP8-EP(≤dp)-DP-PP over the same
# GPU counts as the GPT rows.
MOE = {
    64: Workload("moe-8x7b@64", _moe("moe-8x7b", 32, 4096, 14336, 47e9, 13e9),
                 ParallelismConfig(tp=8, dp=4, pp=2, ep=1), 64),
    128: Workload("moe-8x13b@128", _moe("moe-8x13b", 40, 5120, 17920, 84e9, 23e9),
                  ParallelismConfig(tp=8, dp=4, pp=4, ep=1), 128),
    256: Workload("moe-8x22b@256", _moe("moe-8x22b", 56, 6144, 16384, 141e9, 39e9),
                  ParallelismConfig(tp=8, dp=8, pp=4, ep=1), 256),
    1024: Workload("moe-32x22b@1024", _moe("moe-32x22b", 56, 6144, 16384, 520e9, 44e9,
                                           experts=32, top_k=2),
                   ParallelismConfig(tp=8, dp=16, pp=8, ep=1), 1024),
}
# network EP domain size for MoE rows (all-to-all over this many DP ranks)
MOE_EP_DOMAIN = 8

# MiniMax-Text-01 (huggingface.co/MiniMaxAI/MiniMax-Text-01, config.json):
# hidden 6144, expert width 9216, vocabulary 200 064; 456B total and 45.9B
# active parameters, as its model card gives them
MINIMAX_TEXT_01 = TrafficModelSpec(
    name="minimax-text-01", n_layers=80, d_model=6144, d_ff=9216, vocab=200064,
    params=456e9, active_params=45.9e9, moe_experts=32, moe_top_k=2, moe_layer_every=1)

# public models by name, at the Table-1 MoE layouts alone
NAMED = {
    "minimax-text-01": {n: Workload(f"minimax-text-01@{n}", MINIMAX_TEXT_01, wl.par, n)
                        for n, wl in MOE.items()},
}
FAMILIES = ("gpt", "moe", *NAMED)


def resolve(family: str, n_gpus: int) -> tuple[TrafficModelSpec,
                                               ParallelismConfig, int]:
    """(spec, parallelism, default ep_over_dp) for a Table-1 row.  Sizes
    off the table fall back to the 64-GPU spec with TP8-PP2 and DP grown to
    n_gpus/16 (the scaling rule the benchmarks use); MoE keeps at least two
    DP ranks so the EP all-to-all domains stay non-trivial.  A named model
    runs at the Table-1 GPU counts alone."""
    if family in NAMED:
        rows = NAMED[family]
        if n_gpus not in rows:
            raise ValueError(f"{family} runs on {', '.join(map(str, rows))} GPUs "
                             f"(the Table-1 MoE layouts); got {n_gpus}")
        wl = rows[n_gpus]
        return wl.spec, wl.par, min(MOE_EP_DOMAIN, wl.par.dp)
    if family == "moe":
        if n_gpus in MOE:
            wl = MOE[n_gpus]
            return wl.spec, wl.par, min(MOE_EP_DOMAIN, wl.par.dp)
        dp = max(2, n_gpus // 16)
        return (MOE[64].spec, ParallelismConfig(tp=8, dp=dp, pp=2, ep=1),
                min(MOE_EP_DOMAIN, dp))
    if family != "gpt":
        raise ValueError(f"unknown workload family {family!r}; have {', '.join(FAMILIES)}")
    if n_gpus in GPT:
        wl = GPT[n_gpus]
        return wl.spec, wl.par, 0
    dp = max(1, n_gpus // 16)
    return GPT[64].spec, ParallelismConfig(tp=8, dp=dp, pp=2), 0
