"""Analytic FLOPs / HBM-traffic / collective-bytes model per (arch × shape ×
mesh) cell.

Why analytic: XLA's cost analysis does not multiply through `while`
(scan-over-layers) trip counts, so both lowered and compiled FLOP counts
under-report by ~L× on CPU.  The einsum-level accounting below is exact for
our model definitions; the compiled-HLO collective parse (roofline.py)
remains as structural evidence of the schedule GSPMD chose.

Memory traffic is reported for the TPU-target implementation: attention
logits stay in VMEM (the flash_attention kernel exists and is validated),
so no S² HBM term; the einsum fallback's S² traffic is reported separately
as the un-optimised baseline (§Perf).

Copy of ``repro.launch.analytic``, which the port may not import: it counts
FLOPs, bytes and collective bytes exactly as the reference does (the train
phase's MFU takes ``cell_flops`` as its numerator).  The memory-traffic
note above describes the reference's TPU target.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (ATTN, ATTN_GLOBAL, ATTN_LOCAL, MAMBA, MLP,
                                      MLSTM, MOE, SLSTM, ArchConfig, ShapeCell)

BF16 = 2


# --------------------------------------------------------------------- #
# FLOPs (forward, whole job)
# --------------------------------------------------------------------- #
def _attn_flops(cfg, B, S, T, causal):
    H, Hk, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    d = cfg.d_model
    proj = 2 * B * S * d * (H + 2 * Hk) * hd + 2 * B * S * H * hd * d
    t_eff = T / 2 if (causal and S == T) else T
    qk = 2 * B * S * t_eff * H * hd * 2          # scores + values
    return proj + qk


def _mla_flops(cfg, B, S, T, causal):
    d, H = cfg.d_model, cfg.n_heads
    qh = cfg.nope_dim + cfg.rope_dim
    proj = (2 * B * S * d * cfg.q_lora + 2 * B * S * cfg.q_lora * H * qh
            + 2 * B * S * d * (cfg.kv_lora + cfg.rope_dim)
            + 2 * B * T * cfg.kv_lora * H * (cfg.nope_dim + cfg.v_head_dim)
            + 2 * B * S * H * cfg.v_head_dim * d)
    t_eff = T / 2 if (causal and S == T) else T
    qk = 2 * B * S * t_eff * H * (qh + cfg.v_head_dim)
    return proj + qk


def _mlp_flops(cfg, B, S, f=None):
    f = f or cfg.d_ff
    mats = 3 if cfg.mlp_kind == "swiglu" else 2
    return mats * 2 * B * S * cfg.d_model * f


def _moe_flops(cfg, B, S):
    d = cfg.d_model
    E, k = cfg.moe_experts, cfg.moe_top_k
    f = cfg.moe_d_ff or cfg.d_ff
    T = B * S
    cap = int(cfg.capacity_factor * T * k / E)
    router = 2 * T * d * E
    experts = 3 * 2 * E * cap * d * f
    if cfg.moe_dispatch == "einsum":
        dispatch = 2 * 2 * T * E * cap * d        # dense one-hot dispatch
    else:
        dispatch = 0.0                            # gather/scatter: data movement
    shared = _mlp_flops(cfg, B, S, f=f * cfg.moe_shared) if cfg.moe_shared else 0
    return router + experts + dispatch + shared


def _mamba_flops(cfg, B, S):
    d = cfg.d_model
    di = cfg.expand * d
    ds = cfg.d_state
    dtr = max(1, d // 16)
    return (2 * B * S * d * 2 * di + 2 * B * S * di * cfg.conv_kernel
            + 2 * B * S * di * (dtr + 2 * ds) + 2 * B * S * dtr * di
            + 8 * B * S * di * ds                 # selective scan elementwise
            + 2 * B * S * di * d)


def _mlstm_flops(cfg, B, S, T):
    d = cfg.d_model
    di = cfg.expand * d
    if S == 1:                                     # recurrent decode step
        H = cfg.n_heads
        hd = di // H
        return (2 * B * d * 2 * di + 3 * 2 * B * di * di
                + 6 * B * H * hd * hd + 2 * B * di * d)
    quad = 2 * B * S * (T / 2) * di * 2
    return (2 * B * S * d * 2 * di + 3 * 2 * B * S * di * di + quad
            + 2 * B * S * di * d)


def _slstm_flops(cfg, B, S):
    d = cfg.d_model
    di = cfg.expand * d
    H = cfg.n_heads
    hd = di // H
    return (2 * B * S * d * 4 * di + 2 * B * S * H * hd * 4 * hd
            + 2 * B * S * di * d)


def forward_flops(cfg: ArchConfig, B: int, S: int, T: int | None = None) -> float:
    """One forward pass over S new tokens against context T (= S if None)."""
    T = T or S
    total = 0.0
    for st in cfg.stages():
        for blk in st.blocks:
            if cfg.mla and blk.mixer == ATTN:
                m = _mla_flops(cfg, B, S, T, True)
            elif blk.mixer in (ATTN, ATTN_GLOBAL):
                w = cfg.window if cfg.attn_kind == "swa" else 0
                m = _attn_flops(cfg, B, S, min(T, w) if w else T, True)
            elif blk.mixer == ATTN_LOCAL:
                m = _attn_flops(cfg, B, S, min(T, cfg.window), True)
            elif blk.mixer == MAMBA:
                m = _mamba_flops(cfg, B, S)
            elif blk.mixer == MLSTM:
                m = _mlstm_flops(cfg, B, S, T)
            elif blk.mixer == SLSTM:
                m = _slstm_flops(cfg, B, S)
            else:
                raise ValueError(blk.mixer)
            f = 0.0
            if blk.ffn == MLP:
                f = _mlp_flops(cfg, B, S)
            elif blk.ffn == MOE:
                f = _moe_flops(cfg, B, S)
            total += (m + f) * st.repeat
    if cfg.enc_dec:   # encoder stack + cross attention
        total += cfg.n_layers * (_attn_flops(cfg, B, T, T, False)
                                 + _mlp_flops(cfg, B, T))
        total += cfg.n_layers * _attn_flops(cfg, B, S, T, False)
    total += 2 * B * S * cfg.d_model * cfg.vocab   # unembed/loss
    return total


def cell_flops(cfg: ArchConfig, cell: ShapeCell, remat: bool | None = None) -> dict:
    B, S = cell.global_batch, cell.seq_len
    remat = cfg.remat if remat is None else remat
    if cell.kind == "train":
        fwd = forward_flops(cfg, B, S)
        factor = 4.0 if remat else 3.0             # fwd + 2×bwd (+1 recompute)
        return {"fwd": fwd, "total": fwd * factor}
    if cell.kind == "prefill":
        fwd = forward_flops(cfg, B, S)
        return {"fwd": fwd, "total": fwd}
    fwd = forward_flops(cfg, B, 1, T=S)
    return {"fwd": fwd, "total": fwd}


# --------------------------------------------------------------------- #
# HBM traffic + capacity (per device)
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class MemoryModel:
    traffic_bytes: float          # whole-job HBM bytes moved (all chips)
    peak_bytes_per_device: float  # capacity high-water estimate
    naive_attn_extra: float       # S² logits traffic if einsum attention


def cell_memory(cfg: ArchConfig, cell: ShapeCell, n_params: float,
                chips: int, dp: int) -> MemoryModel:
    B, S = cell.global_batch, cell.seq_len
    d = cfg.d_model
    L = cfg.n_layers * (2 if cfg.enc_dec else 1)
    pbytes = n_params * BF16
    opt_bytes = 2 * n_params * (4 if cfg.opt_dtype == "float32" else 2)
    act_tensor = B * S * d * BF16
    if cell.kind == "train":
        # params read twice (fwd + recompute) + grads written/read + opt rw
        traffic = (3 * pbytes + 2 * pbytes + 2 * opt_bytes
                   + 10 * L * act_tensor)
        # checkpoints are sequence-parallel (constrained over dp×model)
        peak = (pbytes + pbytes + opt_bytes) / chips + L * act_tensor / chips \
            + 4 * act_tensor / dp
        naive = sum(st.repeat * B * (min(S, cfg.window) if
                    (blk.mixer == ATTN_LOCAL or cfg.attn_kind == "swa") and cfg.window
                    else S) * S * cfg.n_heads * 4
                    for st in cfg.stages() for blk in st.blocks
                    if blk.mixer in (ATTN, ATTN_GLOBAL, ATTN_LOCAL)) * 3
    elif cell.kind == "prefill":
        traffic = pbytes + 6 * L * act_tensor
        kv_bytes = _cache_bytes(cfg, B, S)
        peak = pbytes / chips + 2 * act_tensor / dp + kv_bytes / chips
        naive = L * B * S * S * cfg.n_heads * 4
    else:
        kv_bytes = _cache_bytes(cfg, B, S)
        traffic = pbytes + 2 * kv_bytes           # weights + cache read/write
        peak = (pbytes + kv_bytes) / chips + 2 * B * d * BF16
        naive = 0.0
    return MemoryModel(traffic_bytes=traffic, peak_bytes_per_device=peak,
                       naive_attn_extra=naive)


def _cache_bytes(cfg: ArchConfig, B: int, S: int) -> float:
    total = 0.0
    for st in cfg.stages():
        for blk in st.blocks:
            if cfg.mla and blk.mixer == ATTN:
                total += st.repeat * B * S * (cfg.kv_lora + cfg.rope_dim) * BF16
            elif blk.mixer in (ATTN, ATTN_GLOBAL, ATTN_LOCAL):
                w = cfg.window if (blk.mixer == ATTN_LOCAL
                                   or cfg.attn_kind == "swa") else 0
                T = min(S, w) if w else S
                total += st.repeat * 2 * B * T * cfg.n_kv * cfg.hd * BF16
            elif blk.mixer == MAMBA:
                di = cfg.expand * cfg.d_model
                total += st.repeat * B * di * (cfg.d_state * 4 + cfg.conv_kernel * BF16)
            elif blk.mixer in (MLSTM, SLSTM):
                di = cfg.expand * cfg.d_model
                H = cfg.n_heads
                hd = di // H
                total += st.repeat * B * H * (hd * hd + 2 * hd + 1) * 4
    if cfg.enc_dec:
        total += cfg.n_layers * 2 * B * min(S, 4096) * cfg.n_heads * cfg.hd * BF16
    return total


# --------------------------------------------------------------------- #
# Collective bytes per chip (ring algorithms; ICI links)
# --------------------------------------------------------------------- #
def cell_collectives(cfg: ArchConfig, cell: ShapeCell, n_params: float,
                     mesh_shape: dict) -> dict:
    """Per-chip bytes by source: ZeRO param gathers, grad reduce-scatter,
    TP activation all-reduces, MoE all-to-alls, vocab-sharded loss."""
    B, S = cell.global_batch, cell.seq_len
    model = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    d = cfg.d_model
    pbytes = n_params * BF16
    out = {"param_allgather": 0.0, "grad_reducescatter": 0.0,
           "tp_allreduce": 0.0, "moe_alltoall": 0.0, "loss_allreduce": 0.0}
    if cell.kind == "train":
        gathers = 3 if cfg.remat else 2           # fwd + bwd (+ recompute)
        out["param_allgather"] = gathers * pbytes * (dp - 1) / dp / model
        out["grad_reducescatter"] = pbytes * (dp - 1) / dp / model
        S_new, passes = S, 3                      # fwd+bwd activation ARs
    elif cell.kind == "prefill":
        out["param_allgather"] = pbytes * (dp - 1) / dp / model
        S_new, passes = S, 1
    else:
        tp_resident_gb = (n_params * 2 / model) / 1e9
        if tp_resident_gb > 8.0:
            # 2D weight-stationary serving: batch replicated, per-layer
            # activation reductions over both mesh axes; weights never move
            out["tp_allreduce"] = 0.0
            n_mix = sum(st.repeat * len(st.blocks) for st in cfg.stages())
            ar = (2 * (model - 1) / model + 2 * (dp - 1) / dp) \
                * B * 1 * d * BF16
            out["tp_allreduce"] = 2 * n_mix * ar
            if cfg.moe_experts:
                n_moe = sum(st.repeat for st in cfg.stages()
                            for blk in st.blocks if blk.ffn == MOE)
                out["moe_alltoall"] = 2 * n_moe * B * d * BF16 * max(cfg.moe_top_k, 1)
            out["total"] = sum(v for k2, v in out.items() if k2 != "total")
            return out
        S_new, passes = 1, 1
    b_local = max(1, B // dp)
    n_attn_layers = sum(st.repeat for st in cfg.stages() for blk in st.blocks
                        if blk.mixer in (ATTN, ATTN_GLOBAL, ATTN_LOCAL))
    n_mixer_layers = sum(st.repeat * len(st.blocks) for st in cfg.stages())
    # one AR after the mixer + one after the FFN per layer under TP
    ar = 2 * (model - 1) / model * b_local * S_new * d * BF16
    out["tp_allreduce"] = passes * 2 * n_mixer_layers * ar
    if cfg.moe_experts:
        n_moe = sum(st.repeat for st in cfg.stages() for blk in st.blocks
                    if blk.ffn == MOE)
        a2a_passes = passes
        if cell.kind == "train" and cfg.remat and cfg.remat_policy == "save_moe":
            a2a_passes = passes - 1      # no recompute all-to-alls
        tok_bytes = b_local * S_new * d * max(cfg.moe_top_k, 1)
        disp_b = 1 if cfg.moe_a2a_dtype else BF16   # fp8 dispatch wire
        out["moe_alltoall"] = a2a_passes * n_moe * tok_bytes * (disp_b + BF16)
    out["loss_allreduce"] = (b_local * S_new * 4 * 2) if cell.kind == "train" else 0.0
    out["total"] = sum(out.values())
    return out
