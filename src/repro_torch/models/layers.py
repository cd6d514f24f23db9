"""Core layers: RMSNorm, RoPE, GQA attention (causal, optional sliding
window; full-sequence and single-token-decode forms) and the SwiGLU MLP.

Full-sequence attention goes through the hand-written flash-attention
kernel (:func:`repro_torch.kernels.flash_attention.flash_attention`) where
the reference calls its ``_sdpa``.  The two round differently in bf16, by
design: ``_sdpa`` rounds the logits and the probabilities to bf16, the
kernel keeps both in float32.  The plain projections are ``torch.einsum``,
as the reference leaves them to XLA.

MLA and MoE layers have their parameter specs here (the parameter count
needs them); their forward passes wait for their slice of the port
(ROADMAP Queue 1, "The rest of the architecture zoo").
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.params import P


# --------------------------------------------------------------------- #
# norms / rope
# --------------------------------------------------------------------- #
def rms_norm(x, scale, eps: float = 1e-6):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S]."""
    if not theta:
        return x
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs                      # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# attention (GQA, optional window)
# --------------------------------------------------------------------- #
def attn_specs(cfg, R: int) -> dict:
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    return {
        "ln": P((R, d), ("layers", "embed"), "ones"),
        "wq": P((R, d, H, hd), ("layers", "embed", "heads", "head")),
        "wk": P((R, d, Hk, hd), ("layers", "embed", "kv", "head")),
        "wv": P((R, d, Hk, hd), ("layers", "embed", "kv", "head")),
        "wo": P((R, H, hd, d), ("layers", "heads", "head", "embed")),
    }


def project_qkv(x, p, cfg, positions):
    """Normed input projected to rotated q ``[B, S, H, hd]``, rotated k and
    v ``[B, S, Hk, hd]``: k and v are also what the decode cache holds."""
    h = rms_norm(x, p["ln"])
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("btd,dhk->bthk", h, p["wk"])
    v = torch.einsum("btd,dhk->bthk", h, p["wv"])
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def attend(x, q, k, v, p, window: int):
    """Causal attention of the projected q, k, v through the kernel, the
    output projection and the residual.  Query i sees keys ``j <= i`` (and
    ``j > i - window`` for a window > 0): positions are 0..S-1, as
    :func:`repro_torch.models.lm.assemble_input` makes them.  Head h reads
    KV head ``h // (H // Hk)``, the reference's ``[B, S, Hk, G, hd]``
    grouping.  A causal row always has a valid key, so the kernel's 0 for
    a fully masked row (``_sdpa`` gives the mean of v there) never shows."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=True, window=window or None)
    return x + torch.einsum("bhsk,hkd->bsd", o, p["wo"])


def attention(x, p, cfg, positions, window: int):
    """Full-sequence causal self-attention; ``window`` 0 means full."""
    q, k, v = project_qkv(x, p, cfg, positions)
    return attend(x, q, k, v, p, window)


def attention_decode(x, p, cfg, cache, pos: int, window: int):
    """Single-token decode: x ``[B, 1, d]``; cache ``{'k', 'v'}``
    ``[B, T, Hk, hd]``.  Writes the new token's k and v into ``cache`` at
    ``pos`` **in place** (the reference returns a new cache) and returns
    ``(x_out, cache)``; raises where the reference's
    ``dynamic_update_slice`` would clamp ``pos`` into the cache."""
    B = x.shape[0]
    H, Hk, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    G = H // Hk
    T = cache["k"].shape[1]
    if not 0 <= pos < T:
        raise IndexError(f"decode position {pos} outside the cache's {T} positions")
    h = rms_norm(x, p["ln"])
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k_new = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v_new = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    posv = torch.full((B, 1), pos, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k_new = rope(k_new, posv, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    k[:, pos] = k_new[:, 0].to(k.dtype)
    v[:, pos] = v_new[:, 0].to(v.dtype)
    qg = q.reshape(B, 1, Hk, G, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * hd ** -0.5
    kp = torch.arange(T, device=x.device)
    mask = kp <= pos
    if window:
        mask &= kp > pos - window
    logits = torch.where(mask, logits, -1e30)
    pr = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", pr, v).reshape(B, 1, H, hd)
    return x + torch.einsum("bshk,hkd->bsd", o, p["wo"]), cache


# --------------------------------------------------------------------- #
# MLA (DeepSeek-V3): specs only
# --------------------------------------------------------------------- #
def mla_specs(cfg, R: int) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    qh = cfg.nope_dim + cfg.rope_dim
    return {
        "ln": P((R, d), ("layers", "embed"), "ones"),
        "wq_a": P((R, d, cfg.q_lora), ("layers", "embed", None)),
        "q_ln": P((R, cfg.q_lora), ("layers", None), "ones"),
        "wq_b": P((R, cfg.q_lora, H, qh), ("layers", None, "heads", "head")),
        "wkv_a": P((R, d, cfg.kv_lora + cfg.rope_dim), ("layers", "embed", None)),
        "kv_ln": P((R, cfg.kv_lora), ("layers", None), "ones"),
        "wkv_b": P((R, cfg.kv_lora, H, cfg.nope_dim + cfg.v_head_dim),
                   ("layers", None, "heads", "head")),
        "wo": P((R, H, cfg.v_head_dim, d), ("layers", "heads", "head", "embed")),
    }


# --------------------------------------------------------------------- #
# FFN: SwiGLU / GELU MLP; MoE specs only
# --------------------------------------------------------------------- #
def mlp_specs(cfg, R: int, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    out = {
        "ln": P((R, d), ("layers", "embed"), "ones"),
        "wi": P((R, d, f), ("layers", "embed", "mlp")),
        "wo": P((R, f, d), ("layers", "mlp", "embed")),
    }
    if cfg.mlp_kind == "swiglu":
        out["wg"] = P((R, d, f), ("layers", "embed", "mlp"))
    return out


def mlp(x, p):
    h = rms_norm(x, p["ln"])
    up = torch.einsum("bsd,df->bsf", h, p["wi"])
    if "wg" in p:
        act = F.silu(torch.einsum("bsd,df->bsf", h, p["wg"])) * up
    else:
        act = F.gelu(up, approximate="tanh")       # jax.nn.gelu's default
    return x + torch.einsum("bsf,fd->bsd", act, p["wo"])


def moe_specs(cfg, R: int) -> dict:
    d, E, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff or cfg.d_ff
    out = {
        "ln": P((R, d), ("layers", "embed"), "ones"),
        "router": P((R, d, E), ("layers", "embed", None)),
        "wi": P((R, E, d, f), ("layers", "expert", "embed", "expert_mlp")),
        "wg": P((R, E, d, f), ("layers", "expert", "embed", "expert_mlp")),
        "wo": P((R, E, f, d), ("layers", "expert", "expert_mlp", "embed")),
    }
    if cfg.moe_shared:
        out["shared"] = mlp_specs(cfg, R, d_ff=(cfg.moe_d_ff or cfg.d_ff) * cfg.moe_shared)
    return out
