"""Core layers: RMSNorm, RoPE, GQA attention (causal or bidirectional,
optional sliding window; full-sequence, cross-attention and
single-token-decode forms), MLA (DeepSeek latent attention with its
compressed decode cache), the SwiGLU / GELU MLP and top-k MoE with
capacity-based dispatch (sort-and-gather, or GShard's one-hot einsums).

Full-sequence self-attention goes through the hand-written flash-attention
kernel (:func:`repro_torch.kernels.flash_attention.flash_attention`) where
the reference calls its ``_sdpa``.  The two round differently in bf16, by
design: ``_sdpa`` rounds the logits and the probabilities to bf16, the
kernel keeps both in float32.  Cross-attention (query and key lengths
differ, which the kernel does not take), MLA (a q·k head dim of
``nope_dim + rope_dim`` beside a v head dim of ``v_head_dim``), decode and
MoE are plain PyTorch, as the reference computes them in plain ``jnp``.
The projections are ``torch.einsum``, as the reference leaves them to XLA.

Decode forms write the new token's state into the cache **in place** (the
reference returns a new cache) and return ``(x_out, cache)``.

Where the port departs from the reference on purpose (ROADMAP Queue 3):
``moe_einsum`` counts slot positions in integers (the reference's cumsum
runs in the activation dtype, so in bf16 it miscounts past 256 pairs an
expert); top-k breaks ties by the lower expert index, as ``lax.top_k``
does, on every device.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.params import P
from repro_torch.parallel.act_sharding import (block_input, by_heads, on_replicas, replicate,
                                               splittable, write_at)

FP8_E4M3_NAN_ABOVE = 464.0   # XLA rounds |x| > 464 to e4m3fn's NaN; torch saturates to 448


@torch.library.custom_op("repro_torch::moe_out", mutates_args=())
def moe_out(y: torch.Tensor) -> torch.Tensor:
    """A copy of an MoE layer's output, as an operator of its own: the
    selective-checkpoint policy of ``remat_policy="save_moe"``
    (:func:`repro_torch.models.lm.remat_call`) keeps what it returns, as
    the reference's ``checkpoint_name(y, "moe_out")`` names it."""
    return y.clone()


moe_out.register_fake(torch.empty_like)
moe_out.register_autograd(lambda ctx, grad: grad)


# --------------------------------------------------------------------- #
# norms / rope
# --------------------------------------------------------------------- #
def embed(table, tokens):
    """``table[tokens]``.  Where the table or the tokens are DTensors that
    shard anything, ``F.embedding`` of the table with its vocabulary
    gathered: DTensor shards that (its gradient by
    ``embedding_dense_backward``) where it cannot shard the gather's
    backward, an accumulating ``index_put``, and its masked vocabulary-
    parallel lookup fails beside batch-sharded tokens.  Replicated
    DTensors index as plain tensors do, to the same bits."""
    if any(isinstance(t, DTensor) and any(p.is_shard() for p in t.placements)
           for t in (table, tokens)):
        return F.embedding(tokens, replicate(table, (0,)))
    return table[tokens]


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm over the last dim."""
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


def _softmax_as(logits, dtype):
    return torch.softmax(logits, dim=-1).to(dtype)


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


class _HeadsProj(torch.autograd.Function):
    """The projection with ``w`` flattened to ``[d, H * k]`` on DTensors:
    the einsums the plain path's autograd runs, on one rank the same
    products; the output and the weight's gradient are unflattened to
    heads where DTensor can split them
    (:func:`~repro_torch.parallel.act_sharding.splittable`)."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        y = torch.einsum("...d,dn->...n", h, w.flatten(1))
        return splittable(y, -1, w.shape[1]).unflatten(-1, w.shape[1:])

    @staticmethod
    def backward(ctx, gy):
        h, w = ctx.saved_tensors
        gy = gy.flatten(-2)
        gh = torch.einsum("...n,dn->...d", gy, w.flatten(1))
        gw = torch.einsum("...d,...n->dn", h, gy)
        return gh, splittable(gw, -1, w.shape[1]).unflatten(-1, w.shape[1:])


class _HeadsOut(torch.autograd.Function):
    """``o`` ``[..., H, k]`` by ``w`` ``[H, k, d]`` with both flattened to
    ``H * k`` on DTensors; the gradients are unflattened to heads where
    DTensor can split them."""

    @staticmethod
    def forward(ctx, o, w):
        o = splittable(o, -2, o.shape[-2])
        ctx.save_for_backward(o, w)
        return torch.einsum("...n,nd->...d", o.flatten(-2), w.flatten(0, 1))

    @staticmethod
    def backward(ctx, gy):
        o, w = ctx.saved_tensors
        H = w.shape[0]
        go = torch.einsum("...d,nd->...n", gy, w.flatten(0, 1))
        gw = torch.einsum("...n,...d->nd", o.flatten(-2), gy)
        return (splittable(go, -1, H).unflatten(-1, w.shape[:2]),
                splittable(gw, 0, H).unflatten(0, w.shape[:2]))


def heads_out(eq: str, o, w):
    """``torch.einsum(eq, o, w)`` for an output projection of the heads of
    ``o`` by ``w`` ``[H, k, d]`` (``eq`` such as ``"bshk,hkd->bsd"``).  On
    DTensors ``o``'s two contracted dims are moved last and the product runs
    through :class:`_HeadsOut`, where DTensor's own einsum fails to split a
    gradient over heads that do not divide the mesh axis (whisper's 20)."""
    if not isinstance(o, DTensor):
        return torch.einsum(eq, o, w)
    left, right = eq.split("->")[0].split(",")
    o = o.movedim((left.index(right[0]), left.index(right[1])), (-2, -1))
    return _HeadsOut.apply(o, w)


def heads_proj(eq: str, h, w):
    """``torch.einsum(eq, h, w)`` for a projection of ``h`` ``[..., d]`` by
    ``w`` ``[d, H, k]`` to ``[..., H, k]``.  On DTensors it runs through
    :class:`_HeadsProj`, where DTensor's own einsum fails on heads that do
    not divide the mesh axis (granite's 8 KV heads on a 16-wide axis)."""
    if not isinstance(h, DTensor):
        return torch.einsum(eq, h, w)
    return _HeadsProj.apply(h, w)


def project_qkv(x, p, cfg, positions):
    """Normed input projected to rotated q ``[B, S, H, hd]``, rotated k and
    v ``[B, S, Hk, hd]``: k and v are also what the decode cache holds."""
    h = rms_norm(x, p["ln"])
    q = heads_proj("bsd,dhk->bshk", h, p["wq"])
    k = heads_proj("btd,dhk->bthk", h, p["wk"])
    v = heads_proj("btd,dhk->bthk", h, p["wv"])
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def attend(x, q, k, v, p, window: int, causal: bool = True):
    """Self-attention of the projected q, k, v through the kernel, the
    output projection and the residual.  Causal: query i sees keys
    ``j <= i`` (and ``j > i - window`` for a window > 0); positions are
    0..S-1, as :func:`repro_torch.models.lm.assemble_input` makes them.
    Bidirectional (``causal=False``, the Whisper encoder, no window): every
    key.  Head h reads KV head ``h // (H // Hk)``, the reference's
    ``[B, S, Hk, G, hd]`` grouping.  Every row has a valid key, so the
    kernel's 0 for a fully masked row (``_sdpa`` gives the mean of v there)
    never shows."""
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=causal, window=window or None)
    return x + heads_out("bhsk,hkd->bsd", o, p["wo"])


def cross_attend(q, k, v):
    """Unmasked attention of q ``[B, S, H, hd]`` over k, v ``[B, T, H, hd]``
    (T != S allowed): the reference's ``_sdpa`` with ``kv_x`` given, and its
    encoder-decoder decode step's cross-attention.  Logits in the input
    dtype, then float32; probabilities back in the input dtype."""
    logits = torch.einsum("bshk,bthk->bhst", q, k).float() * q.shape[-1] ** -0.5
    return torch.einsum("bhst,bthk->bshk", _softmax_as(logits, q.dtype), v)


def attention(x, p, cfg, positions, window: int, causal: bool = True, kv_x=None):
    """Full-sequence attention; ``window`` 0 means full.  With ``kv_x`` (the
    Whisper decoder's encoder states) it is cross-attention: keys and values
    from ``rms_norm(kv_x)``, no rotation, no mask, plain PyTorch."""
    if kv_x is None:
        q, k, v = project_qkv(x, p, cfg, positions)
        return attend(x, q, k, v, p, window, causal)
    h = rms_norm(x, p["ln"])
    src = rms_norm(kv_x, p["ln"])
    q = heads_proj("bsd,dhk->bshk", h, p["wq"])
    k = heads_proj("btd,dhk->bthk", src, p["wk"])
    v = heads_proj("btd,dhk->bthk", src, p["wv"])
    return x + heads_out("bshk,hkd->bsd", by_heads(cross_attend, q, k, v), p["wo"])


def _check_pos(pos: int, T: int) -> None:
    if not 0 <= pos < T:
        raise IndexError(f"decode position {pos} outside the cache's {T} positions")


def _decode_qkv(x, p, cfg, pos: int):
    B = x.shape[0]
    h = rms_norm(x, p["ln"])
    q = heads_proj("bsd,dhk->bshk", h, p["wq"])
    k_new = heads_proj("bsd,dhk->bshk", h, p["wk"])
    v_new = heads_proj("bsd,dhk->bshk", h, p["wv"])
    posv = torch.full((B, 1), pos, device=x.device)
    return rope(q, posv, cfg.rope_theta), rope(k_new, posv, cfg.rope_theta), v_new


def _decode_core(qg, k, v, valid, dtype):
    """Grouped queries ``[B, 1, Hk, G, hd]`` over the cache ``[B, T, Hk,
    hd]``, keys where ``valid`` ``[T]``: ``[B, 1, Hk, G, hd]``."""
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * qg.shape[-1] ** -0.5
    logits = torch.where(valid, logits, -1e30)
    return torch.einsum("bkgst,btkd->bskgd", _softmax_as(logits, dtype), v)


def _decode_core_per_shard(qg, k, v, valid, dtype):
    """:func:`_decode_core` on DTensors whose cache keeps its sequence
    whole: every (batch, KV head) is independent, so each rank computes its
    own shards, q placed as the cache is (no collective; DTensor's einsum
    would flatten a batch and a head that are both sharded)."""
    mesh, places = k.device_mesh, k.placements      # batch on dim 0, KV heads on dim 2 of both
    o = _decode_core(*(t.redistribute(mesh, places).to_local() for t in (qg, k, v)), valid,
                     dtype)
    B, S, Hk, G, D = qg.shape
    return DTensor.from_local(o, mesh, places, run_check=False, shape=qg.shape,
                              stride=(S * Hk * G * D, Hk * G * D, G * D, D, 1))


def _decode_attend(x, q, k, v, p, cfg, valid):
    """One query per row over a ``[B, T, Hk, hd]`` cache, keys where
    ``valid`` ``[T]``; the output projection and the residual."""
    B = x.shape[0]
    H, Hk, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    qg = splittable(q, 2, Hk).reshape(B, 1, Hk, H // Hk, hd)
    core = (_decode_core_per_shard if isinstance(k, DTensor)
            and not any(pl.is_shard(1) for pl in k.placements) else _decode_core)
    o = core(qg, k, v, valid, x.dtype).reshape(B, 1, H, hd)
    return x + heads_out("bshk,hkd->bsd", o, p["wo"])


def attention_decode(x, p, cfg, cache, pos: int, window: int):
    """Single-token decode: x ``[B, 1, d]``; cache ``{'k', 'v'}``
    ``[B, T, Hk, hd]`` with token t at slot t.  Raises where the
    reference's ``dynamic_update_slice`` would clamp ``pos`` into the
    cache."""
    k, v = cache["k"], cache["v"]
    T = k.shape[1]
    _check_pos(pos, T)
    q, k_new, v_new = _decode_qkv(x, p, cfg, pos)
    write_at(k, pos, k_new[:, 0].to(k.dtype))
    write_at(v, pos, v_new[:, 0].to(v.dtype))
    kp = torch.arange(T, device=x.device)
    valid = kp <= pos
    if window:
        valid &= kp > pos - window
    return _decode_attend(x, q, k, v, p, cfg, valid), cache


def ring_decode(x, p, cfg, cache, pos: int, window: int):
    """Sliding-window decode over a ring-buffer cache of ``tbuf`` slots:
    slot j holds the most recent token t with ``t % tbuf == j``; validity
    enforces the window (the reference's ``lm._decode_ring``)."""
    k, v = cache["k"], cache["v"]
    tbuf = k.shape[1]
    if pos < 0:
        raise IndexError(f"decode position {pos} is negative")
    q, k_new, v_new = _decode_qkv(x, p, cfg, pos)
    write_at(k, pos % tbuf, k_new[:, 0].to(k.dtype))
    write_at(v, pos % tbuf, v_new[:, 0].to(v.dtype))
    slots = torch.arange(tbuf, device=x.device)
    slot_pos = pos - torch.remainder(pos - slots, tbuf)    # the token each slot holds
    valid = (slot_pos >= 0) & (slot_pos > pos - window) & (slot_pos <= pos)
    return _decode_attend(x, q, k, v, p, cfg, valid), cache


# --------------------------------------------------------------------- #
# MLA (DeepSeek-V3) — latent compressed attention, plain PyTorch
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


def mla_qkv(x, p, cfg, positions):
    """(q_nope ``[B,S,H,nope]``, q_rope ``[B,S,H,rope]``, c_kv
    ``[B,S,kv_lora]``, k_rope ``[B,S,rope]``): the last two are what the
    compressed cache holds (the rotary key is shared by all heads)."""
    h = rms_norm(x, p["ln"])
    # the low-rank projections' norms take their input as a block does
    q = rms_norm(block_input(torch.einsum("bsd,dq->bsq", h, p["wq_a"])), p["q_ln"])
    q = torch.einsum("bsq,qhk->bshk", q, p["wq_b"])
    q_nope, q_rope = q[..., :cfg.nope_dim], rope(q[..., cfg.nope_dim:], positions, cfg.rope_theta)
    kv = torch.einsum("bsd,dc->bsc", h, p["wkv_a"])
    c_kv = rms_norm(block_input(kv[..., :cfg.kv_lora]), p["kv_ln"])
    k_rope = rope(kv[..., None, cfg.kv_lora:], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_attend(x, p, cfg, q_nope, q_rope, c_kv, k_rope, valid, per_shard: bool):
    """Attention of the queries over a compressed cache, keys where
    ``valid`` (``[S, T]`` or ``[T]``).  ``per_shard`` (prefill and
    training, whose keys are the queries' own whole sequence): the core runs
    on each rank's batch and head shards (:func:`by_heads`); in decode
    DTensor places it, so a cache sharded along its sequence stays so."""
    kv = torch.einsum("btc,chk->bthk", c_kv, p["wkv_b"])
    core = functools.partial(_mla_core, cfg.nope_dim, x.dtype, valid)
    o = (by_heads(core, q_nope, q_rope, kv, k_rope, shared=(3,)) if per_shard
         else core(q_nope, q_rope, kv, k_rope))
    return x + heads_out("bshk,hkd->bsd", o, p["wo"])


def _mla_core(nope_dim: int, dtype, valid, q_nope, q_rope, kv, k_rope):
    k_nope, v = kv[..., :nope_dim], kv[..., nope_dim:]
    logits = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
              + torch.einsum("bshk,btk->bhst", q_rope, k_rope))
    logits = logits.float() * (nope_dim + q_rope.shape[-1]) ** -0.5
    logits = torch.where(valid, logits, -1e30)
    return torch.einsum("bhst,bthk->bshk", _softmax_as(logits, dtype), v)


def mla_attention(x, p, cfg, positions, qkv=None):
    """Causal MLA over the sequence; ``qkv`` is :func:`mla_qkv`'s result
    when the caller already has it (prefill keeps c_kv and k_rope)."""
    q_nope, q_rope, c_kv, k_rope = qkv if qkv is not None else mla_qkv(x, p, cfg, positions)
    pos = positions[0]
    return _mla_attend(x, p, cfg, q_nope, q_rope, c_kv, k_rope, pos[None, :] <= pos[:, None],
                       per_shard=True)


def mla_decode(x, p, cfg, cache, pos: int):
    """Decode with the *compressed* cache {c_kv: ``[B,T,kv_lora]``,
    k_rope: ``[B,T,rope_dim]``}, written at ``pos`` in place."""
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    T = c_kv.shape[1]
    _check_pos(pos, T)
    posv = torch.full((x.shape[0], 1), pos, device=x.device)
    q_nope, q_rope, c_new, kr_new = mla_qkv(x, p, cfg, posv)
    write_at(c_kv, pos, c_new[:, 0].to(c_kv.dtype))
    write_at(k_rope, pos, kr_new[:, 0].to(k_rope.dtype))
    valid = torch.arange(T, device=x.device) <= pos
    return _mla_attend(x, p, cfg, q_nope, q_rope, c_kv, k_rope, valid, per_shard=False), cache


# --------------------------------------------------------------------- #
# FFN: SwiGLU / GELU MLP and MoE
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


def _mlp_delta(x, p):
    h = rms_norm(x, p["ln"])
    up = torch.einsum("bsd,df->bsf", h, p["wi"])
    if "wg" in p:
        act = F.silu(torch.einsum("bsd,df->bsf", h, p["wg"])) * up
    else:
        act = F.gelu(up, approximate="tanh")       # jax.nn.gelu's default
    return torch.einsum("bsf,fd->bsd", act, p["wo"])


def mlp(x, p):
    return x + _mlp_delta(x, p)


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


def moe_capacity(cfg, T: int) -> int:
    """Slots per expert for T tokens: 1 for a decode step of a few tokens,
    so a token whose expert is taken is dropped there, as in the reference."""
    return max(1, int(cfg.capacity_factor * T * cfg.moe_top_k / cfg.moe_experts))


def moe_route(h, p, cfg):
    """Router softmax in float32 and its top k: (gates ``[T, k]``,
    renormalised, in h's dtype; expert ids ``[T, k]``).  A stable
    descending sort takes the lower index first among equal gates, as
    ``lax.top_k`` does (``torch.topk`` promises no order there)."""
    gates = torch.softmax(torch.einsum("td,de->te", h, p["router"]).float(), dim=-1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :cfg.moe_top_k], topi[:, :cfg.moe_top_k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    return topv.to(h.dtype), topi


def fp8_wire(x, dtype_name: str):
    """``x`` through the quantised dispatch wire and back to its dtype, as
    XLA converts: non-finite where XLA gives NaN (|x| > 464 and non-finite
    inputs; torch would saturate those to ±448), equal elsewhere."""
    q = x.to(getattr(torch, dtype_name)).to(x.dtype)
    return torch.where(x.abs() > FP8_E4M3_NAN_ABOVE, torch.nan, q)   # NaN > 464 is False: kept


def _experts(xe, p):
    """SwiGLU of every expert over its ``[E, cap, d]`` slots."""
    he = (F.silu(torch.einsum("ecd,edf->ecf", xe, p["wg"]))
          * torch.einsum("ecd,edf->ecf", xe, p["wi"]))
    return torch.einsum("ecf,efd->ecd", he, p["wo"])


def moe_slots(topi, E: int, cap: int):
    """Sort-based dispatch plan for the ``T * k`` (token, expert) pairs in
    top-k order: (order, the stable sort of the pairs by expert; slot of
    each sorted pair in ``[E * cap]``, ``E * cap`` (the dummy row) where
    the expert is full; keep, the pairs that got a slot)."""
    e_pair = topi.reshape(-1)
    order = torch.argsort(e_pair, stable=True)
    e_s = e_pair[order]
    first = torch.searchsorted(e_s, e_s, side="left")
    pos = torch.arange(e_s.numel(), device=e_s.device) - first    # slot within the expert
    keep = pos < cap
    return order, torch.where(keep, e_s * cap + pos, E * cap), keep


def _dispatch(h, order, slot, k: int, E: int, cap: int, wire: str | None):
    """Each kept (token, expert) pair's input in its expert's slot: ``[E, cap, d]``."""
    send = h[order // k]
    if wire:
        send = fp8_wire(send, wire)
    xe = torch.zeros((E * cap + 1, h.shape[1]), dtype=h.dtype, device=h.device)
    xe[slot] = send                      # dropped pairs all land on the dummy row
    return xe[:E * cap].reshape(E, cap, h.shape[1])


def _combine(ye, topv, order, slot, keep, T: int, k: int):
    """Each token's k expert outputs ``ye`` ``[E, cap, d]``, weighted by
    its gates and summed in ascending expert order: ``[T, d]``."""
    ye = ye.reshape(-1, ye.shape[-1])
    ye = torch.cat([ye, ye.new_zeros((1, ye.shape[1]))])
    contrib = ye[slot] * (topv.reshape(-1)[order] * keep)[:, None]
    # sorted position of each token's pairs, ascending = ascending expert id
    where = torch.empty_like(order)
    where[order] = torch.arange(order.numel(), device=ye.device)
    parts = contrib[where.view(T, k).sort(dim=-1).values]          # [T, k, d]
    y = parts[:, 0]
    for i in range(1, k):
        y = y + parts[:, i]
    return y


def moe_gather(x, p, cfg):
    """Top-k MoE with sort-based dispatch: the pairs are gathered into
    per-expert buffers of ``cap`` slots and their outputs gathered back.
    Each token's k contributions are summed in ascending expert order (the
    order of the reference's ``.at[tok_s].add`` updates), one add at a time
    in x's dtype: no atomics, so every run gives the same bits.  On
    DTensors the plan, the dispatch and the combine run on whole
    (replicated) tensors, a global plan as in the reference; the experts
    run sharded as their weights are."""
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    cap = moe_capacity(cfg, T)
    h = rms_norm(x, p["ln"]).reshape(T, d)
    topv, topi = moe_route(h, p, cfg)
    order, slot, keep = on_replicas(lambda t: moe_slots(t, E, cap), topi)
    xe = on_replicas(lambda *a: _dispatch(*a, k, E, cap, cfg.moe_a2a_dtype), h, order, slot)
    ye = _experts(xe, p)
    y = on_replicas(lambda *a: _combine(*a, T, k), ye, topv, order, slot, keep).reshape(B, S, d)
    if cfg.moe_shared:
        y = y + _mlp_delta(x, p["shared"])
    return x + y


def moe_einsum(x, p, cfg):
    """GShard-style dense one-hot dispatch.  Slot positions are counted in
    integers, so a full expert drops exactly the pairs ``moe_gather``
    drops in any dtype."""
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    cap = moe_capacity(cfg, T)
    h = rms_norm(x, p["ln"]).reshape(T, d)
    topv, topi = moe_route(h, p, cfg)
    onehot_i = F.one_hot(topi, E)                                    # [T, k, E]
    pos = ((onehot_i.reshape(T * k, E).cumsum(0) - 1).reshape(T, k, E) * onehot_i).sum(-1)
    slot = (pos[..., None] == torch.arange(cap, device=x.device)).to(x.dtype)  # [T, k, cap]
    onehot = onehot_i.to(x.dtype)
    disp = torch.einsum("tke,tkc->tec", onehot, slot)
    ye = _experts(torch.einsum("td,tec->ecd", h, disp), p)
    comb = torch.einsum("tke,tkc,tk->tec", onehot, slot, topv)
    y = torch.einsum("ecd,tec->td", ye, comb).reshape(B, S, d)
    if cfg.moe_shared:
        y = y + _mlp_delta(x, p["shared"])
    return x + y


def moe(x, p, cfg):
    if cfg.moe_dispatch == "gather":
        return moe_gather(x, p, cfg)
    return moe_einsum(x, p, cfg)
