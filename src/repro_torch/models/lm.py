"""Generic decoder-only LM covering the dense / moe / ssm / hybrid / vlm
families: the training loss and the serving path (prefill and decode).  The
layer pattern comes from ``cfg.stages()``; parameters are stacked over each
stage's repeat count, as in the reference, and a Python loop over the
``[R, ...]`` slices takes the place of its ``lax.scan``.

Entry points:
  loss_fn(cfg, params, batch)                   — next-token xent (seq-chunked)
  forward_hidden(cfg, params, x, positions)     — the stack's final hidden states
  prefill(cfg, params, batch)                   — (last-token logits, cache)
  decode_step(cfg, params, cache, tokens, pos)  — one token, cache updated in place

Sliding-window layers whose cache is no longer than the window keep a ring
buffer: prefill lays a prompt longer than the window out in ring order
(slot j holds the last token t with ``t % w == j``) and decode wraps.
mLSTM and sLSTM prefill run their recurrence over the prompt as one
operator a layer (:mod:`repro_torch.models.recurrent`), to build the exact
recurrent state, as the reference's ``lax.scan`` of its decode step does.

``cfg.remat`` checkpoints each layer (:func:`remat_call`) where a gradient
is wanted, as the reference's ``jax.checkpoint`` around its scan body does;
``remat_policy="save_moe"`` keeps the MoE outputs through the recompute.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import (ATTN, ATTN_GLOBAL, ATTN_LOCAL, MAMBA, MLP,
                                      MLSTM, MOE, NONE, SLSTM, ArchConfig)
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.params import P
from repro_torch.parallel.act_sharding import block_input, constrain, replicate

_ATTN_KINDS = (ATTN, ATTN_GLOBAL, ATTN_LOCAL)


# --------------------------------------------------------------------- #
# specs
# --------------------------------------------------------------------- #
_MIXER_SPECS = {
    ATTN: L.attn_specs, ATTN_LOCAL: L.attn_specs, ATTN_GLOBAL: L.attn_specs,
    MAMBA: S.mamba_specs, MLSTM: S.mlstm_specs, SLSTM: S.slstm_specs,
}


def lm_specs(cfg: ArchConfig) -> dict:
    d, V = cfg.d_model, cfg.vocab
    specs: dict = {
        "embed": P((V, d), ("vocab", "embed")),
        "final_ln": P((d,), ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = P((d, V), ("embed", "vocab"))
    for si, stage in enumerate(cfg.stages()):
        st: dict = {}
        for bi, blk in enumerate(stage.blocks):
            mixer_fn = L.mla_specs if (cfg.mla and blk.mixer == ATTN) \
                else _MIXER_SPECS[blk.mixer]
            b = {"mixer": mixer_fn(cfg, stage.repeat)}
            if blk.ffn == MLP:
                b["ffn"] = L.mlp_specs(cfg, stage.repeat)
            elif blk.ffn == MOE:
                b["ffn"] = L.moe_specs(cfg, stage.repeat)
            st[f"b{bi}"] = b
        specs[f"stage{si}"] = st
    return specs


def layer(tree, r: int):
    """Layer ``r`` of a stacked ``[R, ...]`` tree (views, no copies)."""
    return {k: layer(v, r) for k, v in tree.items()} if isinstance(tree, dict) else tree[r]


def stack_layers(per_layer: list):
    """Per-layer trees stacked along a new leading layer axis."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in per_layer]) for k in first}
    return torch.stack(per_layer)


def _window(kind: str, cfg: ArchConfig) -> int:
    """The mixer's attention window, 0 for full (the reference's rule)."""
    if kind == ATTN_LOCAL or cfg.attn_kind == "swa":
        return cfg.window
    return 0


# --------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------- #
def _apply_mixer(kind: str, x, p, cfg: ArchConfig, positions):
    if cfg.mla and kind == ATTN:
        return L.mla_attention(x, p, cfg, positions)
    if kind in _ATTN_KINDS:
        return L.attention(x, p, cfg, positions, window=_window(kind, cfg))
    if kind == MAMBA:
        return S.mamba(x, p, cfg)
    if kind == MLSTM:
        return S.mlstm(x, p, cfg)
    if kind == SLSTM:
        return S.slstm(x, p, cfg)
    raise ValueError(kind)


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_requires_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def _apply_ffn(kind: str, x, p, cfg: ArchConfig):
    if kind == MLP:
        return L.mlp(x, p)
    if kind == MOE:
        y = L.moe(x, p, cfg)
        if cfg.remat and cfg.remat_policy == "save_moe" and y.requires_grad:
            y = L.moe_out(y)                 # the reference's checkpoint_name(y, "moe_out")
        return y
    if kind != NONE:
        raise ValueError(kind)
    return x


def _save_moe_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.repro_torch.moe_out.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(cfg: ArchConfig, fn, *args):
    """``fn(*args)``; under ``torch.utils.checkpoint`` when ``cfg.remat`` and
    a gradient is wanted (grad enabled, a tensor of ``args`` requiring it),
    so its activations are recomputed in the backward (the reference's
    ``jax.checkpoint``); serving runs ``fn`` as it is.
    ``remat_policy="save_moe"`` keeps what
    :func:`repro_torch.models.layers.moe_out` tagged (its
    ``save_only_these_names("moe_out")``)."""
    if not (cfg.remat and torch.is_grad_enabled() and _requires_grad(args)):
        return fn(*args)
    kw = {}
    if cfg.remat_policy == "save_moe":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_moe_policy)
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def _layer_forward(cfg: ArchConfig, blocks, layer_p, x, positions):
    """One layer, its input and output constrained to the installed
    activation sharding (:func:`repro_torch.parallel.act_sharding.constrain`,
    inside the remat boundary as in the reference).  Each mixer and FFN
    takes the residual stream laid out by
    :func:`~repro_torch.parallel.act_sharding.block_input` (its sequence
    gathered, as GSPMD gathers it where the reference's layer needs it)."""
    x = constrain(x)   # sequence-parallel activation checkpoints
    for bi, blk in enumerate(blocks):
        bp = layer_p[f"b{bi}"]
        x = _apply_mixer(blk.mixer, block_input(x), bp["mixer"], cfg, positions)
        x = _apply_ffn(blk.ffn, block_input(x), bp.get("ffn"), cfg)
    return constrain(x)


def forward_hidden(cfg: ArchConfig, params, x, positions):
    for si, stage in enumerate(cfg.stages()):
        sp = params[f"stage{si}"]
        for r in range(stage.repeat):
            x = remat_call(cfg, _layer_forward, cfg, stage.blocks, layer(sp, r), x, positions)
    return L.rms_norm(block_input(x), params["final_ln"])


def embed_tokens(cfg, params, tokens):
    return L.embed(params["embed"], tokens) * (cfg.d_model ** 0.5)


def unembed_matrix(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def assemble_input(cfg: ArchConfig, params, batch):
    """tokens (+ optional modality-prefix embeds) -> (x, positions,
    label_offset)."""
    x = embed_tokens(cfg, params, batch["tokens"])
    offset = 0
    if cfg.frontend and "prefix_embeds" in batch:
        pre = batch["prefix_embeds"].to(x.dtype)
        x = torch.cat([pre, x], dim=1)
        offset = pre.shape[1]
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device).expand(B, T)
    return x, positions, offset


def chunked_xent(h, labels, unemb, loss_chunk: int, tail: bool = True):
    """Next-token cross-entropy of hidden states ``h`` ``[B, S, d]`` against
    ``labels`` ``[B, S]``, summed over chunks of ``loss_chunk`` positions and
    (``tail``) the tail chunk, over ``B * S``: each chunk's logits in the
    parameters' dtype, then float32, as the reference's einsum and
    ``astype`` give them.  Chunks are summed in order from a float32 zero,
    as its ``lax.scan`` does.  The reference's encoder-decoder loss has no
    tail chunk (``src/repro/models/encdec.py:88``): its last ``S % C``
    positions count in the divisor only, and ``tail=False`` keeps that.
    On DTensors ``unemb``'s ``d`` is gathered once (FSDP's gather), so each
    chunk's logits keep ``h``'s batch shards and are no partial sums."""
    B, S = labels.shape
    unemb = replicate(unemb, (0,))
    C = min(loss_chunk, S)
    n = S // C
    bounds = [(i * C, (i + 1) * C) for i in range(n)]
    if tail and S > n * C:
        bounds.append((n * C, S))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for a, b in bounds:
        logits = torch.einsum("bcd,dv->bcv", h[:, a:b], unemb).float()
        gold = torch.gather(replicate(logits, (-1,)), -1, labels[:, a:b, None].long())[..., 0]
        tot = tot + torch.sum(torch.logsumexp(logits, dim=-1) - gold)
    return tot / (B * S)


def loss_fn(cfg: ArchConfig, params, batch):
    """Next-token cross-entropy (``batch``: ``tokens``, ``labels`` ``[B, S]``,
    and ``prefix_embeds`` for the vision stub, whose positions carry no
    label), sequence-chunked so the ``[B, S, V]`` logits are never one
    tensor."""
    x, positions, offset = assemble_input(cfg, params, batch)
    h = replicate(forward_hidden(cfg, params, x, positions), (1,))[:, offset:]
    labels = batch["labels"]
    return chunked_xent(h[:, :labels.shape[1]], labels, unembed_matrix(cfg, params),
                        cfg.loss_chunk)


# --------------------------------------------------------------------- #
# decode caches
# --------------------------------------------------------------------- #
def _mixer_cache_spec(kind: str, cfg: ArchConfig, R: int, B: int, S: int,
                      dtype) -> dict:
    H, Hk, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    di = cfg.expand * cfg.d_model
    if cfg.mla and kind == ATTN:
        return {"c_kv": ((R, B, S, cfg.kv_lora), dtype),
                "k_rope": ((R, B, S, cfg.rope_dim), dtype)}
    if kind in _ATTN_KINDS:
        w = _window(kind, cfg)
        T = min(S, w) if w else S
        return {"k": ((R, B, T, Hk, hd), dtype), "v": ((R, B, T, Hk, hd), dtype)}
    if kind == MAMBA:
        return {"h": ((R, B, di, cfg.d_state), torch.float32),
                "conv": ((R, B, cfg.conv_kernel - 1, di), dtype)}
    if kind == MLSTM:
        hdm = di // H
        return {"C": ((R, B, H, hdm, hdm), torch.float32),
                "n": ((R, B, H, hdm), torch.float32),
                "m": ((R, B, H), torch.float32)}
    if kind == SLSTM:
        hdm = di // H
        return {k: ((R, B, H, hdm), torch.float32) for k in ("c", "n", "h", "m")}
    raise ValueError(kind)


def cache_specs(cfg: ArchConfig, B: int, S: int, dtype):
    """Nested dict of ``(shape, dtype)`` pairs mirroring the cache."""
    out = {}
    for si, stage in enumerate(cfg.stages()):
        out[f"stage{si}"] = {
            f"b{bi}": _mixer_cache_spec(blk.mixer, cfg, stage.repeat, B, S, dtype)
            for bi, blk in enumerate(stage.blocks)}
    return out


def cache_axes(cfg: ArchConfig, ring: bool = False):
    """Logical axes of the cache tree (mirrors :func:`cache_specs`)."""
    def ax(kind):
        if cfg.mla and kind == ATTN:
            return {"c_kv": ("layers", "act_batch", "cache_seq", None),
                    "k_rope": ("layers", "act_batch", "cache_seq", None)}
        if kind in _ATTN_KINDS:
            a = ("layers", "act_batch", "cache_seq", "kv", "head")
            return {"k": a, "v": a}
        if kind == MAMBA:
            return {"h": ("layers", "act_batch", "mlp", None),
                    "conv": ("layers", "act_batch", None, "mlp")}
        if kind == MLSTM:
            return {"C": ("layers", "act_batch", "heads", None, None),
                    "n": ("layers", "act_batch", "heads", None),
                    "m": ("layers", "act_batch", "heads")}
        if kind == SLSTM:
            return {k: ("layers", "act_batch", "heads", None) for k in ("c", "n", "h", "m")}
        raise ValueError(kind)

    return {f"stage{si}": {f"b{bi}": ax(blk.mixer) for bi, blk in enumerate(stage.blocks)}
            for si, stage in enumerate(cfg.stages())}


def _decode_mixer(kind: str, x, p, cfg, cache, pos: int):
    if cfg.mla and kind == ATTN:
        return L.mla_decode(x, p, cfg, cache, pos)
    if kind in _ATTN_KINDS:
        w = _window(kind, cfg)
        if w and cache["k"].shape[1] <= w:   # ring buffer over the window
            return L.ring_decode(x, p, cfg, cache, pos, w)
        return L.attention_decode(x, p, cfg, cache, pos, window=w)
    if kind == MAMBA:
        return S.mamba_decode(x, p, cfg, cache, pos)
    if kind == MLSTM:
        return S.mlstm_decode(x, p, cfg, cache, pos)
    if kind == SLSTM:
        return S.slstm_decode(x, p, cfg, cache, pos)
    raise ValueError(kind)


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """tokens: ``[B, 1]``; pos: the current position.  Returns
    ``(logits [B, V], cache)``: ``cache`` is updated **in place** (the
    reference returns a new one), so a cache that one step has consumed is
    not the cache it was before."""
    x = embed_tokens(cfg, params, tokens)
    for si, stage in enumerate(cfg.stages()):
        sp, cs = params[f"stage{si}"], cache[f"stage{si}"]
        for r in range(stage.repeat):
            layer_p, layer_c = layer(sp, r), layer(cs, r)
            for bi, blk in enumerate(stage.blocks):
                x, _ = _decode_mixer(blk.mixer, block_input(x), layer_p[f"b{bi}"]["mixer"],
                                     cfg, layer_c[f"b{bi}"], pos)
                x = _apply_ffn(blk.ffn, block_input(x), layer_p[f"b{bi}"].get("ffn"), cfg)
    h = L.rms_norm(block_input(x), params["final_ln"])
    logits = torch.einsum("bsd,dv->bsv", h, unembed_matrix(cfg, params))[:, 0]
    return logits, cache


def ring_order(T: int, w: int, device) -> torch.Tensor:
    """Token index held by each of the w ring slots after a T-token prompt
    (T > w): slot j holds the last token t with ``t % w == j``."""
    return T - w + torch.remainder(torch.arange(w, device=device) - T, w)


def _prefill_mixer(kind: str, x, p, cfg, positions):
    """The mixer over the full sequence and its decode cache.  Attention's k
    and v are computed once, for the attention and the cache (the reference
    computes them twice, to the same numbers)."""
    if cfg.mla and kind == ATTN:
        qkv = L.mla_qkv(x, p, cfg, positions)
        return L.mla_attention(x, p, cfg, positions, qkv), {"c_kv": qkv[2], "k_rope": qkv[3]}
    if kind in _ATTN_KINDS:
        w = _window(kind, cfg)
        q, k, v = L.project_qkv(x, p, cfg, positions)
        out = L.attend(x, q, k, v, p, w)
        T = x.shape[1]
        if w and w < T:
            last = ring_order(T, w, x.device)
            k, v = k[:, last], v[:, last]
        return out, {"k": k, "v": v}
    if kind == MAMBA:
        return S.mamba_prefill(x, p, cfg)
    if kind == MLSTM:
        return S.mlstm_prefill(x, p, cfg)
    if kind == SLSTM:
        return S.slstm_prefill(x, p, cfg)
    raise ValueError(kind)


def prefill(cfg: ArchConfig, params, batch):
    """Full-context forward returning (last-token logits, populated cache)."""
    x, positions, _ = assemble_input(cfg, params, batch)
    cache = {}
    for si, stage in enumerate(cfg.stages()):
        sp = params[f"stage{si}"]
        per_layer = []
        for r in range(stage.repeat):
            layer_p = layer(sp, r)
            caches = {}
            for bi, blk in enumerate(stage.blocks):
                bp = layer_p[f"b{bi}"]
                x, caches[f"b{bi}"] = _prefill_mixer(blk.mixer, block_input(x), bp["mixer"],
                                                     cfg, positions)
                x = _apply_ffn(blk.ffn, block_input(x), bp.get("ffn"), cfg)
            per_layer.append(caches)
        cache[f"stage{si}"] = stack_layers(per_layer)
    h = L.rms_norm(block_input(x), params["final_ln"])
    logits = torch.einsum("bd,dv->bv", h[:, -1], unembed_matrix(cfg, params))
    return logits, cache
