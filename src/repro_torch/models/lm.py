"""Generic decoder-only LM: the serving path (prefill and decode) of the
dense-attention families.  The layer pattern comes from ``cfg.stages()``;
parameters are stacked over each stage's repeat count, as in the reference,
and a Python loop over the ``[R, ...]`` slices takes the place of its
``lax.scan``.

Entry points:
  prefill(cfg, params, batch)                   — (last-token logits, cache)
  decode_step(cfg, params, cache, tokens, pos)  — one token, cache updated in place

Mixers other than (non-MLA) attention, MoE feed-forwards and the
sliding-window ring cache raise ``NotImplementedError``: they wait for
ROADMAP Queue 1, "The rest of the architecture zoo"; so does ``loss_fn``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (ATTN, ATTN_GLOBAL, ATTN_LOCAL, MAMBA, MLP,
                                      MLSTM, MOE, NONE, SLSTM, ArchConfig)
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.params import P

_WAITS = "waits for ROADMAP Queue 1, \"The rest of the architecture zoo\""
_ATTN_KINDS = (ATTN, ATTN_GLOBAL, ATTN_LOCAL)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it {_WAITS}")


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


def _layer(tree, r: int):
    """Layer ``r`` of a stage's stacked ``[R, ...]`` tree (views, no copies)."""
    return {k: _layer(v, r) for k, v in tree.items()} if isinstance(tree, dict) else tree[r]


def _window(kind: str, cfg: ArchConfig) -> int:
    """The mixer's attention window, 0 for full (the reference's rule)."""
    if kind == ATTN_LOCAL or cfg.attn_kind == "swa":
        return cfg.window
    return 0


def _check_attention(kind: str, cfg: ArchConfig) -> None:
    if kind not in _ATTN_KINDS:
        raise _not_ported(f"the {kind!r} mixer")
    if cfg.mla:
        raise _not_ported("MLA attention")


# --------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------- #
def _apply_ffn(kind: str, x, p, cfg: ArchConfig):
    if kind == MLP:
        return L.mlp(x, p)
    if kind == MOE:
        raise _not_ported("the MoE feed-forward")
    if kind != NONE:
        raise ValueError(kind)
    return x


def forward_hidden(cfg: ArchConfig, params, x, positions):
    for si, stage in enumerate(cfg.stages()):
        sp = params[f"stage{si}"]
        for r in range(stage.repeat):
            layer_p = _layer(sp, r)
            for bi, blk in enumerate(stage.blocks):
                bp = layer_p[f"b{bi}"]
                _check_attention(blk.mixer, cfg)
                x = L.attention(x, bp["mixer"], cfg, positions, window=_window(blk.mixer, cfg))
                x = _apply_ffn(blk.ffn, x, bp.get("ffn"), cfg)
    return L.rms_norm(x, params["final_ln"])


def embed_tokens(cfg, params, tokens):
    return params["embed"][tokens] * (cfg.d_model ** 0.5)


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


def _decode_mixer(kind: str, x, p, cfg, cache, pos: int):
    _check_attention(kind, cfg)
    w = _window(kind, cfg)
    if w and cache["k"].shape[1] <= w:
        raise _not_ported("the sliding-window ring cache")
    return L.attention_decode(x, p, cfg, cache, pos, window=w)


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """tokens: ``[B, 1]``; pos: the current position.  Returns
    ``(logits [B, V], cache)``: ``cache`` is updated **in place** (the
    reference returns a new one), so a cache that one step has consumed is
    not the cache it was before."""
    x = embed_tokens(cfg, params, tokens)
    for si, stage in enumerate(cfg.stages()):
        sp, cs = params[f"stage{si}"], cache[f"stage{si}"]
        for r in range(stage.repeat):
            layer_p, layer_c = _layer(sp, r), _layer(cs, r)
            for bi, blk in enumerate(stage.blocks):
                x, _ = _decode_mixer(blk.mixer, x, layer_p[f"b{bi}"]["mixer"], cfg,
                                     layer_c[f"b{bi}"], pos)
                x = _apply_ffn(blk.ffn, x, layer_p[f"b{bi}"].get("ffn"), cfg)
    h = L.rms_norm(x, params["final_ln"])
    logits = torch.einsum("bsd,dv->bsv", h, unembed_matrix(cfg, params))[:, 0]
    return logits, cache


def _prefill_mixer(kind: str, x, p, cfg, positions):
    """The mixer over the full sequence and its decode cache.  k and v are
    computed once, for the attention and the cache (the reference computes
    them twice, to the same numbers)."""
    _check_attention(kind, cfg)
    w = _window(kind, cfg)
    if w and w < x.shape[1]:
        raise _not_ported("the sliding-window ring cache")
    q, k, v = L.project_qkv(x, p, cfg, positions)
    return L.attend(x, q, k, v, p, w), {"k": k, "v": v}


def prefill(cfg: ArchConfig, params, batch):
    """Full-context forward returning (last-token logits, populated cache)."""
    x, positions, _ = assemble_input(cfg, params, batch)
    cache = {}
    for si, stage in enumerate(cfg.stages()):
        sp = params[f"stage{si}"]
        per_layer = []
        for r in range(stage.repeat):
            layer_p = _layer(sp, r)
            caches = {}
            for bi, blk in enumerate(stage.blocks):
                bp = layer_p[f"b{bi}"]
                x, caches[f"b{bi}"] = _prefill_mixer(blk.mixer, x, bp["mixer"], cfg, positions)
                x = _apply_ffn(blk.ffn, x, bp.get("ffn"), cfg)
            per_layer.append(caches)
        cache[f"stage{si}"] = {
            b: {n: torch.stack([c[b][n] for c in per_layer]) for n in per_layer[0][b]}
            for b in per_layer[0]}
    h = L.rms_norm(x, params["final_ln"])
    logits = torch.einsum("bd,dv->bv", h[:, -1], unembed_matrix(cfg, params))
    return logits, cache
