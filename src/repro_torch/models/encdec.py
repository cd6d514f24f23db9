"""Encoder-decoder (Whisper-style).  The conv1d audio stem is a stub, as in
the reference: the caller supplies precomputed frame embeddings at d_model
(``batch["prefix_embeds"]``).  Encoder: bidirectional self-attention through
the flash-attention kernel, then the MLP, with learned positions.  Decoder:
causal self-attention through the kernel, cross-attention to the encoder
states (plain PyTorch: query and key lengths differ) and the MLP.

Entry points:
  loss_fn(cfg, params, batch)                   — decoder xent (seq-chunked)
  encode(cfg, params, frames)                   — encoder states
  prefill(cfg, params, batch)                   — (last-token logits, cache)
  decode_step(cfg, params, cache, tokens, pos)  — one token, self cache in place

The cache is {"self": the decoder's k/v ``[L, B, S, Hk, hd]``, "cross": the
encoder states' k/v per layer ``[L, B, S_enc, H, hd]``}.  Unlike the
reference's, :func:`prefill` returns the decoder prompt's self-attention
k/v too (the reference's holds only "cross", so its decode after a
multi-token prompt attends to zeros): ROADMAP Queue 3.  ``cfg.remat``
checkpoints each encoder and decoder layer where a gradient is wanted, as
the reference's ``jax.checkpoint`` does.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.lm import chunked_xent, layer, remat_call, stack_layers
from repro_torch.models.params import P
from repro_torch.parallel.act_sharding import block_input


def _xattn_specs(cfg, R):
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {
        "ln": P((R, d), ("layers", "embed"), "ones"),
        "wq": P((R, d, H, hd), ("layers", "embed", "heads", "head")),
        "wk": P((R, d, H, hd), ("layers", "embed", "heads", "head")),
        "wv": P((R, d, H, hd), ("layers", "embed", "heads", "head")),
        "wo": P((R, H, hd, d), ("layers", "heads", "head", "embed")),
    }


def encdec_specs(cfg: ArchConfig) -> dict:
    d, V, Le = cfg.d_model, cfg.vocab, cfg.n_layers
    return {
        "embed": P((V, d), ("vocab", "embed")),
        "dec_pos": P((4096, d), (None, "embed"), scale=0.02),
        "enc_pos": P((4096, d), (None, "embed"), scale=0.02),
        "enc": {"attn": L.attn_specs(cfg, Le), "mlp": L.mlp_specs(cfg, Le)},
        "enc_ln": P((d,), ("embed",), "ones"),
        "dec": {"self": L.attn_specs(cfg, cfg.n_layers),
                "cross": _xattn_specs(cfg, cfg.n_layers),
                "mlp": L.mlp_specs(cfg, cfg.n_layers)},
        "final_ln": P((d,), ("embed",), "ones"),
        "unembed": P((d, V), ("embed", "vocab")),
    }


def _pos_add(x, table):
    idx = torch.arange(x.shape[1], device=x.device) % table.shape[0]
    return x + table[idx]


def _positions(x):
    B, T, _ = x.shape
    return torch.arange(T, device=x.device).expand(B, T)


def _encoder_layer(cfg, lp, x, positions):
    x = L.attention(block_input(x), lp["attn"], cfg, positions, window=0, causal=False)
    return L.mlp(block_input(x), lp["mlp"])


def encode(cfg: ArchConfig, params, frames):
    """frames: ``[B, S_enc, d]`` (the stub frontend's output)."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    x = _pos_add(frames.to(dtype), params["enc_pos"])
    positions = _positions(x)
    for r in range(cfg.n_layers):
        x = remat_call(cfg, _encoder_layer, cfg, layer(params["enc"], r), x, positions)
    return L.rms_norm(block_input(x), params["enc_ln"])


def _embed(cfg, params, tokens):
    return L.embed(params["embed"], tokens) * (cfg.d_model ** 0.5)


def _decoder_layer(cfg, lp, x, positions, enc_out):
    x = block_input(x)
    q, k, v = L.project_qkv(x, lp["self"], cfg, positions)
    x = L.attend(x, q, k, v, lp["self"], window=0)
    x = L.attention(block_input(x), lp["cross"], cfg, positions, window=0, causal=False,
                    kv_x=block_input(enc_out))
    return L.mlp(block_input(x), lp["mlp"]), k, v


def _decoder(cfg, params, tokens, enc_out):
    """(final hidden states ``[B, T, d]``, the self-attention k and v of
    every layer, stacked)."""
    x = _pos_add(_embed(cfg, params, tokens), params["dec_pos"])
    positions = _positions(x)
    self_kv = []
    for r in range(cfg.n_layers):
        x, k, v = remat_call(cfg, _decoder_layer, cfg, layer(params["dec"], r), x, positions,
                             enc_out)
        self_kv.append({"k": k, "v": v})
    return L.rms_norm(block_input(x), params["final_ln"]), stack_layers(self_kv)


def loss_fn(cfg: ArchConfig, params, batch):
    """The decoder's next-token cross-entropy over ``labels`` ``[B, S]``,
    given the frames (``prefix_embeds``) and the decoder tokens."""
    enc_out = encode(cfg, params, batch["prefix_embeds"])
    h, _ = _decoder(cfg, params, batch["tokens"], enc_out)
    return chunked_xent(h, batch["labels"], params["unembed"], cfg.loss_chunk, tail=False)


# ------------------------------------------------------------------ #
# decode: self-attn KV cache + precomputed cross KV
# ------------------------------------------------------------------ #
def cache_specs(cfg: ArchConfig, B: int, S: int, S_enc: int, dtype):
    Ld = cfg.n_layers
    H, hd = cfg.n_heads, cfg.hd
    Hk = cfg.n_kv
    return {
        "self": {"k": ((Ld, B, S, Hk, hd), dtype), "v": ((Ld, B, S, Hk, hd), dtype)},
        "cross": {"k": ((Ld, B, S_enc, H, hd), dtype),
                  "v": ((Ld, B, S_enc, H, hd), dtype)},
    }


def cache_axes(cfg: ArchConfig):
    """Logical axes of the cache tree (mirrors :func:`cache_specs`)."""
    a = ("layers", "act_batch", "cache_seq", "kv", "head")
    ax = ("layers", "act_batch", "cache_seq", "heads", "head")
    return {"self": {"k": a, "v": a}, "cross": {"k": ax, "v": ax}}


def cross_kv(cfg, params, enc_out):
    """Every decoder layer's cross-attention k and v of the encoder states."""
    ks, vs = [], []
    for r in range(cfg.n_layers):
        cp = layer(params["dec"]["cross"], r)
        h = L.rms_norm(block_input(enc_out), cp["ln"])
        ks.append(L.heads_proj("btd,dhk->bthk", h, cp["wk"]))
        vs.append(L.heads_proj("btd,dhk->bthk", h, cp["wv"]))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def prefill(cfg: ArchConfig, params, batch):
    """Encode the frames, precompute the cross-attention k/v, run the
    decoder prompt: (last-token logits, {"self": the prompt's k/v,
    "cross": ...})."""
    enc_out = encode(cfg, params, batch["prefix_embeds"])
    h, self_kv = _decoder(cfg, params, batch["tokens"], enc_out)
    logits = torch.einsum("bd,dv->bv", h[:, -1], params["unembed"])
    return logits, {"self": self_kv, "cross": cross_kv(cfg, params, enc_out)}


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """tokens ``[B, 1]`` at position ``pos``: (logits ``[B, V]``, cache),
    the self cache written at ``pos`` in place."""
    x = _embed(cfg, params, tokens)
    x = x + params["dec_pos"][pos % params["dec_pos"].shape[0]]
    for r in range(cfg.n_layers):
        lp = layer(params["dec"], r)
        x, _ = L.attention_decode(block_input(x), lp["self"], cfg, layer(cache["self"], r),
                                  pos, window=0)
        cp = lp["cross"]
        q = L.heads_proj("bsd,dhk->bshk", L.rms_norm(block_input(x), cp["ln"]), cp["wq"])
        o = L.cross_attend(q, cache["cross"]["k"][r], cache["cross"]["v"][r])
        x = x + L.heads_out("bshk,hkd->bsd", o, cp["wo"])
        x = L.mlp(block_input(x), lp["mlp"])
    h = L.rms_norm(block_input(x), params["final_ln"])
    return torch.einsum("bsd,dv->bsv", h, params["unembed"])[:, 0], cache
