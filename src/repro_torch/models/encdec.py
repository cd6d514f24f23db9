"""Encoder-decoder (Whisper-style): parameter specs only.  The parameter
count needs them; the encoder, the decoder and their caches wait for their
slice of the port (ROADMAP Queue 1, "The rest of the
architecture zoo")."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.params import P


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
