"""Recurrent mixers (Mamba, mLSTM, sLSTM): parameter specs only.  The
parameter count needs them; the mixers themselves wait for their slice of
the port (ROADMAP Queue 1, "The rest of the architecture zoo")."""
from __future__ import annotations

from repro_torch.models.params import P

DT_RANK_DIV = 16


def mamba_specs(cfg, R: int) -> dict:
    d = cfg.d_model
    di = cfg.expand * d
    ds = cfg.d_state
    dtr = max(1, d // DT_RANK_DIV)
    k = cfg.conv_kernel
    return {
        "ln": P((R, d), ("layers", "embed"), "ones"),
        "in_proj": P((R, d, 2 * di), ("layers", "embed", "mlp")),
        "conv_w": P((R, di, k), ("layers", "mlp", None)),
        "conv_b": P((R, di), ("layers", "mlp"), "zeros"),
        "x_proj": P((R, di, dtr + 2 * ds), ("layers", "mlp", None)),
        "dt_proj": P((R, dtr, di), ("layers", None, "mlp")),
        "dt_bias": P((R, di), ("layers", "mlp"), "zeros"),
        "a_log": P((R, di, ds), ("layers", "mlp", None), "ones"),
        "d_skip": P((R, di), ("layers", "mlp"), "ones"),
        "out_proj": P((R, di, d), ("layers", "mlp", "embed")),
    }


def mlstm_specs(cfg, R: int) -> dict:
    d = cfg.d_model
    di = cfg.expand * d
    H = cfg.n_heads
    return {
        "ln": P((R, d), ("layers", "embed"), "ones"),
        "up": P((R, d, 2 * di), ("layers", "embed", "mlp")),
        "wq": P((R, di, di), ("layers", "mlp", None)),
        "wk": P((R, di, di), ("layers", "mlp", None)),
        "wv": P((R, di, di), ("layers", "mlp", None)),
        "w_i": P((R, di, H), ("layers", "mlp", "heads")),
        "w_f": P((R, di, H), ("layers", "mlp", "heads")),
        "gn": P((R, di), ("layers", "mlp"), "ones"),
        "down": P((R, di, d), ("layers", "mlp", "embed")),
    }


def slstm_specs(cfg, R: int) -> dict:
    d = cfg.d_model
    di = cfg.expand * d
    H = cfg.n_heads
    hd = di // H
    return {
        "ln": P((R, d), ("layers", "embed"), "ones"),
        "w_in": P((R, d, 4 * di), ("layers", "embed", "mlp")),
        "r": P((R, H, hd, 4 * hd), ("layers", "heads", None, None), scale=0.5),
        "gn": P((R, di), ("layers", "mlp"), "ones"),
        "down": P((R, di, d), ("layers", "mlp", "embed")),
    }
