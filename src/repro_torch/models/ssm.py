"""Recurrent mixers: Mamba (S6 selective scan), mLSTM and sLSTM (xLSTM).

Each mixer has a full-sequence (prefill) form and an O(1)-state decode
form.  Plain PyTorch, as the reference's are plain ``jnp``: no Pallas
kernel computes them.  Decode forms update the state tensors of their
cache **in place** and return ``(x_out, cache)``.

The Mamba scan keeps the reference's chunking (chunks of 256 where 256
divides S, one chunk for S <= 256, otherwise chunks of one step), so the
state composes at the same boundaries; within a chunk a log-step
(Hillis-Steele) scan takes the place of ``lax.associative_scan``: the two
differ in float32 by summation order only.  ``dA`` and ``dBx`` are made
one chunk at a time, so the ``[B, S, d_inner, d_state]`` tensors never
materialise.  The mLSTM's and sLSTM's recurrences run as the operators of
:mod:`repro_torch.models.recurrent`, one op a layer, where the reference
runs a ``lax.scan``; the mLSTM trains on its parallel form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm
from repro_torch.models.params import P
from repro_torch.models.recurrent import mlstm_scan, mlstm_step, slstm_scan, slstm_step
from repro_torch.parallel.act_sharding import (by_heads, merge_heads, replicated_like, settled,
                                               splittable)

DT_RANK_DIV = 16
M_INIT = -1e30          # the stabiliser's start: the first step's input gate wins


# --------------------------------------------------------------------- #
# Mamba (S6)
# --------------------------------------------------------------------- #
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


def _chunk_len(S: int) -> int:
    """The reference's chunk rule (``repro/models/ssm.py:80-83``)."""
    return 256 if S % 256 == 0 else (S if S <= 256 else 1)


def _linear_scan(a, b):
    """Inclusive scan of ``h_t = a_t * h_(t-1) + b_t`` along dim 1 from
    ``h = 0``, in log2(C) steps: (cumulative product of a, h)."""
    off, n = 1, a.shape[1]
    while off < n:
        b = torch.cat([b[:, :off], torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return a, b


def mamba_core(xz, p, cfg, h0=None, conv_state=None):
    """xz: ``[B, S, 2di]`` after ``in_proj``.  Returns (y ``[B, S, di]``,
    h_last ``[B, di, ds]`` float32, conv_last ``[B, k-1, di]``)."""
    B, S, _ = xz.shape
    di = cfg.expand * cfg.d_model
    ds, k = cfg.d_state, cfg.conv_kernel
    dtr = max(1, cfg.d_model // DT_RANK_DIV)
    x, z = xz[..., :di], xz[..., di:]

    # causal depthwise conv over time
    if conv_state is None:
        conv_state = x.new_zeros((B, k - 1, di))
    xpad = torch.cat([conv_state, x], dim=1)
    conv_last = xpad[:, S:] if k > 1 else x.new_zeros((B, 0, di))
    x = sum(xpad[:, i:i + S] * p["conv_w"][:, k - 1 - i] for i in range(k))
    x = F.silu(x + p["conv_b"])

    proj = torch.einsum("bsd,dp->bsp", x, p["x_proj"])
    dt = F.softplus(torch.einsum("bsr,rd->bsd", proj[..., :dtr], p["dt_proj"]) + p["dt_bias"])
    Bc, Cc = proj[..., dtr:dtr + ds], proj[..., dtr + ds:]
    A = -torch.exp(p["a_log"].float())                          # [di, ds]
    dtx = dt * x
    h = h0 if h0 is not None else torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    C = _chunk_len(S)
    ys = []
    for c0 in range(0, S, C):
        c = slice(c0, c0 + C)
        dA = torch.exp(dt[:, c, :, None] * A)                   # [B, C, di, ds] float32
        dBx = (dtx[:, c, :, None] * Bc[:, c, None, :]).float()
        acc_A, acc_h = _linear_scan(dA, dBx)
        hs = acc_A * h[:, None] + acc_h
        ys.append(torch.einsum("bcds,bcs->bcd", hs, Cc[:, c].float()))
        h = hs[:, -1]
    y = torch.cat(ys, 1).to(x.dtype) + x * p["d_skip"]
    return y * F.silu(z), h, conv_last


def _mamba_in(x, p):
    return torch.einsum("bsd,de->bse", rms_norm(x, p["ln"]), p["in_proj"])


def mamba(x, p, cfg):
    y, _, _ = mamba_core(_mamba_in(x, p), p, cfg)
    return x + torch.einsum("bse,ed->bsd", y, p["out_proj"])


def mamba_prefill(x, p, cfg):
    """:func:`mamba` and its decode state {h, conv}."""
    y, h_last, conv_last = mamba_core(_mamba_in(x, p), p, cfg)
    return x + torch.einsum("bse,ed->bsd", y, p["out_proj"]), {"h": h_last, "conv": conv_last}


def mamba_decode(x, p, cfg, cache, pos: int):
    """cache: {'h': ``[B, di, ds]`` float32, 'conv': ``[B, k-1, di]``}."""
    y, h_last, conv_last = mamba_core(_mamba_in(x, p), p, cfg, h0=cache["h"],
                                      conv_state=cache["conv"])
    cache["h"].copy_(h_last)
    cache["conv"].copy_(conv_last)
    return x + torch.einsum("bse,ed->bsd", y, p["out_proj"]), cache


# --------------------------------------------------------------------- #
# mLSTM (matrix memory, parallel + recurrent forms)
# --------------------------------------------------------------------- #
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


def mlstm_qkv(h, p, cfg):
    B, S, _ = h.shape
    di = cfg.expand * cfg.d_model
    H = cfg.n_heads
    hd = di // H
    up = settled(torch.einsum("bsd,de->bse", h, p["up"]))
    xin, z = up[..., :di], up[..., di:]
    q = splittable(torch.einsum("bse,ef->bsf", xin, p["wq"]), -1, H).reshape(B, S, H, hd)
    k = (splittable(torch.einsum("bse,ef->bsf", xin, p["wk"]), -1, H).reshape(B, S, H, hd)
         / (hd ** 0.5))
    v = splittable(torch.einsum("bse,ef->bsf", xin, p["wv"]), -1, H).reshape(B, S, H, hd)
    ig = torch.einsum("bse,eh->bsh", xin, p["w_i"]).float()
    fg = torch.einsum("bse,eh->bsh", xin, p["w_f"]).float()
    return q, k, v, ig, fg, z


def mlstm(x, p, cfg):
    """Parallel (quadratic) form: decay matrix from cumulative log forget
    gates, stabilised by its row max m (xLSTM Eq. 19-27), cast to the
    activation dtype before it weighs the scores, as in the reference."""
    q, k, v, ig, fg, z = mlstm_qkv(rms_norm(x, p["ln"]), p, cfg)
    hsa = by_heads(_mlstm_parallel, q, k, v, ig, fg)
    y = merge_heads(hsa) * p["gn"] * F.silu(z)
    return x + torch.einsum("bse,ed->bsd", y, p["down"])


def _mlstm_parallel(q, k, v, ig, fg):
    """:func:`mlstm`'s core: q, k, v ``[B, S, H, hd]``, ig, fg ``[B, S, H]``
    to the normalised ``[B, S, H, hd]``, in q's dtype."""
    S = q.shape[1]
    csum = torch.cumsum(F.logsigmoid(fg), dim=1)                            # [B, S, H]
    # D[s, t] = exp(csum[s] - csum[t] + i[t]) for t <= s
    dmat = csum[:, :, None, :] - csum[:, None, :, :] + ig[:, None, :, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(mask[None, :, :, None], dmat, -torch.inf)
    m = dmat.amax(dim=2, keepdim=True)                           # [B, S, 1, H]
    dexp = torch.exp(dmat - m).to(q.dtype)                       # [B, S, T, H]
    scores = torch.einsum("bshd,bthd->bsth", q, k) * dexp
    norm = torch.maximum(scores.sum(dim=2).abs(), torch.exp(-m[:, :, 0]).to(q.dtype))
    return torch.einsum("bsth,bthd->bshd", scores, v) / norm[..., None]


def mlstm_state(B: int, cfg, device):
    """The recurrent form's state before the first token."""
    H = cfg.n_heads
    hd = cfg.expand * cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((B, H, hd, hd), **f32), "n": torch.zeros((B, H, hd), **f32),
            "m": torch.full((B, H), M_INIT, **f32)}


def mlstm_prefill(x, p, cfg):
    """The recurrent form over the whole sequence (``mlstm_scan``), from
    :func:`mlstm_state`: the layer's output and its decode state {C, n, m}.
    The projections, the output gate and ``down`` run once over the
    sequence."""
    q, k, v, ig, fg, z = mlstm_qkv(rms_norm(x, p["ln"]), p, cfg)
    st = {name: replicated_like(t, x) for name, t in mlstm_state(x.shape[0], cfg,
                                                                  x.device).items()}
    hsa, C, n, m = mlstm_scan(q, k, v, ig, fg, st["C"], st["n"], st["m"])
    y = merge_heads(hsa).to(x.dtype) * p["gn"] * F.silu(z)
    return x + torch.einsum("bse,ed->bsd", y, p["down"]), {"C": C, "n": n, "m": m}


def mlstm_decode(x, p, cfg, cache, pos: int):
    """Recurrent form: cache {'C': ``[B,H,hd,hd]``, 'n': ``[B,H,hd]``, 'm':
    ``[B,H]``}, all float32: O(1) in context length."""
    B = x.shape[0]
    di = cfg.expand * cfg.d_model
    q, k, v, ig, fg, z = mlstm_qkv(rms_norm(x, p["ln"]), p, cfg)
    h, (C, n, m) = mlstm_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0],
                              cache["C"], cache["n"], cache["m"])
    hsa = h.reshape(B, 1, di).to(x.dtype) * p["gn"]
    y = hsa * F.silu(z)
    cache["C"].copy_(C)
    cache["n"].copy_(n)
    cache["m"].copy_(m)
    return x + torch.einsum("bse,ed->bsd", y, p["down"]), cache


# --------------------------------------------------------------------- #
# sLSTM (scalar memory, strictly recurrent)
# --------------------------------------------------------------------- #
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


SLSTM_STATE = ("c", "n", "h", "m")


def slstm_state(B: int, cfg, device):
    H = cfg.n_heads
    hd = cfg.expand * cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((B, H, hd), **f32), "n": torch.zeros((B, H, hd), **f32),
            "h": torch.zeros((B, H, hd), **f32), "m": torch.full((B, H, hd), M_INIT, **f32)}


def slstm_prefill(x, p, cfg):
    """The sLSTM over the whole sequence (``slstm_scan``, differentiable),
    from :func:`slstm_state`: the layer's output and its decode state {c, n,
    h, m}."""
    B = x.shape[0]
    gates = torch.einsum("bsd,dg->bsg", rms_norm(x, p["ln"]), p["w_in"])   # [B, S, 4di]
    st = [replicated_like(t, x) for t in slstm_state(B, cfg, x.device).values()]
    hs, *carry = slstm_scan(gates, p["r"], *st)
    y = merge_heads(hs).to(x.dtype) * p["gn"]
    return x + torch.einsum("bse,ed->bsd", y, p["down"]), dict(zip(SLSTM_STATE, carry))


def slstm(x, p, cfg):
    return slstm_prefill(x, p, cfg)[0]


def slstm_decode(x, p, cfg, cache, pos: int):
    """cache: {'c', 'n', 'h', 'm'}, each ``[B, H, hd]`` float32."""
    B = x.shape[0]
    di = cfg.expand * cfg.d_model
    gates = torch.einsum("bsd,dg->bsg", rms_norm(x, p["ln"]), p["w_in"])[:, 0]
    carry, h_out = slstm_step(p["r"], tuple(cache[n] for n in SLSTM_STATE), gates)
    for name, t in zip(SLSTM_STATE, carry):
        cache[name].copy_(t)
    y = h_out.reshape(B, 1, di).to(x.dtype) * p["gn"]
    return x + torch.einsum("bse,ed->bsd", y, p["down"]), cache
