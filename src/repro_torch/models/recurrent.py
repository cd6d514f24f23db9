"""The xLSTM recurrences as operators: ``repro_torch::mlstm_scan`` and
``repro_torch::slstm_scan`` each run one layer's recurrence over a whole
sequence as one op.

A step of each recurrence is one function, :func:`mlstm_step` and
:func:`slstm_step`: the decode forms of :mod:`repro_torch.models.ssm` call
it for one token, and the operators' real implementations loop it over the
sequence on the tensors' own device, so there is one copy of the
arithmetic.  Under ``FakeTensorMode`` an operator is one op whatever the
sequence's length (its fake implementation gives the shapes), which is what
lets the dry-run trace a 32k-token recurrent prefill; on DTensors it runs
on each rank's shard by its sharding rule.  The recurrence is independent
across batch rows and across heads, so shards of the batch pass through,
and so do shards of the mLSTM's heads where they divide the mesh; anything
else is made whole first.  The sLSTM's gates hold ``(4, H, hd)`` in their
last dim, a strided head layout, so its rule takes batch shards only.

``slstm_scan``'s gradient is a second operator,
``repro_torch::slstm_scan_backward``: backpropagation through time by hand
(the forward again, keeping the carry before each step, then the steps in
reverse), which the dry-run also traces as one op.  ``mlstm_scan`` has no
gradient: training takes the mLSTM's parallel form
(:func:`repro_torch.models.ssm.mlstm`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.parallel.act_sharding import pointwise, splittable


# --------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------- #
def mlstm_step(q, k, v, ig, fg, C, n, m):
    """One token of the mLSTM's recurrent form (xLSTM Eq. 19-27): q, k, v
    ``[B, H, hd]``, the gate pre-activations ig, fg ``[B, H]`` float32 and
    the state C ``[B, H, hd, hd]``, n ``[B, H, hd]``, m ``[B, H]`` float32.
    Returns the normalised output ``[B, H, hd]`` float32 and the new
    ``(C, n, m)``."""
    logf = pointwise(F.logsigmoid, fg)
    m_new = torch.maximum(logf + m, ig)
    fdec = torch.exp(logf + m - m_new)[..., None]
    iexp = torch.exp(ig - m_new)[..., None]
    C = C * fdec[..., None] + iexp[..., None] * (k[..., :, None] * v[..., None, :])
    n = n * fdec + iexp * k
    qf = q.float()
    num = torch.einsum("bhk,bhkv->bhv", qf, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n).abs(), torch.exp(-m_new))
    return num / den[..., None], (C, n, m_new)


@torch.library.custom_op("repro_torch::mlstm_scan", mutates_args=())
def mlstm_scan(q: Tensor, k: Tensor, v: Tensor, ig: Tensor, fg: Tensor, C: Tensor, n: Tensor,
               m: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """:func:`mlstm_step` over the sequence: q, k, v ``[B, S, H, hd]``, ig,
    fg ``[B, S, H]`` float32, from the state (C, n, m).  Returns every
    step's output ``[B, S, H, hd]`` float32 and the final state."""
    hs = []
    for t in range(q.shape[1]):
        h, (C, n, m) = mlstm_step(q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t], C, n, m)
        hs.append(h)
    return torch.stack(hs, 1), C, n, m


@mlstm_scan.register_fake
def _(q, k, v, ig, fg, C, n, m):
    return (q.new_empty(q.shape, dtype=torch.float32), torch.empty_like(C), torch.empty_like(n),
            torch.empty_like(m))


# --------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------- #
def _gate_heads(gates_t, H: int, hd: int):
    """``[B, 4·H·hd]`` laid out (4, H, hd) as ``[B, H, 4·hd]``."""
    B = gates_t.shape[0]
    return splittable(gates_t, 1, 4).reshape(B, 4, H, hd).transpose(1, 2).reshape(B, H, 4 * hd)


def slstm_step(r, carry, gates_t):
    """One token of the sLSTM: carry (c, n, h, m) each ``[B, H, hd]``
    float32; gates_t ``[B, 4·H·hd]`` before the recurrent term, laid out
    (4, H, hd); r ``[H, hd, 4·hd]``.  Returns the new carry and h."""
    H, hd = r.shape[0], r.shape[1]
    c, n, h, m = carry
    rec = torch.einsum("bhk,hkg->bhg", h.to(gates_t.dtype), r)          # [B, H, 4hd]
    g = _gate_heads(gates_t, H, hd) + rec
    zi, it, fi, oi = g.float().chunk(4, dim=-1)      # it: the input gate, in log space
    ft = pointwise(F.logsigmoid, fi)
    m_new = torch.maximum(ft + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + m - m_new)
    c2 = f_ * c + i_ * torch.tanh(zi)
    n2 = torch.maximum(f_ * n + i_, torch.exp(-m_new))
    h2 = torch.sigmoid(oi) * (c2 / n2)
    return (c2, n2, h2, m_new), h2


def _max_weight(a, b):
    """d max(a, b) / da: 1 where a > b, 1/2 at a tie (as torch's and
    JAX's ``maximum`` split it), 0 below."""
    return (a > b).float() + 0.5 * (a == b).float()


def _slstm_step_backward(r, carry, gates_t, dc2, dn2, dh2, dm2):
    """The gradient of :func:`slstm_step` from the gradients of its new
    carry (``dh2`` with the step's output's folded in): the gates' ``[B,
    4·H·hd]`` (in their dtype), r's (float32) and the previous carry's."""
    B = gates_t.shape[0]
    H, hd = r.shape[0], r.shape[1]
    c, n, h, m = carry
    hb = h.to(gates_t.dtype)
    g = _gate_heads(gates_t, H, hd) + torch.einsum("bhk,hkg->bhg", hb, r)
    zi, it, fi, oi = g.float().chunk(4, dim=-1)
    ft = F.logsigmoid(fi)
    a = ft + m
    m_new = torch.maximum(a, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(a - m_new)
    zt = torch.tanh(zi)
    c2 = f_ * c + i_ * zt
    nn = f_ * n + i_
    e = torch.exp(-m_new)
    n2 = torch.maximum(nn, e)
    o = torch.sigmoid(oi)
    # h2 = o * c2 / n2
    do = dh2 * (c2 / n2)
    dq = dh2 * o
    dc2 = dc2 + dq / n2
    dn2 = dn2 - dq * ((c2 / n2) / n2)
    # n2 = max(nn, exp(-m_new))
    w = _max_weight(nn, e)
    dnn = dn2 * w
    dm = dm2 - dn2 * (1 - w) * e
    # c2 = f_ c + i_ zt, nn = f_ n + i_
    df = dc2 * c + dnn * n
    di = dc2 * zt + dnn
    dzi = dc2 * i_ * (1 - zt * zt)
    # f_ = exp(a - m_new), i_ = exp(it - m_new), m_new = max(a, it)
    da = df * f_
    dit = di * i_
    dm = dm - da - dit
    wa = _max_weight(a, it)
    da = da + dm * wa
    dit = dit + dm * (1 - wa)
    # a = logsigmoid(fi) + m
    dfi = da * torch.sigmoid(-fi)
    doi = do * (1 - o) * o
    dg = torch.cat([dzi, dit, dfi, doi], dim=-1).to(gates_t.dtype)      # [B, H, 4hd]
    d_gates = dg.reshape(B, H, 4, hd).transpose(1, 2).reshape(B, 4 * H * hd)
    d_h = torch.einsum("bhg,hkg->bhk", dg, r).float()
    d_r = torch.einsum("bhk,bhg->hkg", hb, dg).float()
    return d_gates, d_r, (dc2 * f_, dnn * f_, d_h, da)


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def slstm_scan(gates: Tensor, r: Tensor, c: Tensor, n: Tensor, h: Tensor,
               m: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """:func:`slstm_step` over the sequence: gates ``[B, S, 4·H·hd]``
    before the recurrent term, r ``[H, hd, 4·hd]``, from the carry (c, n,
    h, m).  Returns every step's h ``[B, S, H, hd]`` float32 and the final
    carry."""
    carry, hs = (c, n, h, m), []
    for t in range(gates.shape[1]):
        carry, h_t = slstm_step(r, carry, gates[:, t])
        hs.append(h_t)
    return (torch.stack(hs, 1), *carry)


@slstm_scan.register_fake
def _(gates, r, c, n, h, m):
    B, S = gates.shape[:2]
    return (c.new_empty((B, S, *c.shape[1:])), *(torch.empty_like(x) for x in (c, n, h, m)))


@torch.library.custom_op("repro_torch::slstm_scan_backward", mutates_args=())
def slstm_scan_backward(gates: Tensor, r: Tensor, c: Tensor, n: Tensor, h: Tensor, m: Tensor,
                        d_hs: Tensor, d_c: Tensor, d_n: Tensor, d_h: Tensor,
                        d_m: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The gradients of :func:`slstm_scan` with respect to gates, r and the
    start carry, from those of its outputs: the forward again, keeping the
    carry before each step, then :func:`_slstm_step_backward` from the last
    step to the first."""
    S = gates.shape[1]
    carries = [(c, n, h, m)]
    for t in range(S - 1):
        carries.append(slstm_step(r, carries[-1], gates[:, t])[0])
    d_gates = torch.empty_like(gates)
    d_r = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
    d = (d_c, d_n, d_h, d_m)
    for t in reversed(range(S)):
        d_gates[:, t], d_rt, d = _slstm_step_backward(r, carries[t], gates[:, t], d[0], d[1],
                                                      d[2] + d_hs[:, t], d[3])
        d_r += d_rt
    return (d_gates, d_r.to(r.dtype), *(x.contiguous() for x in d))


@slstm_scan_backward.register_fake
def _(gates, r, c, n, h, m, d_hs, d_c, d_n, d_h, d_m):
    return tuple(torch.empty_like(x) for x in (gates, r, c, n, h, m))


def _slstm_setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _slstm_backward(ctx, d_hs, d_c, d_n, d_h, d_m):
    return torch.ops.repro_torch.slstm_scan_backward(*ctx.saved_tensors, d_hs, d_c, d_n, d_h,
                                                     d_m)


slstm_scan.register_autograd(_slstm_backward, setup_context=_slstm_setup_context)


# --------------------------------------------------------------------- #
# DTensor sharding rules
# --------------------------------------------------------------------- #
def _register_sharding() -> None:
    """Each rule lists, for one mesh dim, the outputs' placements and then
    the inputs': all replicated, or every batched tensor sharded on its
    batch (dim 0) with r replicated and r's gradient a partial sum over the
    batch shards; ``mlstm_scan`` also on its heads, where they divide the
    whole mesh (so any mesh dims that shard them split whole heads)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    R, B = Replicate(), Shard(0)

    @register_sharding(torch.ops.repro_torch.mlstm_scan.default)
    def _(q, k, v, ig, fg, C, n, m):
        out = [([R] * 4, [R] * 8), ([B] * 4, [B] * 8)]
        if q.shape[2] % q.mesh.size() == 0:
            out.append(([Shard(2)] + [Shard(1)] * 3, [Shard(2)] * 5 + [Shard(1)] * 3))
        return out

    @register_sharding(torch.ops.repro_torch.slstm_scan.default)
    def _(gates, r, c, n, h, m):
        return [([R] * 5, [R] * 6), ([B] * 5, [B, R] + [B] * 4)]

    @register_sharding(torch.ops.repro_torch.slstm_scan_backward.default)
    def _(gates, r, c, n, h, m, d_hs, d_c, d_n, d_h, d_m):
        return [([R] * 6, [R] * 11), ([B, Partial()] + [B] * 4, [B, R] + [B] * 9)]


_register_sharding()
