"""One model on two devices: a registered architecture's reduced config in
float32, served (:func:`card_vs_cpu`) or differentiated
(:func:`grads_card_vs_cpu`) on the card and on the CPU from the same
weights, held norm-wise.  ``chip_smoke.py``'s zoo and train phases and the
card tests call them; the helpers (:func:`tame`, :func:`tame_grads`,
:func:`flatten`, :func:`normwise`, :func:`to_device`) serve the CPU parity
tests too."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_backward
from repro_torch.launch.serve import grow_cache, prompt_positions, seeded_batch
from repro_torch.models.api import Model, build_model

NORMWISE = 1e-4          # max|card - cpu| <= NORMWISE * max|cpu|, every leaf
MOE_MAX_ABS = 0.25       # tests/test_archs.py:186, the logits of MoE models besides
MLSTM_Q_SCALE = 0.1      # tame_grads: mLSTM queries small enough for a well-posed normaliser


def tame(tree):
    """A copy of ``tree`` (tensors or numpy arrays) with ``wq`` and ``wk``
    of every attention layer (``[R, d, H, hd]``) scaled to a fan-in of
    d_model instead of H: the reference's initialiser makes a deep stack
    chaotic (``tests/test_torch_zoo_models.py`` says why)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: tame(v) for k, v in tree.items()}
    for w in ("wq", "wk"):
        a = out.get(w)
        if a is not None and a.ndim == 4:
            out[w] = a * ((a.shape[2] / a.shape[1]) ** 0.5)
    return out


def tame_grads(tree):
    """:func:`tame`, and every mLSTM query projection (``wq`` ``[R, di,
    di]``) scaled by :data:`MLSTM_Q_SCALE`.  At the reference's initialiser
    an mLSTM's normaliser ``max(|sum of scores|, exp(-m))`` takes the
    scores' sum, which can come near 0, and a 12-layer stack's float32
    gradients land about 1.3e-4 (norm-wise) from float64 in both packages
    alike (``tests/test_torch_train_loss.py`` pins that).  Smaller queries
    let ``exp(-m)`` bound the normaliser, and float32 gradients come
    within 1e-5 of float64; gradient parity runs on these weights."""
    out = tame(tree)
    if not isinstance(out, dict):
        return out

    def walk(node):
        if not isinstance(node, dict):
            return node
        node = {k: walk(v) for k, v in node.items()}
        if "w_f" in node and node.get("wq") is not None and node["wq"].ndim == 3:
            node["wq"] = node["wq"] * MLSTM_Q_SCALE        # an mLSTM mixer
        return node
    return walk(out)


def flatten(tree, prefix: str = "") -> dict:
    """``{"/stage0/b0/k": leaf, ...}`` in sorted key order."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in flatten(tree[key], f"{prefix}/{key}").items()}
    return {prefix: tree}


def normwise(a, b) -> dict:
    """Largest absolute error of ``a`` against ``b``, and it over ``b``'s
    largest entry."""
    d = float((torch.as_tensor(a).float().cpu() - torch.as_tensor(b).float().cpu()).abs().max())
    return dict(max_abs_err=d,
                normwise_err=d / max(float(torch.as_tensor(b).float().abs().max()), 1e-30))


def to_device(tree, device):
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def attention_layers(model: Model) -> int:
    """Self-attention layers, each one ``flash_attention`` launch a
    prefill: the encoder's and the decoder's of the encoder-decoder, none
    of MLA (its q-k and v head dims differ)."""
    cfg = model.cfg
    if model.is_encdec:
        return 2 * cfg.n_layers
    if cfg.mla:
        return 0
    return sum(st.repeat * sum(b.mixer.startswith("attn") for b in st.blocks)
               for st in cfg.stages())


def _leaf_errs(what: str, cache, want_cache) -> dict:
    got = flatten(cache)
    return {f"{what}{k}": normwise(got[k], v) for k, v in flatten(want_cache).items()}


def card_vs_cpu(name: str, device="cuda", B: int = 2, prompt: int = 80, seed: int = 3) -> dict:
    """Architecture ``name``'s reduced config in float32 with TF32 off,
    weights drawn on the CPU from ``seed`` (tamed) and copied to
    ``device``: prefill logits and every cache leaf, then one decode step's
    logits and every cache leaf, on ``device`` against the CPU.

    Every leaf is held at :data:`NORMWISE`; the logits of MoE models must
    also keep their argmax and stay within :data:`MOE_MAX_ABS` (the
    reference's continuation bar).  ``flash_attention`` must launch once a
    self-attention layer in prefill and never in decode.  Returns the
    errors, the launches and ``ok`` with the failures that unset it."""
    m = build_model(ARCHS[name].reduced())
    cfg = m.cfg
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_params = tame(m.init(seed, device="cpu"))
        params = to_device(cpu_params, device)
        batch = seeded_batch(cfg, B, prompt, "cpu")
        n0 = flash_attention.launches
        logits, cache = m.prefill(params, to_device(batch, device))
        n1 = flash_attention.launches
        want, want_cache = m.prefill(cpu_params, batch)
        P = prompt_positions(m, batch)
        cache, want_cache = (grow_cache(m, c, B, P + 8) for c in (cache, want_cache))
        errs = {"prefill": normwise(logits, want), **_leaf_errs("prefill", cache, want_cache)}
        tok = want.argmax(-1)[:, None]
        n2 = flash_attention.launches
        step, cache = m.decode_step(params, cache, tok.to(device), P)
        n3 = flash_attention.launches
        want_step, want_cache = m.decode_step(cpu_params, want_cache, tok, P)
        errs["decode"] = normwise(step, want_step)
        errs.update(_leaf_errs("decode", cache, want_cache))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    launches = {"prefill": n1 - n0, "decode": n3 - n2}
    failures = [f"{k}: {e}" for k, e in errs.items() if not e["normwise_err"] <= NORMWISE]
    if cfg.moe_experts:
        for what, a, b in (("prefill", logits, want), ("decode", step, want_step)):
            if not torch.equal(a.cpu().argmax(-1), b.argmax(-1)):
                failures.append(f"{what}: argmax differs")
            if not errs[what]["max_abs_err"] < MOE_MAX_ABS:
                failures.append(f"{what}: max abs {errs[what]['max_abs_err']}")
    want_launches = {"prefill": attention_layers(m) if torch.device(device).type == "cuda"
                     else 0, "decode": 0}
    if launches != want_launches:
        failures.append(f"flash_attention launches {launches}, expected {want_launches}")
    worst = max(errs, key=lambda k: errs[k]["normwise_err"])
    return dict(ok=not failures, failures=failures, errors=errs, leaves=len(errs),
                worst=worst, **errs[worst], launches=launches,
                bar=f"norm-wise {NORMWISE}" + (f"; argmax, max abs {MOE_MAX_ABS}"
                                               if cfg.moe_experts else ""))


def train_batch(cfg: ArchConfig, B: int, S: int, seed: int, device="cpu") -> dict:
    """A training batch laid out as the reference's ``smoke_batch``
    (``tests/test_archs.py:22``): S decoder tokens and labels beside S
    audio frames, or ``cfg.n_patches`` vision patches before ``S -
    n_patches`` tokens; drawn on the CPU from ``seed``, then moved."""
    gen = torch.Generator().manual_seed(seed)
    tok = lambda s: torch.randint(0, cfg.vocab, (B, s), generator=gen)  # noqa: E731
    emb = lambda n: torch.randn((B, n, cfg.d_model), generator=gen)  # noqa: E731
    if cfg.enc_dec:
        batch = {"prefix_embeds": emb(S), "tokens": tok(S), "labels": tok(S)}
    elif cfg.frontend == "vision_patches":
        batch = {"prefix_embeds": emb(cfg.n_patches), "tokens": tok(S - cfg.n_patches),
                 "labels": tok(S - cfg.n_patches)}
    else:
        batch = {"tokens": tok(S), "labels": tok(S)}
    return to_device(batch, device)


def grads_card_vs_cpu(arch: str | ArchConfig, device="cuda", B: int = 2, S: int = 64,
                      seed: int = 3) -> dict:
    """The loss and the gradient of every parameter leaf of ``arch`` (a
    registered name: its reduced config; or a config, which must be
    float32) on ``device`` against the CPU, TF32 off, on weights drawn on
    the CPU from ``seed`` (:func:`tame_grads`) and copied over.  Every leaf
    is held at :data:`NORMWISE`.  On the card, ``flash_attention`` must
    launch once a self-attention layer (twice under remat) and its backward
    once.  Returns the errors, the launches and ``ok`` with the failures."""
    from repro_torch.train.train_loop import value_and_grad
    m = build_model(ARCHS[arch].reduced() if isinstance(arch, str) else arch)
    cfg = m.cfg
    if cfg.param_dtype != "float32":
        raise ValueError(f"{cfg.name}: card against CPU runs in float32, not {cfg.param_dtype}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_params = tame_grads(m.init(seed, device="cpu"))
        params = to_device(cpu_params, device)
        batch = train_batch(cfg, B, S, seed)
        n0 = flash_attention.launches, flash_attention_backward.launches
        loss, grads = value_and_grad(m, params, to_device(batch, device))
        n1 = flash_attention.launches, flash_attention_backward.launches
        want_loss, want = value_and_grad(m, cpu_params, batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    errs = {"loss": normwise(loss, want_loss),
            **{f"grad{k}": normwise(g, flatten(want)[k]) for k, g in flatten(grads).items()}}
    failures = [f"{k}: {e}" for k, e in errs.items() if not e["normwise_err"] <= NORMWISE]
    launches = {"forward": n1[0] - n0[0], "backward": n1[1] - n0[1]}
    layers = attention_layers(m) if torch.device(device).type == "cuda" else 0
    want_launches = {"forward": layers * (2 if cfg.remat else 1), "backward": layers}
    if launches != want_launches:
        failures.append(f"flash_attention launches {launches}, expected {want_launches}")
    worst = max(errs, key=lambda k: errs[k]["normwise_err"])
    return dict(ok=not failures, failures=failures, errors=errs, leaves=len(errs),
                worst=worst, **errs[worst], launches=launches, loss=float(loss),
                bar=f"norm-wise {NORMWISE}")
