"""One model on two devices: a registered architecture's reduced config in
float32, served on the card and on the CPU from the same weights, held
norm-wise.  ``chip_smoke.py``'s zoo phase and the card tests call
:func:`card_vs_cpu`; the helpers (:func:`tame`, :func:`flatten`,
:func:`normwise`, :func:`to_device`) serve the CPU parity tests too."""
from __future__ import annotations

import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import grow_cache, prompt_positions, seeded_batch
from repro_torch.models.api import Model, build_model

NORMWISE = 1e-4          # max|card - cpu| <= NORMWISE * max|cpu|, every leaf
MOE_MAX_ABS = 0.25       # tests/test_archs.py:186, the logits of MoE models besides


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
