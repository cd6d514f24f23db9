"""Serving entry point: batched prefill, then greedy decode with the KV cache.

    python -m repro_torch.launch.serve --arch granite-3-2b
    python -m repro_torch.launch.serve --arch granite-3-2b --reduced --device cpu

Runs the full config on the CUDA card unless the caller passes
``--reduced`` (the same-family smoke config) or ``--device cpu``.  The
prompt is filled by one ``Model.prefill`` (full-sequence attention through
the flash-attention kernel) and its cache is grown to decode capacity;
then each new token is one ``Model.decode_step``.  Weights are drawn from
seed 0 and the prompt from seed 1, as in the reference's ``launch/serve.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import get
from repro_torch.device import device_name, resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.api import Model, build_model

EXTRA_POSITIONS = 8     # cache capacity beyond prompt + new tokens, as the reference


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor       # [B, new_tokens], greedy, after the prompt's first token
    prefill_s: float           # host clock around prefill + cache growth, synchronized
    decode_s: float            # host clock around the decode loop, synchronized
    all_finite: bool           # every logit of the prefill and of every step
    kernel_launches: dict      # flash_attention launches in prefill and in decode


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def grow_cache(model: Model, cache, B: int, S: int, device):
    """A zero cache of capacity ``S`` holding the prefill ``cache`` in its
    leading positions (the reference test's ``blend``)."""
    full = model.init_cache(B, S, device=device)

    def blend(dst, src):
        if isinstance(dst, dict):
            return {k: blend(dst[k], src[k]) for k in dst}
        dst[tuple(slice(0, n) for n in src.shape)] = src.to(dst.dtype)
        return dst
    return blend(full, cache)


def generate(model: Model, params, prompt: torch.Tensor, new_tokens: int) -> ServeResult:
    """Greedy decoding of ``new_tokens`` tokens after ``prompt`` ([B, P]
    token ids on the parameters' device), the reference's serving loop: the
    prompt's argmax is fed first, and each step's argmax is kept."""
    dev = prompt.device
    B, P = prompt.shape
    S = P + new_tokens + EXTRA_POSITIONS
    launches = flash_attention.launches
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompt})
    cache = grow_cache(model, cache, B, S, dev)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    in_prefill = flash_attention.launches - launches
    finite = torch.isfinite(logits).all()
    out = []
    tok = logits.argmax(-1)[:, None]
    t0 = time.perf_counter()
    for i in range(new_tokens):
        logits, cache = model.decode_step(params, cache, tok, P + i)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return ServeResult(
        tokens=torch.cat(out, 1) if out else prompt.new_zeros((B, 0)),
        prefill_s=prefill_s, decode_s=decode_s, all_finite=bool(finite),
        kernel_launches={"prefill": in_prefill,
                         "decode": flash_attention.launches - launches - in_prefill})


def seeded_prompt(vocab: int, B: int, P: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, vocab, (B, P), generator=gen, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--reduced", action="store_true",
                    help="the same-family smoke config instead of the full one")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions; the CUDA card otherwise")
    args = ap.parse_args(argv)

    cfg = get(args.arch).reduced() if args.reduced else get(args.arch)
    dev = resolve_device(args.device)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    prompt = seeded_prompt(cfg.vocab, args.batch, args.prompt_len, 1, dev)
    res = generate(model, params, prompt, args.new_tokens)
    B, P, N = args.batch, args.prompt_len, args.new_tokens
    total = B * (P + N)
    dt = res.prefill_s + res.decode_s
    print(f"{cfg.name}: {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s on "
          f"{device_name(dev)}, batch={B}); prefill {res.prefill_s:.3f}s, decode "
          f"{res.decode_s / max(N, 1) * 1e3:.2f} ms/token; flash_attention launches "
          f"{res.kernel_launches}; logits finite: {res.all_finite}")
    print("sampled:", res.tokens[0][:16].tolist())


if __name__ == "__main__":
    main()
