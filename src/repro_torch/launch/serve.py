"""Serving entry point: batched prefill, then greedy decode with the caches.

    python -m repro_torch.launch.serve --arch granite-3-2b
    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --reduced --device cpu

Runs the full config on the CUDA card unless the caller passes
``--reduced`` (the same-family smoke config) or ``--device cpu``.  The
prompt is filled by one ``Model.prefill`` (full-sequence self-attention
through the flash-attention kernel) and its cache is grown to decode
capacity; then each new token is one ``Model.decode_step``.  Weights are
drawn from seed 0 and the prompt from seed 1, as in the reference's
``launch/serve.py``.  The vision and audio frontends are stubs, as in the
reference: the CLI draws their embeddings from seed 2 (``cfg.n_patches``
patches; 1500 audio frames, Whisper's 30 s encoder length) and says so.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import get
from repro_torch.device import device_name, resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.api import DTYPES, Model, build_model

EXTRA_POSITIONS = 8     # cache capacity beyond prompt + new tokens, as the reference
AUDIO_FRAMES = 1500     # Whisper's encoder length for 30 s of audio


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


def _grow(spec, src):
    """``src`` in a zero tensor of the spec's shape, at its leading
    positions (the reference test's ``blend``); ``src`` itself where the
    shapes agree (recurrent state, a full ring)."""
    if isinstance(spec, dict):
        return {k: _grow(spec[k], src[k]) for k in spec}
    shape, dtype = spec
    if tuple(src.shape) == tuple(shape):
        return src.to(dtype)
    if src.dim() != len(shape) or any(n > m for n, m in zip(src.shape, shape)):
        raise ValueError(f"a cache leaf of shape {tuple(src.shape)} does not fit {shape}")
    dst = torch.zeros(shape, dtype=dtype, device=src.device)
    dst[tuple(slice(0, n) for n in src.shape)] = src
    return dst


def grow_cache(model: Model, cache, B: int, S: int):
    """The prefill ``cache`` at decode capacity ``S``.  Attention caches
    grow to S positions; a windowed layer's only to ``min(S, window)``, its
    slots kept in ring order; recurrent state stays as it is.  The
    encoder-decoder's cross cache is carried through unchanged (its
    ``cache_specs`` frame count is not the real one)."""
    specs = model.cache_specs(B, S)
    if model.is_encdec:
        return {"self": _grow(specs["self"], cache["self"]), "cross": cache["cross"]}
    return _grow(specs, cache)


def prompt_positions(model: Model, batch) -> int:
    """Positions the prefill batch fills: its tokens, and for a decoder-only
    model with a frontend its prefix embeddings too (the encoder-decoder's
    frames feed the cross cache, not the decoder's positions)."""
    P = batch["tokens"].shape[1]
    if not model.is_encdec and model.cfg.frontend and "prefix_embeds" in batch:
        P += batch["prefix_embeds"].shape[1]
    return P


def generate(model: Model, params, batch: dict, new_tokens: int) -> ServeResult:
    """Greedy decoding of ``new_tokens`` tokens after the prefill ``batch``
    (``tokens`` ``[B, P]`` ids, and ``prefix_embeds`` for the vision and
    audio stubs, on the parameters' device), the reference's serving loop:
    the prompt's argmax is fed first, and each step's argmax is kept."""
    tokens = batch["tokens"]
    dev = tokens.device
    B = tokens.shape[0]
    P = prompt_positions(model, batch)
    S = P + new_tokens + EXTRA_POSITIONS
    launches = flash_attention.launches
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch)
    cache = grow_cache(model, cache, B, S)
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
        tokens=torch.cat(out, 1) if out else tokens.new_zeros((B, 0)),
        prefill_s=prefill_s, decode_s=decode_s, all_finite=bool(finite),
        kernel_launches={"prefill": in_prefill,
                         "decode": flash_attention.launches - launches - in_prefill})


def seeded_prompt(vocab: int, B: int, P: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, vocab, (B, P), generator=gen, device=device)


def seeded_batch(cfg, B: int, P: int, device, seed: int = 1) -> dict:
    """The prefill batch: P prompt tokens from ``seed``, and where the
    config has a frontend the stub's embeddings (standard normal, in
    ``cfg.dtype``) from ``seed + 1``: ``cfg.n_patches`` vision patches, or
    :data:`AUDIO_FRAMES` audio frames."""
    batch = {"tokens": seeded_prompt(cfg.vocab, B, P, seed, device)}
    if cfg.frontend:
        n = AUDIO_FRAMES if cfg.frontend == "audio_frames" else cfg.n_patches
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 1)
        x = torch.randn((B, n, cfg.d_model), generator=gen, device=device)
        batch["prefix_embeds"] = x.to(DTYPES[cfg.dtype])
    return batch


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
    batch = seeded_batch(cfg, args.batch, args.prompt_len, dev)
    if "prefix_embeds" in batch:
        print(f"{cfg.name}: stub {cfg.frontend} frontend: "
              f"{batch['prefix_embeds'].shape[1]} random embeddings (seed 2) before the prompt")
    res = generate(model, params, batch, args.new_tokens)
    B, N = args.batch, args.new_tokens
    total = B * (prompt_positions(model, batch) + N)
    dt = res.prefill_s + res.decode_s
    print(f"{cfg.name}: {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s on "
          f"{device_name(dev)}, batch={B}); prefill {res.prefill_s:.3f}s, decode "
          f"{res.decode_s / max(N, 1) * 1e3:.2f} ms/token; flash_attention launches "
          f"{res.kernel_launches}; logits finite: {res.all_finite}")
    print("sampled:", res.tokens[0][:16].tolist())


if __name__ == "__main__":
    main()
