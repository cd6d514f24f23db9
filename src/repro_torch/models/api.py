"""Unified model facade: ``build_model(cfg)`` returns a Model whose
loss/prefill/decode entry points serve any registered architecture: the
decoder-only LM (:mod:`repro_torch.models.lm`) or the encoder-decoder
(:mod:`repro_torch.models.encdec`).

``init`` and ``init_cache`` make tensors on the CUDA card unless the caller
passes ``device="cpu"`` (:func:`repro_torch.device.resolve_device`);
``loss``, ``prefill`` and ``decode_step`` run where the parameters lie.
``param_axes``, ``param_structs``, ``cache_axes``, ``cache_structs`` and
``input_specs`` describe every input of a step without allocating it, for
the sharding rules and the dry-run (:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.params import (Struct, axes_tree, count_params, init_params,
                                       shape_structs)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _is_cache_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)


def _map_cache(fn, specs):
    if _is_cache_spec(specs):
        return fn(specs)
    return {k: _map_cache(fn, v) for k, v in specs.items()}


@dataclasses.dataclass
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        self.is_encdec = self.cfg.enc_dec
        self.specs = (encdec.encdec_specs if self.is_encdec else lm.lm_specs)(self.cfg)

    # -- params -------------------------------------------------------- #
    def init(self, seed: int | torch.Generator, device=None):
        """Parameters drawn from ``seed`` (an int, or a ``torch.Generator``
        on the target device) in the config's ``param_dtype``."""
        dev = resolve_device(device)
        if isinstance(seed, torch.Generator):
            gen = seed
            if gen.device.type != dev.type:
                raise ValueError(f"generator on {gen.device}, parameters wanted on {dev}")
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        return init_params(self.specs, gen, DTYPES[self.cfg.param_dtype])

    def param_axes(self):
        return axes_tree(self.specs)

    def param_structs(self):
        return shape_structs(self.specs, DTYPES[self.cfg.param_dtype])

    @property
    def n_params(self) -> int:
        return count_params(self.specs)

    # -- steps ---------------------------------------------------------- #
    def loss(self, params, batch):
        """Mean next-token cross-entropy, a float32 scalar, on the device of
        the parameters; differentiable (``batch``: ``tokens``, ``labels``,
        and ``prefix_embeds`` for the stubs)."""
        fn = encdec.loss_fn if self.is_encdec else lm.loss_fn
        return fn(self.cfg, params, batch)

    def prefill(self, params, batch):
        """``batch``: ``tokens`` ``[B, T]``, and ``prefix_embeds``
        ``[B, P, d]`` for the vision and audio stubs (the encoder-decoder's
        frames).  Returns (last-token logits, populated cache)."""
        fn = encdec.prefill if self.is_encdec else lm.prefill
        return fn(self.cfg, params, batch)

    def decode_step(self, params, cache, tokens, pos: int):
        """One token; ``cache`` is updated in place (see
        :func:`repro_torch.models.lm.decode_step`)."""
        fn = encdec.decode_step if self.is_encdec else lm.decode_step
        return fn(self.cfg, params, cache, tokens, pos)

    # -- caches ---------------------------------------------------------- #
    def cache_specs(self, B: int, S: int):
        """The reference's specs.  The encoder-decoder's cross cache is
        given ``min(S, 4096)`` frames there, which need not be the real
        frame count: serving takes the cross cache from prefill."""
        dtype = DTYPES[self.cfg.dtype]
        if self.is_encdec:
            return encdec.cache_specs(self.cfg, B, S, S_enc=min(S, 4096), dtype=dtype)
        return lm.cache_specs(self.cfg, B, S, dtype)

    def cache_axes(self):
        return (encdec.cache_axes if self.is_encdec else lm.cache_axes)(self.cfg)

    def cache_structs(self, B: int, S: int):
        return _map_cache(lambda sd: Struct(*sd), self.cache_specs(B, S))

    def init_cache(self, B: int, S: int, device=None):
        dev = resolve_device(device)
        return _map_cache(lambda sd: torch.zeros(sd[0], dtype=sd[1], device=dev),
                          self.cache_specs(B, S))

    # -- input specs per shape cell -------------------------------------- #
    def input_specs(self, shape: ShapeCell | str) -> dict:
        """:class:`~repro_torch.models.params.Struct` stand-ins for every
        input of the cell's step (no allocation), key for key the
        reference's; token ids are int32 there and here."""
        cell = SHAPES[shape] if isinstance(shape, str) else shape
        B, S = cell.global_batch, cell.seq_len
        cfg = self.cfg
        tok = lambda b, s: Struct((b, s), torch.int32)                       # noqa: E731
        emb = lambda b, s: Struct((b, s, cfg.d_model), DTYPES[cfg.dtype])     # noqa: E731
        if cell.kind == "train":
            if self.is_encdec:
                return {"prefix_embeds": emb(B, S), "tokens": tok(B, S), "labels": tok(B, S)}
            if cfg.frontend == "vision_patches":
                return {"prefix_embeds": emb(B, cfg.n_patches),
                        "tokens": tok(B, S - cfg.n_patches),
                        "labels": tok(B, S - cfg.n_patches)}
            return {"tokens": tok(B, S), "labels": tok(B, S)}
        if cell.kind == "prefill":
            if self.is_encdec:
                return {"prefix_embeds": emb(B, S), "tokens": tok(B, min(S, 448))}
            if cfg.frontend == "vision_patches":
                return {"prefix_embeds": emb(B, cfg.n_patches),
                        "tokens": tok(B, S - cfg.n_patches)}
            return {"tokens": tok(B, S)}
        if cell.kind != "decode":
            raise ValueError(f"unknown cell kind {cell.kind!r}")
        return {"cache": self.cache_structs(B, S), "tokens": tok(B, 1),
                "pos": Struct((), torch.int32)}


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)

