"""Unified model facade: ``build_model(cfg)`` returns a Model whose
prefill/decode entry points serve a decoder-only LM.

``init`` and ``init_cache`` make tensors on the CUDA card unless the caller
passes ``device="cpu"`` (:func:`repro_torch.device.resolve_device`);
``prefill`` and ``decode_step`` run where the parameters lie.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.params import count_params, init_params

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

    def _require_lm(self) -> None:
        if self.is_encdec:
            raise NotImplementedError(
                f"{self.cfg.name}: the encoder-decoder is not ported yet: it "
                "waits for ROADMAP Queue 1, \"The rest of the architecture zoo\"")

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

    @property
    def n_params(self) -> int:
        return count_params(self.specs)

    # -- steps ---------------------------------------------------------- #
    def prefill(self, params, batch):
        self._require_lm()
        return lm.prefill(self.cfg, params, batch)

    def decode_step(self, params, cache, tokens, pos: int):
        """One token; ``cache`` is updated in place (see
        :func:`repro_torch.models.lm.decode_step`)."""
        self._require_lm()
        return lm.decode_step(self.cfg, params, cache, tokens, pos)

    # -- caches ---------------------------------------------------------- #
    def cache_specs(self, B: int, S: int):
        self._require_lm()
        return lm.cache_specs(self.cfg, B, S, DTYPES[self.cfg.dtype])

    def init_cache(self, B: int, S: int, device=None):
        dev = resolve_device(device)
        return _map_cache(lambda sd: torch.zeros(sd[0], dtype=sd[1], device=dev),
                          self.cache_specs(B, S))


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)

