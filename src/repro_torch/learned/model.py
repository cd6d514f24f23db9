"""Per-flow FCT predictor in PyTorch + versioned parameter serialization.

The port of ``repro.learned.model``, which the port may not import.  The
model is a small MLP (tanh hidden layers, linear head) over the encoded
per-flow features of ``repro_torch.learned.dataset``, predicting the log
slowdown ``log(fct / ideal_fct)``.  ``init``/``apply``/``loss`` are plain
functions over a ``[(W, b), ...]`` list of tensors, so the fit loop can
differentiate through them with ``torch.autograd`` and the engine can batch
them freely; their products are ``torch.matmul``, as the reference's are
plain ``jnp`` outside any Pallas kernel.

Fitted parameters are a :class:`LearnedParams`: the weight list (numpy)
plus a ``meta`` dict carrying everything serving needs — feature
vocabulary, standardization moments, the training envelope (per-feature
min/max, the out-of-distribution guard), and a content fingerprint.
``LearnedParams``, ``fingerprint_of``, ``make_params``, ``save`` and
``load`` are copied from the reference unchanged (numpy and JSON), so a
params file either package saved loads in the other with the same
fingerprint.  ``save``/``load`` persist them as a JSON meta file plus a
sibling ``.npz`` of weights; ``load`` refuses foreign ``params_version``
files instead of silently misreading them.

``init`` draws from an explicit ``torch.Generator`` on the CPU, so a fit
on the card and one on the CPU start from the same weights; ``predict``
runs on the CUDA card unless given ``device="cpu"``.  The reference's
``jax.random`` draws cannot be reproduced in torch, so the two packages'
fits start from different weights under one seed.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
from hashlib import sha256
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    import torch

PARAMS_VERSION = 1


# ---------------------------------------------------------------------- #
# the network: init / apply / loss (torch imported inside them, so
# dataset-only users never pay for it)
# ---------------------------------------------------------------------- #
def init(seed: int, d_in: int, hidden: tuple[int, ...] = (64, 64)) -> list:
    """Fresh weight list ``[(W, b), ...]`` for ``d_in`` features:
    ``N(0, 1) / sqrt(fan_in)`` weights and zero biases, float32 CPU
    tensors drawn from a generator seeded with ``seed`` (``fit`` moves them
    to its device), so a fit on the card and one on the CPU start from the
    same weights."""
    import torch
    sizes = (d_in, *hidden, 1)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    weights = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=gen, dtype=torch.float32) / math.sqrt(a)
        weights.append((w, torch.zeros(b, dtype=torch.float32)))
    return weights


def apply(weights, x: torch.Tensor) -> torch.Tensor:
    """Forward pass: ``[N, D]`` standardized features -> ``[N]`` predicted
    log slowdown."""
    import torch
    h = x
    for w, b in weights[:-1]:
        h = torch.tanh(h @ w + b)
    w, b = weights[-1]
    return (h @ w + b)[..., 0]


def loss(weights, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean squared error in log-slowdown space."""
    return ((apply(weights, x) - y) ** 2).mean()


# ---------------------------------------------------------------------- #
# fitted parameters
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class LearnedParams:
    """Fitted weights + the ``meta`` serving contract (see module doc)."""
    weights: list[tuple[np.ndarray, np.ndarray]]
    meta: dict

    @property
    def fingerprint(self) -> str:
        return self.meta["fingerprint"]

    @property
    def d_in(self) -> int:
        return self.weights[0][0].shape[0]


def fingerprint_of(weights, meta: dict) -> str:
    """Content hash over the meta (sans any existing fingerprint) and the
    raw weight bytes — what RunResult extras report so a result can always
    be traced to the exact model that produced it."""
    h = sha256(json.dumps({k: v for k, v in sorted(meta.items())
                           if k != "fingerprint"},
                          sort_keys=True, default=str).encode())
    for w, b in weights:
        h.update(np.ascontiguousarray(w, np.float32).tobytes())
        h.update(np.ascontiguousarray(b, np.float32).tobytes())
    return h.hexdigest()[:16]


def make_params(weights, meta: dict) -> LearnedParams:
    """Seal ``meta`` with version + fingerprint and wrap into
    :class:`LearnedParams` (weights come back as numpy, detached from any
    device tensors)."""
    weights = [(np.asarray(w, np.float32), np.asarray(b, np.float32))
               for w, b in weights]
    meta = dict(meta)
    meta["params_version"] = PARAMS_VERSION
    meta["fingerprint"] = fingerprint_of(weights, meta)
    return LearnedParams(weights=weights, meta=meta)


def _npz_path(path: pathlib.Path) -> pathlib.Path:
    return path.with_suffix(".npz") if path.suffix == ".json" \
        else path.with_name(path.name + ".npz")


def save(params: LearnedParams, path: str | os.PathLike) -> None:
    """Persist to ``path`` (JSON meta) + a sibling ``.npz`` (weights).
    Atomic per file, like the RunStore's record commits."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    npz = _npz_path(path)
    arrays = {}
    for i, (w, b) in enumerate(params.weights):
        arrays[f"w{i}"] = w
        arrays[f"b{i}"] = b
    tmp = npz.with_name(f".{npz.name}.tmp.{os.getpid()}")
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, npz)
    meta = dict(params.meta)
    meta["n_layers"] = len(params.weights)
    meta["weights_file"] = npz.name
    tmp = path.with_name(f".{path.name}.tmp.{os.getpid()}")
    tmp.write_text(json.dumps(meta, indent=1, sort_keys=True))
    os.replace(tmp, path)


def load(path: str | os.PathLike) -> LearnedParams:
    """Inverse of :meth:`save`.  Refuses foreign ``params_version`` files
    and fingerprint mismatches (a meta file paired with the wrong
    weights)."""
    path = pathlib.Path(path)
    meta = json.loads(path.read_text())
    version = meta.get("params_version")
    if version != PARAMS_VERSION:
        raise ValueError(
            f"{path} has params_version {version!r}, not the supported "
            f"{PARAMS_VERSION}; re-fit the model with this code version")
    n_layers = meta.pop("n_layers")
    npz = path.with_name(meta.pop("weights_file"))
    with np.load(npz) as arrays:
        weights = [(np.asarray(arrays[f"w{i}"], np.float32),
                    np.asarray(arrays[f"b{i}"], np.float32))
                   for i in range(n_layers)]
    want = meta.get("fingerprint")
    got = fingerprint_of(weights, meta)
    if want != got:
        raise ValueError(
            f"{path}: fingerprint {want!r} does not match weights in "
            f"{npz.name} ({got!r}) — meta and weights files are from "
            f"different fits")
    return LearnedParams(weights=weights, meta=meta)


def predict(params: LearnedParams, X: np.ndarray, device=None) -> np.ndarray:
    """Serving entry: standardize raw encoded features with the fitted
    moments (float64, on the host) and apply the network in float32 on
    ``device`` (the CUDA card unless ``"cpu"``).  One call evaluates any
    batch size — the engine flattens whole scenario sweeps into a single
    invocation.  Returns float64 numpy."""
    import torch

    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    mu = np.asarray(params.meta["mu"], np.float64)
    sigma = np.asarray(params.meta["sigma"], np.float64)
    xs = (np.asarray(X, np.float64) - mu) / sigma
    weights = [(torch.tensor(w, dtype=torch.float32, device=dev),
                torch.tensor(b, dtype=torch.float32, device=dev))
               for w, b in params.weights]
    with torch.no_grad():
        out = apply(weights, torch.from_numpy(xs.astype(np.float32)).to(dev))
    return out.cpu().numpy().astype(np.float64)
