"""Parameter specs: every leaf carries a shape, logical axis names and an
initialiser.  The same tree yields initialised tensors, the logical-axis
tree the sharding rules consume (:func:`axes_tree`), allocation-free
``(shape, dtype)`` structs for the dry-run (:func:`shape_structs`) and the
parameter count.

A parameter tree is a nested ``dict`` with tensor leaves, the same keys and
the same stacked ``[R, ...]`` layer axis as the reference's pytree, so
:func:`params_from_numpy` carries the reference's parameters across as
they are.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class P:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float = 1.0            # stddev multiplier (normal: 1/sqrt(fan_in))

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


class Struct(NamedTuple):
    """A tensor's shape and dtype, allocating nothing: the counterpart of
    ``jax.ShapeDtypeStruct``."""
    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def map_tree(fn: Callable, tree):
    """``fn`` applied to every leaf of a nested dict, keys in sorted order
    (the order in which JAX flattens a dict)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def leaves(tree) -> list:
    out = []
    map_tree(out.append, tree)
    return out


def init_params(spec_tree, generator: torch.Generator, dtype: torch.dtype):
    """Tensors on ``generator``'s device: normal leaves are drawn in float32
    with std ``scale / sqrt(fan_in)`` and then cast, as in the reference
    (which draws other numbers: ``jax.random`` is not ``torch.Generator``)."""
    device = generator.device

    def mk(spec: P):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
        return x.mul_(std).to(dtype)

    return map_tree(mk, spec_tree)


def params_from_numpy(tree, device: str | torch.device, dtype: torch.dtype):
    """The reference's parameters (``jax.device_get(model.init(key))``: a
    nested dict of numpy arrays) as tensors of ``dtype`` on ``device``."""
    def mk(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: widen exactly first
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a, order="C")).to(device=device, dtype=dtype)
    return map_tree(mk, tree)


def axes_tree(spec_tree):
    """The logical axes of every leaf, a tree like the parameters."""
    return map_tree(lambda s: s.axes, spec_tree)


def shape_structs(spec_tree, dtype: torch.dtype):
    """A :class:`Struct` of every leaf in ``dtype``."""
    return map_tree(lambda s: Struct(tuple(s.shape), dtype), spec_tree)


def count_params(spec_tree) -> int:
    return sum(math.prod(s.shape) for s in leaves(spec_tree))
