"""Hand-written CUDA kernels for Hopper, one package per kernel of the
reference's Pallas set that the port has reached:

  cca_step     the DCTCP fluid scan (``fluid_scan``: every control step of
               a fluid run in one launch) and its one-step form ``cca_step``
  steady_scan  trailing-window max/min/mean over rate histories
  maxmin       dense max-min water-filling (``maxmin_rates_torch``); the
               package also holds the exact host solver the analytic
               engine runs
  flash_attention
               causal / sliding-window attention with grouped KV heads
               (the architecture zoo's full-sequence attention)

Each package holds the wrapper, with its launch count, and the plain
PyTorch version of the same function; the CUDA sources live in
``repro_torch/csrc`` and are built by :mod:`repro_torch.kernels.build` at
first use.  A wrapper takes the plain version only for CPU tensors: for a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch


def float32_input(x: torch.Tensor, name: str) -> torch.Tensor:
    """Kernels compute in float32, as the reference's wrappers do: floating
    inputs of another width are upcast, anything else is refused."""
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        raise TypeError(f"{name}: expected a floating-point tensor, got "
                        f"{getattr(x, 'dtype', type(x).__name__)}")
    return x.float()


def same_device(tensors: dict[str, torch.Tensor]) -> torch.device:
    """The one device every input lies on; raises when they differ or it is
    neither the CPU nor a CUDA card."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
