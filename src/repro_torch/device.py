"""Where the port runs: on the CUDA card unless the caller asks for the CPU.

Importing this module loads no torch (the functions import it), so the
experiment layer can name :class:`NoCardError` without paying for torch.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch


class NoCardError(RuntimeError):
    """A CUDA device was wanted (the default) and there is none."""


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card; ``"cpu"`` must be asked for by name.

    Raises :class:`NoCardError` when a CUDA device is wanted and there is
    none: an entry point never moves to the CPU on its own, so a result
    always ran where the caller believes it ran."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCardError(
            "repro_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def device_name(dev: torch.device) -> str:
    """The name a result records for the device it ran on."""
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
