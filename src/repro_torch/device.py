"""Where the port runs: on the CUDA card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA card; ``"cpu"`` must be asked for by name.

    Raises when a CUDA device is wanted and there is none: an entry point
    never moves to the CPU on its own, so a result always ran where the
    caller believes it ran."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def device_name(dev: torch.device) -> str:
    """The name a result records for the device it ran on."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
