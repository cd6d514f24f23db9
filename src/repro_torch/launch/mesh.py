"""Production meshes.  Functions over an already initialised process group,
not module-level constants, so importing this module touches no device
state.  A port of ``repro.launch.mesh`` on ``torch.distributed``'s
``DeviceMesh``."""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``: the default group must have 256 or 512 ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(n_devices: int | None = None, model: int = 2, device_type: str = "cuda"):
    """Small ``("data", "model")`` mesh over the default group's ranks (or
    ``n_devices`` of them)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = n_devices or dist.get_world_size()
    data = max(1, n // model)
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
