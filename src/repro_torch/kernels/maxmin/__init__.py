"""Max-min water-filling solver package (see ops.py for the layout)."""
from repro_torch.kernels.maxmin.ops import (
    SOLVER_COUNTERS,
    maxmin,
    maxmin_plain,
    maxmin_rates_arrays,
    maxmin_rates_torch,
    paths_to_arrays,
    reset_counters,
    solve_paths,
)

__all__ = [
    "SOLVER_COUNTERS",
    "maxmin",
    "maxmin_plain",
    "maxmin_rates_arrays",
    "maxmin_rates_torch",
    "paths_to_arrays",
    "reset_counters",
    "solve_paths",
]
