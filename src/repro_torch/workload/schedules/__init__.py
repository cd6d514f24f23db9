"""Collective-schedule library: staged allreduce decompositions emitted as
the ordered ``(name, flows)`` steps ``build_training_program`` chains into
the training DAG (``collective=`` on :class:`~repro_torch.api.WorkloadSpec`).
The pipeline programs of the reference's schedule library are not ported:
the training program does not use them."""
from repro_torch.workload.schedules.allreduce import (SCHEDULES, allreduce_steps,
                                                      halving_doubling_allreduce,
                                                      hierarchical_allreduce,
                                                      ring_allreduce_steps,
                                                      tree_allreduce)

__all__ = [
    "SCHEDULES", "allreduce_steps", "ring_allreduce_steps", "tree_allreduce",
    "halving_doubling_allreduce", "hierarchical_allreduce",
]
