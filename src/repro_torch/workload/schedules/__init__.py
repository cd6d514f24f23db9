"""Collective-schedule library: alternative allreduce decompositions and
pipeline send/recv programs, all emitted as the phase-DAG shapes the
:class:`~repro_torch.workload.driver.WorkloadDriver` consumes.

``workload/collectives.py`` models every collective as one flat flow set
(ring steps overlap perfectly, so the aggregate is a single long stream).
Real collective algorithms are *staged*: a tree allreduce is log2(n)
reduce rounds followed by log2(n) broadcast rounds, halving-doubling is a
recursive-halving reduce-scatter then a recursive-doubling allgather, and
hierarchical allreduce localizes the heavy steps (rail-local
reduce-scatter -> cross-rail allreduce of the shards -> rail-local
allgather on the rail-optimized fat-tree).  Each builder here returns an
ordered list of ``(name, flows)`` *steps* — step k may only start once
step k-1 has drained — which ``build_training_program`` stitches into the
training DAG (``collective=`` on :class:`~repro_torch.api.scenario.WorkloadSpec`)
and tests/benches drive directly.

The staged shapes matter adversarially: Wormhole's memoization keys on
repeating contention patterns, and a staged collective replaces one long
steady elephant with a sequence of short, differently-shaped waves.

Copy of ``repro.workload.schedules``, which the port may not import.
"""
from repro_torch.workload.schedules.allreduce import (SCHEDULES, allreduce_steps,
                                                halving_doubling_allreduce,
                                                hierarchical_allreduce,
                                                ring_allreduce_steps,
                                                steps_to_phases,
                                                tree_allreduce)
from repro_torch.workload.schedules.pipeline import (pipeline_bubble_fraction,
                                               pipeline_phases)

__all__ = [
    "SCHEDULES", "allreduce_steps", "ring_allreduce_steps", "tree_allreduce",
    "halving_doubling_allreduce", "hierarchical_allreduce", "steps_to_phases",
    "pipeline_phases", "pipeline_bubble_fraction",
]
