"""A configuration file's training job, built by the reference alone.

The benchmark's configuration files state a paper Table-1 job in full: the
model slice the network sees, the parallelism, the compute model, the
fabric, the congestion control and the packet oracle's knobs.  This module
turns such a file, a message-size scale and a straggler draw into the
fabric and the phase DAG through the frozen builders beside it, so the
reference derives everything the program derives without asking it.
"""
from __future__ import annotations

import dataclasses

from simbench.reference.parallelism import ParallelismConfig
from simbench.reference.topology import TOPOLOGY_BUILDERS, Topology
from simbench.reference.traffic import Phase, TrafficModelSpec, build_training_program


@dataclasses.dataclass(frozen=True)
class Job:
    """One configuration file's job (the ``model``, ``parallelism``,
    ``compute``, ``fabric``, ``cca``, ``collective`` and ``sim`` keys)."""
    config: dict

    @property
    def n_ranks(self) -> int:
        par = self.config["parallelism"]
        return par["tp"] * par["dp"] * par["pp"] * par["ep"]

    def topology(self) -> Topology:
        fabric = dict(self.config["fabric"])
        return TOPOLOGY_BUILDERS[fabric.pop("kind")](**fabric)

    def phases(self, scale: float, straggler: tuple[int, float] | None) -> list[Phase]:
        par = self.config["parallelism"]
        return build_training_program(
            TrafficModelSpec(**self.config["model"]),
            ParallelismConfig(tp=par["tp"], dp=par["dp"], pp=par["pp"], ep=par["ep"]),
            cca=self.config["cca"], scale=scale,
            chip_flops=self.config["compute"]["chip_flops"],
            mfu=self.config["compute"]["mfu"],
            num_microbatches=par["num_microbatches"], straggler=straggler,
            ep_over_dp=par["ep_over_dp"], collective=self.config["collective"])
