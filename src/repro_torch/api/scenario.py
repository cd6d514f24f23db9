"""Declarative, JSON-serializable experiment scenarios.

A :class:`Scenario` is the single input every simulation backend consumes:
a topology spec, either an explicit flow list or a workload-preset training
program, plus kernel / simulator knobs.  Because it is pure data
(``to_dict``/``from_dict`` round-trip exactly), a scenario can be stored,
diffed, swept over (``variant``) and handed to any registered engine — the
"one declarative scenario, interchangeable fidelity backends" framing of
m4 / HyGra applied to this repo's packet / wormhole / fluid / analytic
stack.

The PyTorch port keeps its own copy of ``repro.api.scenario``, which the
port may not import; the tests hold the two to identical outputs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

from repro_torch import obs
from repro_torch.net.chaos import ChaosPlan
from repro_torch.net.flows import FlowSpec
from repro_torch.net.topology import TOPOLOGY_BUILDERS, Topology
from repro_torch.workload import presets
from repro_torch.workload.traffic import Phase, build_training_program


@dataclasses.dataclass
class TopologySpec:
    """Declarative fabric: a ``TOPOLOGY_BUILDERS`` key plus builder kwargs."""
    kind: str
    params: dict[str, Any] = dataclasses.field(default_factory=dict)

    def build(self) -> Topology:
        try:
            builder = TOPOLOGY_BUILDERS[self.kind]
        except KeyError:
            raise ValueError(
                f"unknown topology kind {self.kind!r}; "
                f"have {sorted(TOPOLOGY_BUILDERS)}") from None
        return builder(**self.params)


@dataclasses.dataclass
class WorkloadSpec:
    """A Table-1 training program by reference (family + size + knobs)."""
    family: str = "gpt"                  # gpt | moe | a presets.NAMED model
    n_gpus: int = 64
    cca: str = "hpcc"
    scale: float = 1 / 256               # flow-size scale vs the real workload
    ep_over_dp: int = 0                  # 0 -> family default (MoE: EP from DP)
    num_microbatches: int | None = None
    straggler: tuple[int, float] | None = None  # (rank, compute multiplier)
    collective: str = "ring"             # DP gradient-sync schedule
                                         # (workload.schedules.SCHEDULES key)

    def build_phases(self, topo_meta: dict | None = None,
                     extra_stragglers: dict[int, float] | None = None,
                     ) -> list[Phase]:
        spec, par, ep_default = presets.resolve(self.family, self.n_gpus)
        ep = self.ep_over_dp or ep_default
        with obs.span("workload.build"):
            phases = build_training_program(
                spec, par, cca=self.cca, scale=self.scale, ep_over_dp=ep,
                num_microbatches=self.num_microbatches, straggler=self.straggler,
                collective=self.collective, topo_meta=topo_meta,
                extra_stragglers=extra_stragglers)
        if obs.recording():
            flows = [f for ph in phases for f in ph.flows]
            obs.count("workload.flows", len(flows))
            obs.count("workload.a2a_flows", sum(f.tag.startswith("ep.") for f in flows))
        return phases


@dataclasses.dataclass
class Scenario:
    """One experiment: topology + traffic (flows XOR workload) + knobs.

    ``kernel`` holds WormholeConfig overrides (used by the wormhole backend),
    ``sim`` holds PacketSim knobs (mtu, ecn_k, buffer_bytes, ...) shared by
    the packet-level backends, ``chaos`` is a list of perturbation-injector
    dicts (see :mod:`repro.net.chaos`) every backend derives identically.
    """
    name: str
    topology: TopologySpec
    flows: list[FlowSpec] | None = None
    workload: WorkloadSpec | None = None
    kernel: dict[str, Any] = dataclasses.field(default_factory=dict)
    sim: dict[str, Any] = dataclasses.field(default_factory=dict)
    chaos: list[dict] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        if (self.flows is None) == (self.workload is None):
            raise ValueError("Scenario needs exactly one of flows / workload")

    @property
    def kind(self) -> str:
        return "flows" if self.flows is not None else "workload"

    # ------------------------------------------------------------------ #
    # builders
    # ------------------------------------------------------------------ #
    def build_topology(self) -> Topology:
        return self.topology.build()

    def build_phases(self) -> list[Phase]:
        """Traffic as a phase DAG.  Explicit flows become one dependency-free
        phase per distinct start time (each flow keeps its own launch).

        Phase-level chaos injectors land here — straggler multipliers fold
        into the workload's compute times and mice arrivals append as
        dep-free phases — so every engine, packet through analytic, drives
        the identical perturbed program.
        """
        plan = ChaosPlan.parse(self.chaos) if self.chaos else None
        if self.workload is not None:
            phases = self.workload.build_phases(
                topo_meta=dict(self.topology.params),
                extra_stragglers=(plan.straggler_map(self.workload.n_gpus)
                                  if plan else None))
        else:
            by_start: dict[float, list[FlowSpec]] = {}
            for f in self.flows:
                by_start.setdefault(f.start, []).append(f)
            phases = [Phase(f"flows@{t:g}", fl, [], 0.0)
                      for t, fl in sorted(by_start.items())]
        if plan is not None:
            phases = phases + plan.mice_phases(self._n_hosts())
        return phases

    def _n_hosts(self) -> int:
        """Host-id universe for seeded injectors (no topology build)."""
        if self.workload is not None:
            return self.workload.n_gpus
        return max(max(f.src, f.dst) for f in self.flows) + 1

    # ------------------------------------------------------------------ #
    # serialization
    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "name": self.name,
            "topology": {"kind": self.topology.kind,
                         "params": dict(self.topology.params)},
            "kernel": dict(self.kernel),
            "sim": dict(self.sim),
        }
        if self.flows is not None:
            d["flows"] = [dataclasses.asdict(f) for f in self.flows]
        if self.workload is not None:
            w = dataclasses.asdict(self.workload)
            if w["straggler"] is not None:
                w["straggler"] = list(w["straggler"])
            if w["collective"] == "ring":
                # default elided: pre-collective scenario fingerprints (and
                # every run_key derived from them) stay byte-identical
                del w["collective"]
            d["workload"] = w
        if self.chaos:
            # same default-elision contract as collective=: an empty
            # injector list serializes exactly as the pre-chaos schema
            d["chaos"] = [dict(c) for c in self.chaos]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        flows = None
        if "flows" in d:
            flows = [FlowSpec(**f) for f in d["flows"]]
        workload = None
        if "workload" in d:
            w = dict(d["workload"])
            if w.get("straggler") is not None:
                w["straggler"] = tuple(w["straggler"])
            workload = WorkloadSpec(**w)
        return cls(
            name=d["name"],
            topology=TopologySpec(d["topology"]["kind"],
                                  dict(d["topology"].get("params", {}))),
            flows=flows, workload=workload,
            kernel=dict(d.get("kernel", {})), sim=dict(d.get("sim", {})),
            chaos=[dict(c) for c in d.get("chaos", [])],
        )

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        return cls.from_dict(json.loads(s))

    # ------------------------------------------------------------------ #
    # sweeps
    # ------------------------------------------------------------------ #
    def variant(self, name: str | None = None, *, cca: str | None = None,
                size_scale: float | None = None,
                kernel: dict | None = None, sim: dict | None = None,
                topology: TopologySpec | None = None,
                chaos: list[dict] | None = None,
                **workload_overrides) -> "Scenario":
        """A deep copy with common sweep axes overridden: CCA, flow-size
        scale, kernel/sim knob merges, topology swap, chaos injector list
        replacement, or workload fields."""
        scn = Scenario.from_dict(self.to_dict())
        if name is not None:
            scn.name = name
        if topology is not None:
            scn.topology = topology
        if kernel:
            scn.kernel = {**scn.kernel, **kernel}
        if sim:
            scn.sim = {**scn.sim, **sim}
        if chaos is not None:
            scn.chaos = [dict(c) for c in chaos]
        if scn.flows is not None:
            if workload_overrides:
                raise ValueError(
                    f"flow scenario takes no workload overrides "
                    f"{sorted(workload_overrides)}")
            if cca is not None or size_scale is not None:
                scn.flows = [dataclasses.replace(
                    f, cca=cca if cca is not None else f.cca,
                    size=f.size * (size_scale or 1.0)) for f in scn.flows]
        else:
            w = scn.workload
            if cca is not None:
                w.cca = cca
            if size_scale is not None:
                w.scale *= size_scale
            for k, v in workload_overrides.items():
                if not hasattr(w, k):
                    raise ValueError(f"WorkloadSpec has no field {k!r}")
                setattr(w, k, v)
        return scn


# ---------------------------------------------------------------------- #
# convenience constructors
# ---------------------------------------------------------------------- #
def training_scenario(n_gpus: int = 64, moe: bool = False, cca: str = "hpcc",
                      scale: float = 1 / 256, name: str | None = None,
                      gpus_per_server: int = 8, bw: float = 12.5e9,
                      chaos: list[dict] | None = None, family: str | None = None,
                      **workload_kw) -> Scenario:
    """The paper's headline setup: a Table-1 workload on its rail-optimized
    fat-tree (presets.topology_for), as a declarative scenario.  ``family``
    names the workload (``presets.FAMILIES``) in place of ``moe``."""
    if family is not None and moe:
        raise ValueError("name the workload by family= or by moe=True, not both")
    topo = TopologySpec("roft", {
        "n_servers": max(2, max(n_gpus, 16) // gpus_per_server),
        "gpus_per_server": gpus_per_server,
        "leaf_radix": 32, "n_spines": 8, "bw": bw,
    })
    wl = WorkloadSpec(family=family or ("moe" if moe else "gpt"), n_gpus=n_gpus,
                      cca=cca, scale=scale, **workload_kw)
    if name is None:
        # the auto-name keys benchmark baseline caches: make it a function
        # of everything that changes the traffic program
        inv = 1 / scale if scale else 0
        stxt = f"1/{inv:g}" if abs(inv - round(inv)) < 1e-9 and inv >= 1 \
            else f"{scale:g}"
        name = f"{wl.family}@{n_gpus}-{cca}-s{stxt}"
        if wl.ep_over_dp:
            name += f"-ep{wl.ep_over_dp}"
        if wl.num_microbatches is not None:
            name += f"-mb{wl.num_microbatches}"
        if wl.straggler is not None:
            name += f"-straggler{wl.straggler[0]}x{wl.straggler[1]:g}"
        if wl.collective != "ring":
            name += f"-{wl.collective}"
        if chaos:
            digest = hashlib.sha256(
                json.dumps(chaos, sort_keys=True).encode()).hexdigest()[:6]
            name += f"-chaos{digest}"
    return Scenario(name=name, topology=topo, workload=wl,
                    chaos=[dict(c) for c in chaos] if chaos else [])
