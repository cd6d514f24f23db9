"""Deterministic chaos: declarative, seeded perturbation injectors.

Copy of ``repro.net.chaos`` reduced to what the flow-level engines use.
``Scenario.chaos`` is a list of plain dicts that JSON round-trips with
the scenario, and every engine derives the *same* perturbations from the
same declaration:

* phase-level injectors (``mice``, ``straggler``) are expanded by
  ``Scenario.build_phases`` into the phase DAG itself — dep-free mouse
  phases with ``compute=arrival_time``, per-rank compute multipliers — so
  the port's fluid engine drives the identical perturbed program the
  reference engines drive;
* link-level injectors (``degrade_link``, ``link_flap``, ``link_down``)
  retarget port capacities mid-run on the packet family, which is not
  ported yet.  They are parsed and validated here, and the flow-level
  backends refuse them: they have no port queues to degrade, and silently
  dropping a declared perturbation would be worse.

Injector dicts (all randomness comes from ``numpy.random.default_rng``
seeded with the injector's own ``seed``, so the draws are the reference's
draws):

    {"kind": "mice", "seed": 0, "rate": 2000.0, "size": 20000.0,
     "start": 0.0, "duration": 0.01, "cca": "dctcp"}
        Poisson mouse flows (mean interarrival 1/rate) between uniformly
        random distinct hosts.

    {"kind": "straggler", "seed": 0, "count": 2, "factor": 1.5}
    {"kind": "straggler", "ranks": [3, 7], "factor": 1.5}
        Per-rank compute multipliers (workload scenarios only): explicit
        ``ranks``, or ``count`` ranks drawn without replacement.

    {"kind": "degrade_link", "link": 12, "t": 0.002, "factor": 0.25}
    {"kind": "link_flap", "link": 12, "t_down": 0.002, "t_up": 0.004}
    {"kind": "link_down", "link": 12, "t": 0.002}
        Link-level injectors (packet family only).

An empty injector list is the identity: no phases are added.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.net.flows import FlowSpec
from repro_torch.workload.traffic import Phase

# Mouse-flow ids start far above any workload/collective allocation
# (FidAlloc counts up from 0) so the two id spaces can never collide.
CHAOS_FID_BASE = 1 << 20

# A "down" link keeps this fraction of its capacity: the queue horizon
# becomes astronomically long, new arrivals overflow the buffer and drop,
# but every rate stays finite (and below the lane-horizon safety bound).
DOWN_FACTOR = 1e-7

KINDS = ("mice", "straggler", "degrade_link", "link_flap", "link_down")

# backends with no port queues — link chaos is meaningless there
FLOW_LEVEL_BACKENDS = ("fluid", "analytic", "learned")


@dataclasses.dataclass(frozen=True)
class LinkEvent:
    """At time ``t``, port ``link`` runs at ``factor`` x its base capacity."""
    t: float
    link: int
    factor: float

    def __post_init__(self) -> None:
        if not 0.0 < self.factor <= 1.0:
            raise ValueError(f"link factor must be in (0, 1], got {self.factor}")
        if self.t < 0.0:
            raise ValueError(f"link event time must be >= 0, got {self.t}")


@dataclasses.dataclass
class ChaosPlan:
    """A parsed, validated ``Scenario.chaos`` declaration."""
    mice: list[dict]
    stragglers: list[dict]
    link_events: list[LinkEvent]

    @classmethod
    def parse(cls, chaos: list[dict]) -> ChaosPlan:
        mice: list[dict] = []
        stragglers: list[dict] = []
        links: list[LinkEvent] = []
        for i, inj in enumerate(chaos or []):
            if not isinstance(inj, dict) or "kind" not in inj:
                raise ValueError(
                    f"chaos[{i}]: each injector is a dict with a 'kind' key")
            kind = inj["kind"]
            if kind == "mice":
                _keys(i, inj, {"kind", "seed", "rate", "size"},
                      {"start", "duration", "cca"})
                if float(inj["rate"]) <= 0 or float(inj["size"]) <= 0:
                    raise ValueError(f"chaos[{i}]: mice rate/size must be > 0")
                mice.append(inj)
            elif kind == "straggler":
                _keys(i, inj, {"kind", "factor"}, {"seed", "count", "ranks"})
                if ("ranks" in inj) == ("seed" in inj):
                    raise ValueError(f"chaos[{i}]: straggler takes explicit "
                                     "'ranks' or a 'seed' (+ optional 'count'), "
                                     "not both / neither")
                if float(inj["factor"]) <= 0:
                    raise ValueError(f"chaos[{i}]: straggler factor must be > 0")
                stragglers.append(inj)
            elif kind == "degrade_link":
                _keys(i, inj, {"kind", "link", "t", "factor"}, {"t_end"})
                t = float(inj["t"])
                links.append(LinkEvent(t, int(inj["link"]), float(inj["factor"])))
                if "t_end" in inj:
                    t_end = float(inj["t_end"])
                    if t_end <= t:
                        raise ValueError(f"chaos[{i}]: t_end must be > t")
                    links.append(LinkEvent(t_end, int(inj["link"]), 1.0))
            elif kind == "link_flap":
                _keys(i, inj, {"kind", "link", "t_down", "t_up"}, set())
                t_down, t_up = float(inj["t_down"]), float(inj["t_up"])
                if t_up <= t_down:
                    raise ValueError(f"chaos[{i}]: t_up must be > t_down")
                links.append(LinkEvent(t_down, int(inj["link"]), DOWN_FACTOR))
                links.append(LinkEvent(t_up, int(inj["link"]), 1.0))
            elif kind == "link_down":
                _keys(i, inj, {"kind", "link", "t"}, set())
                links.append(LinkEvent(float(inj["t"]), int(inj["link"]),
                                       DOWN_FACTOR))
            else:
                raise ValueError(
                    f"chaos[{i}]: unknown kind {kind!r}; choose from {KINDS}")
        links.sort(key=lambda ev: (ev.t, ev.link))
        return cls(mice=mice, stragglers=stragglers, link_events=links)

    # ---------------- phase-level injectors ---------------- #

    def straggler_map(self, n_ranks: int) -> dict[int, float] | None:
        """Rank -> compute multiplier, merged across straggler injectors."""
        if not self.stragglers:
            return None
        out: dict[int, float] = {}
        for inj in self.stragglers:
            if "ranks" in inj:
                ranks = [int(r) for r in inj["ranks"]]
            else:
                rng = np.random.default_rng(int(inj["seed"]))
                count = min(int(inj.get("count", 1)), n_ranks)
                ranks = sorted(int(r) for r in
                               rng.choice(n_ranks, size=count, replace=False))
            factor = float(inj["factor"])
            for r in ranks:
                out[r] = out.get(r, 1.0) * factor
        return out

    def mice_phases(self, n_hosts: int,
                    fid_start: int = CHAOS_FID_BASE) -> list[Phase]:
        """Dep-free single-flow phases, one per Poisson arrival: the driver
        launches phase flows at ``t0 + compute``, so ``compute`` carries the
        arrival time."""
        phases: list[Phase] = []
        next_fid = fid_start
        for j, inj in enumerate(self.mice):
            rng = np.random.default_rng(int(inj["seed"]))
            rate = float(inj["rate"])
            size = float(inj["size"])
            start = float(inj.get("start", 0.0))
            duration = float(inj.get("duration", 0.01))
            cca = str(inj.get("cca", "dctcp"))
            t, k = start, 0
            while True:
                t += float(rng.exponential(1.0 / rate))
                if t > start + duration:
                    break
                src = int(rng.integers(n_hosts))
                dst = int(rng.integers(n_hosts - 1))
                if dst >= src:
                    dst += 1
                phases.append(Phase(
                    f"chaos.mice{j}.{k}",
                    [FlowSpec(next_fid, src, dst, size, 0.0, cca, "chaos.mice")],
                    [], t))
                next_fid += 1
                k += 1
        return phases


def plan_for(scenario) -> ChaosPlan | None:
    """Parse a scenario's chaos declaration (None when it has none)."""
    chaos = getattr(scenario, "chaos", None)
    return ChaosPlan.parse(chaos) if chaos else None


def check_backend(plan: ChaosPlan | None, backend: str) -> None:
    """Refuse link chaos on a flow-level backend, which has no port queues
    to degrade."""
    if plan is not None and plan.link_events and backend in FLOW_LEVEL_BACKENDS:
        raise ValueError(
            f"backend {backend!r} has no port queues to degrade — link chaos "
            "(degrade_link/link_flap/link_down) needs a packet-family "
            "backend (packet/wormhole/hybrid)")


def _keys(i: int, inj: dict, required: set, optional: set) -> None:
    have = set(inj)
    missing = required - have
    unknown = have - required - optional
    if missing or unknown:
        raise ValueError(
            f"chaos[{i}] ({inj.get('kind')}): "
            + (f"missing keys {sorted(missing)}" if missing else "")
            + (" and " if missing and unknown else "")
            + (f"unknown keys {sorted(unknown)}" if unknown else ""))
