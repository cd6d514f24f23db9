"""Deterministic chaos: declarative, seeded perturbation injectors.

Copy of ``repro.net.chaos``, which the port may not import.  The port runs
the serial packet loop only: the partition-sharded loop named below is not
ported yet.

``Scenario.chaos`` is a list of plain dicts that JSON round-trips with
the scenario, so perturbations are part of the content-addressed run key
and every engine derives the *same* perturbations from the same
declaration:

* phase-level injectors (``mice``, ``straggler``) are expanded by
  ``Scenario.build_phases`` into the phase DAG itself — dep-free mouse
  phases with ``compute=arrival_time``, per-rank compute multipliers —
  so packet, wormhole, fluid, and analytic backends all drive identical
  perturbed programs;
* link-level injectors (``degrade_link``, ``link_flap``, ``link_down``)
  retarget port capacities mid-run.  They install as CALL events on the
  packet-family simulators (the sharded loop executes CALLs at global
  barriers, so every lane observes the change atomically) and notify the
  kernel via ``SimKernel.on_chaos`` — wormhole skips affected parked
  partitions back to packet fidelity, hybrid promotes affected flow
  lanes.  Flow-level backends refuse them: they have no port queues to
  degrade, and silently dropping a declared perturbation would be worse.

Injector dicts (all randomness comes from ``numpy.random.default_rng``
seeded with the injector's own ``seed`` — runs are bit-reproducible):

    {"kind": "mice", "seed": 0, "rate": 2000.0, "size": 20000.0,
     "start": 0.0, "duration": 0.01, "cca": "dctcp"}
        Poisson mouse flows (mean interarrival 1/rate) between uniformly
        random distinct hosts.

    {"kind": "straggler", "seed": 0, "count": 2, "factor": 1.5}
    {"kind": "straggler", "ranks": [3, 7], "factor": 1.5}
        Per-rank compute multipliers (workload scenarios only): explicit
        ``ranks``, or ``count`` ranks drawn without replacement.

    {"kind": "degrade_link", "link": 12, "t": 0.002, "factor": 0.25}
        Port 12 drops to 25% capacity at t=2ms; optional ``t_end``
        restores full capacity.

    {"kind": "link_flap", "link": 12, "t_down": 0.002, "t_up": 0.004}
        Capacity collapses to ``DOWN_FACTOR`` x base (arrivals overflow
        the port buffer and drop — the packet-level signature of a dead
        port) and recovers at ``t_up``.

    {"kind": "link_down", "link": 12, "t": 0.002}
        A flap that never recovers; pair with an ``until=`` horizon or a
        workload whose remaining flows avoid the port.

An empty injector list is the identity: no phases are added and nothing
is installed, so ``chaos=[]`` scenarios are bit-identical to pre-chaos
runs.
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

    # ---------------- link-level injectors ---------------- #

    @property
    def has_link_events(self) -> bool:
        return bool(self.link_events)

    def install(self, sim) -> None:
        """Arm the link events on a packet-family simulator as CALL events.

        The hot loops hoist ``_link_bw``/``busy_until`` as the same mutable
        lists, and CALL payloads run with counters flushed, so in-place item
        assignment from the closure is immediately visible — no special
        state on the simulator.
        """
        base = [float(bw) for bw in sim._link_bw]
        for ev in self.link_events:
            if not 0 <= ev.link < len(base):
                raise ValueError(f"chaos link {ev.link} out of range "
                                 f"(topology has {len(base)} ports)")
        for ev in self.link_events:
            sim.call_at(ev.t, _LinkSet(sim, ev.link, base[ev.link] * ev.factor))


class _LinkSet:
    """CALL payload: retarget one port's capacity, preserving the queued
    backlog in bytes, then tell the kernel which port changed."""

    __slots__ = ("sim", "link", "bw")

    def __init__(self, sim, link: int, bw: float) -> None:
        self.sim = sim
        self.link = link
        self.bw = bw

    def __call__(self, now: float) -> None:
        sim = self.sim
        lid = self.link
        old = sim._link_bw[lid]
        if old == self.bw:
            return
        busy = sim.busy_until[lid]
        if busy > now:
            # (busy - now) * old bytes sit queued on the port; re-express
            # that backlog at the new drain rate
            sim.busy_until[lid] = now + (busy - now) * (old / self.bw)
        sim._link_bw[lid] = self.bw
        sim.kernel.on_chaos(now, (lid,))


def plan_for(scenario) -> ChaosPlan | None:
    """Parse a scenario's chaos declaration (None when it has none)."""
    chaos = getattr(scenario, "chaos", None)
    return ChaosPlan.parse(chaos) if chaos else None


def check_backend(plan: ChaosPlan | None, backend: str,
                  intra_workers: int = 1) -> None:
    """Refuse configurations whose engine cannot honor declared link chaos."""
    if plan is None or not plan.link_events:
        return
    if backend in FLOW_LEVEL_BACKENDS:
        raise ValueError(
            f"backend {backend!r} has no port queues to degrade — link chaos "
            "(degrade_link/link_flap/link_down) needs a packet-family "
            "backend (packet/wormhole/hybrid)")
    if intra_workers > 1:
        raise ValueError(
            "link chaos requires intra_workers=1: dispatched lane workers "
            "rebuild port capacities from the pickled topology and would "
            "miss mid-run capacity changes")


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
