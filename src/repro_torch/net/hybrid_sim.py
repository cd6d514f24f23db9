"""Adaptive packet/flow hybrid engine (HyGra-style granularity switching).

Wormhole (``repro_torch.core.wormhole``) parks a partition only once its flows are
*provably* steady — transient-but-smooth traffic still burns full packet
fidelity.  The hybrid backend opens the accuracy/speed axis the pure-packet
engines cannot reach: per-partition granularity control where

* **packet granularity** — the partition runs the existing per-partition
  packet event lanes of :class:`~repro_torch.net.sharded_sim.ShardedPacketSim`
  (the sharded loop's lane machinery is reused verbatim — with
  ``fidelity="packet"`` results are bit-identical to it);
* **flow granularity** — a partition whose flows are rate-stable (but not
  necessarily steady enough for a Wormhole park) is *demoted* to a
  flow-level lane: packets stop, per-flow state advances analytically, and
  the lane is driven by the progressive max-min rate solver
  (:func:`repro_torch.net.flows.maxmin_rates`) — the solver gates demotion
  (measured rates must be consistent with the solved shares, which rejects
  mid-ramp convergence transients) and supplies the relative share updates
  when contention inside the lane changes (a member flow completes).

Demotion/promotion preserve simulation consistency by converting flow state
at the boundary exactly the way Wormhole park/unpark does: demote ==
``PacketSim.park_flows`` (pending events stash as they pop, in-flight bytes
stay frozen in the queues, ``delivered``/``sent`` advance analytically),
promote == ``PacketSim.unpark_flows`` (stashed events re-inject at +ΔT,
port backlogs shift, retx/cwnd state resumes untouched).  Promotion back to
packet granularity happens on any contention-pattern change the flow lane
cannot absorb: a new flow arriving on the partition's ports (merge), or the
``max_demote`` horizon expiring (a probe that re-measures at packet
fidelity).  While at packet granularity, the demotion detector is the
shared steady-state machinery of ``repro_torch.core.steady`` — a partition whose
rate fluctuation leaves the detector's ``atol``/band over the rolling
``demote_after``-sample window simply loses its demotion eligibility until
it re-stabilises.

State machine per partition (cf. Wormhole's UNSTEADY/REPLAY/PARKED):

    form ──(auto: ``demote_after`` stable samples + solver-consistent)──> FLOW
      ^                                                                    │
      │<── promote: flow entry / horizon probe / solver-inconsistent split ┘
      └──── completion inside the lane: re-solve shares, stay FLOW ────────┘

Copy of ``repro.net.hybrid_sim``, which the port may not import.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import theory
from repro_torch.core.partition import PartitionIndex
from repro_torch.core.steady import is_steady, rate_estimate
from repro_torch.net.packet_sim import KERNEL, FlowRT, SimKernel
from repro_torch.net.sharded_sim import ShardedPacketSim

PACKET, FLOW = "packet", "flow"
FIDELITIES = ("packet", "auto", "flow")


@dataclasses.dataclass
class HybridConfig:
    """Granularity-controller knobs (engine opts ``fidelity`` and
    ``demote_after`` override the corresponding fields)."""
    fidelity: str = "auto"         # packet | auto | flow
    demote_after: int = 6          # stable samples before a demotion
    # relative rate-fluctuation band for "rate-stable" (Eq. 6 over the last
    # ``demote_after`` samples).  band_auto lifts it per partition to the
    # CCA's steady sawtooth amplitude (Eq. 11 / steady_eps_hint), as the
    # Wormhole detector does for θ — below that a sawtooth never looks flat.
    band: float = 0.05
    band_auto: bool = True
    band_slack: float = 1.3
    band_cap: float = 0.12
    atol: float = 0.0              # steady detector dead-band (core/steady)
    # a demotion is only taken when the measured rates agree with the
    # max-min solve within this relative band: a mid-ramp flow sits well
    # below its fair share, so the solver check rejects convergence
    # transients that merely *look* flat over a short window
    solver_band: float = 0.15
    max_demote: float = 0.5        # flow-lane dwell bound (s) before a probe
    resolve_on_completion: bool = True   # re-solve + stay FLOW across finishes

    @classmethod
    def from_knobs(cls, knobs: dict) -> "HybridConfig":
        """Build from a scenario ``kernel`` dict, ignoring foreign keys —
        scenarios share one kernel-knob dict across backends (a Wormhole
        scenario's ``theta`` must not break the hybrid engine)."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in knobs.items() if k in known})


@dataclasses.dataclass(slots=True)
class HPart:
    """Granularity-controller state for one live partition."""
    pid: int
    gen: int
    fids: set[int]
    ports: frozenset[int]
    state: str = PACKET
    formed_at: float = 0.0
    samples: int = 0               # detector samples since formation
    band: float = 0.10
    park_t: float = 0.0
    park_delivered: dict[int, float] = dataclasses.field(default_factory=dict)
    # drift confirm (the Wormhole guard against slow convergence ramps that
    # stay inside the band per window yet are not converged): a stable
    # window only *arms* the demotion; it fires half a window later if the
    # fresh means agree with the armed ones
    pending: dict[int, float] | None = None
    confirm_at: int = 0


class HybridKernel(SimKernel):
    """Per-partition granularity controller, plugged into the sharded
    packet loop through the same :class:`SimKernel` seam Wormhole uses."""

    def __init__(self, cfg: HybridConfig | None = None) -> None:
        self.cfg = cfg or HybridConfig()
        if self.cfg.fidelity not in FIDELITIES:
            raise ValueError(f"unknown fidelity {self.cfg.fidelity!r}; "
                             f"have {FIDELITIES}")
        self.index = PartitionIndex()
        self.parts: dict[int, HPart] = {}
        self._gen = 0
        self._corr: dict[int, float] = {}   # measured/solved at demote time
        self._finish_queue: list[int] = []
        self._draining = False
        self.stats = {
            "demotions": 0, "promotions": 0, "resolves": 0, "probes": 0,
            "solves": 0, "solver_rejects": 0, "flow_events": 0,
            "est_events_skipped": 0.0, "flow_lane_seconds": 0.0,
        }

    def attach(self, sim) -> None:
        super().attach(sim)
        sim.window = max(sim.window, self.cfg.demote_after)
        # the sharded sim keys its packet event lanes off this kernel's live
        # PartitionIndex — one lifecycle drives lanes and granularity both
        adopt = getattr(sim, "adopt_partition_index", None)
        if adopt is not None:
            adopt(self.index)

    # ------------------------------------------------------------------ #
    # finish-drain plumbing (the Wormhole pattern: reshapes triggered by
    # completions inside kernel callbacks run after the callback returns)
    # ------------------------------------------------------------------ #
    def _with_drain(self, fn, now: float) -> None:
        if self._draining:
            fn()
            return
        self._draining = True
        try:
            fn()
            while self._finish_queue:
                self._finish_reshape(self._finish_queue.pop(0), now)
        finally:
            self._draining = False

    # ------------------------------------------------------------------ #
    # flow entry: promote affected flow lanes, merge, re-form
    # ------------------------------------------------------------------ #
    def on_flow_start(self, flow: FlowRT) -> None:
        self.on_flows_start([flow])

    def on_flows_start(self, flows: list[FlowRT]) -> None:
        now = self.sim.now
        self._with_drain(lambda: self._admit(flows, now), now)

    def _admit(self, flows: list[FlowRT], now: float) -> None:
        all_ports: set[int] = set()
        for f in flows:
            all_ports |= f.ports
        for pid in self.index.affected_partitions(all_ports):
            part = self.parts.get(pid)
            if part is not None and part.state == FLOW:
                # contention-pattern change: the flow lane's solved shares
                # are stale the moment a new flow lands on these ports
                self._promote(part, now)
        for f in flows:
            _, merged = self.index.add_flow(f.fid, f.ports)
            for pid in merged:
                self.parts.pop(pid, None)
        # sorted: partitions form in pid order, not set order
        for pid in sorted({self.index.flow_pid[f.fid] for f in flows}):
            self._form(pid, self.index.parts[pid], now)

    # ------------------------------------------------------------------ #
    # chaos: port capacity retargeted — solved shares are stale
    # ------------------------------------------------------------------ #
    def on_chaos(self, now: float, ports) -> None:
        """A chaos injector changed these ports' capacities: demoted flow
        lanes solved their shares against the old capacities — promote them
        back to packet fidelity so the detector re-measures (and the solver
        re-solves) under the new regime."""
        affected = set(ports)

        def go() -> None:
            for pid in self.index.affected_partitions(affected):
                part = self.parts.get(pid)
                if part is not None and part.state == FLOW:
                    self._promote(part, now)
        self._with_drain(go, now)

    # ------------------------------------------------------------------ #
    # flow completion: reshape; flow lanes re-solve and stay demoted
    # ------------------------------------------------------------------ #
    def on_flow_finish(self, flow: FlowRT, now: float) -> None:
        self._corr.pop(flow.fid, None)
        self._finish_queue.append(flow.fid)
        if not self._draining:
            self._with_drain(lambda: None, now)

    def _finish_reshape(self, fid: int, now: float) -> None:
        pid = self.index.flow_pid.get(fid)
        if pid is None:
            return
        part = self.parts.get(pid)
        if part is not None:
            if part.state == FLOW:
                # unpark the survivors at the boundary (the canonical
                # Wormhole conversion); the residual partitions inherit the
                # "flow" granularity tag through the index split and are
                # re-demoted at solver-rescaled rates in _form
                self._account_skip(part, now)
                sim = self.sim
                for g in list(part.fids):
                    sim._materialize(sim.flows[g], now)
                alive = [g for g in part.fids if not sim.flows[g].done]
                self.stats["flow_events"] += len(part.fids)
                sim.unpark_flows(alive, part.ports, now, now - part.park_t)
            part.gen = -1
            self.parts.pop(pid, None)
        _, splits = self.index.remove_flow(fid)
        for new_pid, flows in splits:
            self._form(new_pid, flows, now)

    # ------------------------------------------------------------------ #
    # partition formation
    # ------------------------------------------------------------------ #
    def _form(self, pid: int, fids: set[int], now: float) -> None:
        sim = self.sim
        # fids is iterated sorted throughout: every derived ordering (alive,
        # vrates, rate-history resets) is a pure function of the flow ids,
        # never of set-insertion history
        ordered = sorted(fids)
        ports: set[int] = set()
        for fid in ordered:
            ports |= self.index.flow_ports[fid]
        self._gen += 1
        part = HPart(pid=pid, gen=self._gen, fids=set(fids),
                     ports=frozenset(ports), formed_at=now)
        part.band = self._band_for(fids)
        self.parts[pid] = part
        alive = [fid for fid in ordered if not sim.flows[fid].done]
        inherited_flow = (self.index.granularity.get(pid) == FLOW and alive
                          and self.cfg.resolve_on_completion
                          and self.cfg.fidelity != "packet")
        if inherited_flow:
            # completion split of a demoted partition: survivors go straight
            # back into the flow lane at solver-rescaled rates — the solver
            # supplies the new shares, the demote-time measured/solved
            # correction factor carries the CCA's deviation from max-min
            solved = self._solve(part)
            vrates = {}
            for fid in alive:
                f = sim.flows[fid]
                v = self._corr.get(fid, 1.0) * solved.get(fid, f.cca.rate())
                vrates[fid] = min(max(v, 1e-3), f.cca.line_rate)
            self.stats["resolves"] += 1
            self._demote(part, now, vrates)
            return
        self.index.set_granularity(pid, PACKET)
        for fid in ordered:
            f = sim.flows[fid]
            f.rate_hist.clear()
            f.last_sample_delivered = f.delivered
            f.last_sample_t = now
        if self.cfg.fidelity == "flow" and alive:
            # everything rides the flow lane: pure solver rates from t=0
            # (the coarse end of the fidelity axis — analytic-grade error)
            solved = self._solve(part)
            vrates = {fid: max(solved.get(fid, 1e-3), 1e-3) for fid in alive}
            self._demote(part, now, vrates)

    def _band_for(self, fids) -> float:
        cfg = self.cfg
        if not cfg.band_auto:
            return cfg.band
        eps = 0.0
        for fid in fids:
            cca = self.sim.flows[fid].cca
            if cca.steady_eps_hint is not None:
                eps = max(eps, cca.steady_eps_hint)
            else:      # window/sawtooth CCAs: the Eq. 11 amplitude guidance
                crtt = cca.line_rate * cca.base_rtt / self.sim.mtu
                eps = max(eps, theory.dctcp_relative_fluctuation(
                    len(fids), 1.0, crtt, mss=1.0))
        return min(max(cfg.band, cfg.band_slack * eps), cfg.band_cap)

    # ------------------------------------------------------------------ #
    # demotion detector (runs on monitor samples, packet partitions only)
    # ------------------------------------------------------------------ #
    def on_sample(self, now: float) -> None:
        if self.cfg.fidelity != "auto":
            return
        self._with_drain(lambda: self._detect(now), now)

    def _detect(self, now: float) -> None:
        cfg = self.cfg
        sim = self.sim
        for part in list(self.parts.values()):
            if part.state != PACKET or part.pid not in self.parts:
                continue
            flows = [sim.flows[fid] for fid in part.fids]
            if any(not f.started or f.done or f.parked for f in flows):
                continue
            part.samples += 1
            if part.samples < cfg.demote_after:
                continue
            # rolling window: one out-of-band fluctuation and the partition
            # keeps packet granularity (and loses its armed confirm) until
            # the window is clean again
            if not all(is_steady(f.rate_hist, cfg.demote_after, part.band,
                                 cfg.atol) for f in flows):
                part.pending = None
                continue
            means = {f.fid: rate_estimate(f.rate_hist, cfg.demote_after)
                     for f in flows}
            if part.pending is None:
                part.pending = means
                part.confirm_at = part.samples + max(cfg.demote_after // 2, 2)
                continue
            if part.samples < part.confirm_at:
                continue
            prev = part.pending
            drifting = not all(
                fid in prev and abs(m - prev[fid]) <= (part.band / 2)
                * max(m, 1e-9) for fid, m in means.items())
            if drifting:
                # a ramp moved the means across the half window: re-arm
                part.pending = means
                part.confirm_at = part.samples + max(cfg.demote_after // 2, 2)
                continue
            solved = self._solve(part)
            vrates: dict[int, float] = {}
            corr: dict[int, float] = {}
            ok = True
            for f in flows:
                measured = means[f.fid]
                s = solved.get(f.fid, 0.0)
                if abs(measured - s) > cfg.solver_band * max(s, 1e-9):
                    ok = False
                    break
                # stability is judged over the full window, but the lane
                # rate comes from the freshest half: a decelerating ramp
                # tail that slipped past the drift guard still biases the
                # full-window mean low, while the newest samples sit on the
                # converged value
                fresh = rate_estimate(f.rate_hist, max(cfg.demote_after // 2, 2))
                vrates[f.fid] = max(fresh, 1e-3)
                corr[f.fid] = min(max(fresh / max(s, 1e-9), 0.25), 4.0)
            if not ok:
                self.stats["solver_rejects"] += 1
                part.pending = means        # stay armed; re-check as it moves
                part.confirm_at = part.samples + max(cfg.demote_after // 2, 2)
                continue
            self._corr.update(corr)
            self._demote(part, now, vrates)

    def _solve(self, part: HPart) -> dict[int, float]:
        """Max-min shares for the partition's live flows, straight off the
        sim's struct-of-arrays :class:`~repro_torch.net.soa.FlowTable` (iteration
        order matches the historical ``{fid: path}`` dict comprehension, so
        the solver's link tie-breaks — and every downstream vrate — are
        bit-identical to the dict-solver era)."""
        sim = self.sim
        self.stats["solves"] += 1
        flows = sim.flows
        # _link_bw, not topo.link_bw: chaos injectors retarget port
        # capacities mid-run, and a post-chaos demotion must solve against
        # what the port actually drains now (same float values when no
        # injector fired)
        return sim.flow_table.solve_rates(
            (fid for fid in part.fids if not flows[fid].done),
            sim._link_bw)

    # ------------------------------------------------------------------ #
    # granularity transitions
    # ------------------------------------------------------------------ #
    def _demote(self, part: HPart, now: float, vrates: dict[int, float]) -> None:
        """packet -> flow: park the partition's flows at the given analytic
        rates and schedule the lane horizon (earliest virtual completion,
        bounded by ``max_demote``)."""
        sim = self.sim
        part.state = FLOW
        part.park_t = now
        part.park_delivered = {fid: sim.flows[fid].delivered
                               for fid in part.fids}
        self.index.set_granularity(part.pid, FLOW)
        alive = [fid for fid in part.fids if not sim.flows[fid].done]
        sim.park_flows(alive, now, vrates)
        self.stats["demotions"] += 1
        self.stats["flow_events"] += len(alive)
        # in "flow" fidelity there is no packet-level detector to hand the
        # partition back to, so the max_demote re-measure probe would strand
        # it at packet granularity forever — the lane runs to its virtual
        # completions (entries still promote-and-re-demote through _admit)
        horizon = (math.inf if self.cfg.fidelity == "flow"
                   else now + self.cfg.max_demote)
        for fid in alive:
            f = sim.flows[fid]
            if not f.done:
                horizon = min(horizon, sim.virtual_completion(f))
        self._gen += 1
        part.gen = self._gen
        sim.schedule(max(horizon, now + 1e-9), KERNEL,
                     ("hybrid", part.pid, part.gen))

    def _promote(self, part: HPart, now: float) -> None:
        """flow -> packet: materialize analytic state at ``now`` and resume
        packet simulation (stashed events re-inject at +ΔT, port backlogs
        shift — ``unpark_flows``), then re-arm the demotion detector."""
        sim = self.sim
        self._account_skip(part, now)
        for fid in list(part.fids):
            sim._materialize(sim.flows[fid], now)
        alive = [fid for fid in part.fids if not sim.flows[fid].done]
        self.stats["flow_events"] += len(part.fids)
        sim.unpark_flows(alive, part.ports, now, now - part.park_t)
        part.state = PACKET
        part.samples = 0
        part.formed_at = now
        if part.pid in self.index.parts:
            self.index.set_granularity(part.pid, PACKET)
        for fid in part.fids:
            self._corr.pop(fid, None)
            f = sim.flows[fid]
            f.rate_hist.clear()
            f.last_sample_delivered = f.delivered
            f.last_sample_t = now
        self.stats["promotions"] += 1

    # ------------------------------------------------------------------ #
    # flow-lane horizon (virtual completion or max_demote probe)
    # ------------------------------------------------------------------ #
    def on_kernel_event(self, now: float, payload) -> None:
        kind, pid, gen = payload
        part = self.parts.get(pid)
        if part is None or part.gen != gen or part.state != FLOW:
            return
        self._with_drain(lambda: self._horizon(part, now), now)

    def _horizon(self, part: HPart, now: float) -> None:
        sim = self.sim
        for fid in list(part.fids):
            sim._materialize(sim.flows[fid], now)
        self.stats["flow_events"] += len(part.fids)
        if any(sim.flows[fid].done for fid in part.fids):
            return     # completion reshape (drain) re-solves the survivors
        # max_demote dwell bound: promote and re-measure at packet fidelity
        self.stats["probes"] += 1
        self._promote(part, now)

    # ------------------------------------------------------------------ #
    def _account_skip(self, part: HPart, now: float) -> None:
        """Events the flow lane avoided, estimated exactly as Wormhole does
        (bytes analytically advanced x per-MTU hop/ack event cost)."""
        sim = self.sim
        for fid in part.fids:
            f = sim.flows[fid]
            end = min(now, f.finish_t) if f.done else now
            self.stats["flow_lane_seconds"] += max(0.0, end - part.park_t)
            prev = part.park_delivered.get(fid, f.delivered)
            cur = f.spec.size if f.done else (
                f.delivered + max(0.0, (min(now, sim.now) - f.park_t)) * f.vrate)
            adv = max(0.0, min(cur, f.spec.size) - prev)
            self.stats["est_events_skipped"] += (adv / sim.mtu) * (len(f.path) + 3)

    def report(self) -> dict:
        out = dict(self.stats)
        out["fidelity"] = self.cfg.fidelity
        out["events_processed"] = self.sim.events_processed
        out["partitions"] = self._gen
        out["flow_partitions_live"] = sum(
            1 for p in self.parts.values() if p.state == FLOW)
        return out


class HybridSim(ShardedPacketSim):
    """Sharded packet loop + per-granularity event accounting.  With no
    kernel (``fidelity="packet"``) this *is* the sharded serial loop — the
    counters are the only addition, so results stay bit-identical."""

    # hot class (reprolint H205/C304)
    __slots__ = ("packet_lane_events",)

    def __init__(self, topo, kernel=None, **knobs) -> None:
        super().__init__(topo, kernel=kernel, **knobs)
        self.packet_lane_events = 0

    # every packet-kind execution funnels through these four handlers, in
    # the serial lane loops and in serial redos alike
    def _do_send(self, t, *a) -> None:
        self.packet_lane_events += 1
        super()._do_send(t, *a)

    def _do_arrive(self, t, *a) -> None:
        self.packet_lane_events += 1
        super()._do_arrive(t, *a)

    def _do_ack(self, t, *a) -> None:
        self.packet_lane_events += 1
        super()._do_ack(t, *a)

    def _do_loss(self, t, *a) -> None:
        self.packet_lane_events += 1
        super()._do_loss(t, *a)

    def _merge(self, lanes, results) -> None:
        # worker-executed events are packet-kind by construction (workers
        # only run lane heaps); fold their counts in at merge time
        before = self.events_processed
        super()._merge(lanes, results)
        self.packet_lane_events += self.events_processed - before

    def granularity_report(self) -> dict:
        rep = {
            "packet_lane_events": self.packet_lane_events,
            "flow_lane_events": 0,
            "demotions": 0, "promotions": 0, "resolves": 0, "probes": 0,
            "est_events_skipped": 0.0, "flow_lane_seconds": 0.0,
        }
        if isinstance(self.kernel, HybridKernel):
            st = self.kernel.stats
            rep.update(
                flow_lane_events=st["flow_events"],
                demotions=st["demotions"], promotions=st["promotions"],
                resolves=st["resolves"], probes=st["probes"],
                est_events_skipped=st["est_events_skipped"],
                flow_lane_seconds=st["flow_lane_seconds"])
        return rep
