"""Wormhole kernel (paper Fig. 6 workflow) — plugs into PacketSim.

Per-partition state machine:

    form ──memo hit──> REPLAY ──T_conv──> STEADY (stored FCG_end rates)
      │                                      │
      └─miss──> UNSTEADY ──ΔR_l<θ (all)──> STEADY ──interrupt──> reshape/form
                   │  (insert on first steady / completion)        │
                   └──────────────── completion ───────────────────┘

Interrupts (§5.3): ① flow entry (real-time ⇒ skip-back: lazy materialization
at the interrupt's own timestamp), ② flow completion (scheduled as the park
horizon = earliest virtual completion), ③ reroute (exposed as remove+add).

Copy of ``repro.core.wormhole``, which the port may not import.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.core import theory
from repro_torch.core.fcg import FCG, build_fcg
from repro_torch.core.memo import COMPLETION as R_COMPLETION
from repro_torch.core.memo import STEADY as R_STEADY
from repro_torch.core.memo import MemoEntry, MemoHit, SimDB, sim_fingerprint
from repro_torch.core.partition import PartitionIndex
from repro_torch.core.steady import is_steady, rate_estimate
from repro_torch.net.packet_sim import KERNEL, FlowRT, PacketSim, SimKernel

UNSTEADY, REPLAY, PARKED = 0, 1, 2


@dataclasses.dataclass
class WormholeConfig:
    theta: float = 0.05            # fluctuation threshold (paper default, §7)
    # Per-partition adaptive θ from the paper's own guidance (Eq. 11):
    # θ_p = max(theta, theta_slack · sqrt(7·N_p / (16·C·RTT))) — below the
    # steady sawtooth amplitude the detector can never fire (§5.2).
    theta_auto: bool = True
    theta_slack: float = 1.3
    theta_cap: float = 0.30
    window: int = 32               # detection interval l cap (samples)
    # Per-partition l from Eq. 13: the window span must cover ≥2 sawtooth
    # periods T_C; shorter partitions detect sooner, longer never exceed cap.
    window_auto: bool = True
    window_min: int = 8
    metric: str = "rate"           # rate | inflight | qlen  (Fig 13a)
    enable_memo: bool = True
    enable_steady: bool = True
    max_skip: float = 0.5          # horizon refresh bound (s)
    min_flows_memo: int = 1
    # Beyond-paper robustness: a slow monotone ramp drifts < θ per window yet
    # is not converged (Eq. 5 assumes CCA convergence).  Require a second,
    # half-window-later check whose window mean agrees within θ/2 before
    # parking.  Disable for the paper-faithful detector.
    confirm: bool = True


@dataclasses.dataclass(slots=True)
class Part:
    pid: int
    gen: int
    fids: set[int]
    ports: frozenset[int]
    state: int = UNSTEADY
    formed_at: float = 0.0
    samples: int = 0
    entry_delivered: dict[int, float] = dataclasses.field(default_factory=dict)
    fcg: FCG | None = None
    miss: bool = False
    hit: MemoHit | None = None
    park_t: float = 0.0
    park_delivered: dict[int, float] = dataclasses.field(default_factory=dict)
    pending_means: dict[int, float] | None = None
    confirm_at: int = 0
    theta: float = 0.05
    window: int = 32


class WormholeKernel(SimKernel):
    def __init__(self, cfg: WormholeConfig | None = None, db: SimDB | None = None) -> None:
        self.cfg = cfg or WormholeConfig()
        self.db = db if db is not None else SimDB()
        self.index = PartitionIndex()
        self.parts: dict[int, Part] = {}
        self.metric_hist: dict[int, deque] = {}
        self._gen = 0
        self._finish_queue: deque[int] = deque()
        self._draining = False
        self.stats = {
            "parks": 0, "replays": 0, "skip_backs": 0, "unparks": 0,
            "est_events_skipped": 0.0, "skipped_flow_seconds": 0.0,
            "steady_flow_seconds": 0.0,
        }
        self.flow_steady_time: dict[int, float] = {}

    def attach(self, sim: PacketSim) -> None:
        super().attach(sim)
        sim.window = max(sim.window, self.cfg.window)
        # a DB recorded under one MTU/ECN/buffer/sampling regime must never
        # be replayed under another — bind (or verify) the fingerprint
        self.db.bind_fingerprint(sim_fingerprint(
            sim.mtu, sim.ecn_k, sim.buffer_bytes, sim.shared_buffer,
            sim.sample_interval if sim.sample_interval_explicit else None))
        # a partition-sharded sim keys its event lanes off this kernel's
        # live PartitionIndex — one lifecycle drives both (no shadow index)
        adopt = getattr(sim, "adopt_partition_index", None)
        if adopt is not None:
            adopt(self.index)

    # ------------------------------------------------------------------ #
    # interrupt ①: flow entry (merge + skip-back for parked partitions)
    # ------------------------------------------------------------------ #
    def on_flow_start(self, flow: FlowRT) -> None:
        self.on_flows_start([flow])

    def on_flows_start(self, flows: list[FlowRT]) -> None:
        """Batch admission: flows launched at the same instant (one
        collective call) form their partitions in one step, so the memoized
        FCG is the whole collective's conflict graph rather than a chain of
        partial ones."""
        now = self.sim.now
        self._with_drain(lambda: self._admit(flows, now), now)

    def _admit(self, flows: list[FlowRT], now: float) -> None:
        all_ports: set[int] = set()
        for f in flows:
            all_ports |= f.ports
        for pid in self.index.affected_partitions(all_ports):
            part = self.parts.get(pid)
            if part is not None and part.state != UNSTEADY:
                self._skip_back(part, now)
        for f in flows:
            _, merged = self.index.add_flow(f.fid, f.ports)
            for pid in merged:
                self.parts.pop(pid, None)
        final_pids = {self.index.flow_pid[f.fid] for f in flows}
        # sorted: partitions form (and schedule their first sample) in pid
        # order, not set order
        for pid in sorted(final_pids):
            self._form(pid, self.index.parts[pid], now)

    def _skip_back(self, part: Part, now: float) -> None:
        """Real-time interrupt at t2 < parked horizon t1: materialize the
        partition's analytic state at t2 and resume packet simulation (§6.3)."""
        self._account_skip(part, now)
        alive = [fid for fid in part.fids if not self.sim.flows[fid].done]
        self.sim.unpark_flows(alive, part.ports, now, now - part.park_t)
        part.state = UNSTEADY
        part.gen = -1  # orphan any pending UNPARK
        part.samples = 0
        self.stats["skip_backs"] += 1

    # ------------------------------------------------------------------ #
    # interrupt ①b: chaos (port capacity retargeted under live partitions)
    # ------------------------------------------------------------------ #
    def on_chaos(self, now: float, ports) -> None:
        """A chaos injector changed these ports' capacities: any parked or
        replaying partition touching them holds stale steady rates (and a
        memo match recorded under the old capacity) — skip back to packet
        fidelity and re-measure under the new regime."""
        affected = set(ports)

        def go() -> None:
            for pid in self.index.affected_partitions(affected):
                part = self.parts.get(pid)
                if part is not None and part.state != UNSTEADY:
                    self._skip_back(part, now)
        self._with_drain(go, now)

    # ------------------------------------------------------------------ #
    # interrupt ②: flow completion (reshape + possible split)
    # ------------------------------------------------------------------ #
    def on_flow_finish(self, flow: FlowRT, now: float) -> None:
        self._finish_queue.append(flow.fid)
        if not self._draining:
            self._with_drain(lambda: None, now)

    def _with_drain(self, fn, now: float) -> None:
        if self._draining:
            fn()
            return
        self._draining = True
        try:
            fn()
            while self._finish_queue:
                self._finish_reshape(self._finish_queue.popleft(), now)
        finally:
            self._draining = False

    def _finish_reshape(self, fid: int, now: float) -> None:
        pid = self.index.flow_pid.get(fid)
        if pid is None:
            return
        part = self.parts.get(pid)
        if part is not None:
            if part.state != UNSTEADY:
                # completion surfaced while parked (e.g. drained bytes at a
                # replay park): materialize + resume the residual flows
                self._account_skip(part, now)
                for g in list(part.fids):
                    self.sim._materialize(self.sim.flows[g], now)
                alive = [g for g in part.fids if not self.sim.flows[g].done]
                self.sim.unpark_flows(alive, part.ports, now, now - part.park_t)
                part.state = UNSTEADY
            elif (part.miss and self.cfg.enable_memo
                    and part.fcg is not None and now > part.formed_at):
                self._memo_insert(part, now, R_COMPLETION)
                part.miss = False
            part.gen = -1
            self.parts.pop(pid, None)
        _, splits = self.index.remove_flow(fid)
        for new_pid, flows in splits:
            self._form(new_pid, flows, now)

    # ------------------------------------------------------------------ #
    # partition formation: memo query (Fig 6 steps ①②③)
    # ------------------------------------------------------------------ #
    def _form(self, pid: int, fids: set[int], now: float) -> None:
        sim = self.sim
        # fids is iterated sorted throughout: every derived ordering
        # (entry_delivered, metric_hist insertion) is a pure function of the
        # flow ids, never of set-insertion history
        ordered = sorted(fids)
        ports: set[int] = set()
        for fid in ordered:
            ports |= self.index.flow_ports[fid]
        self._gen += 1
        part = Part(pid=pid, gen=self._gen, fids=set(fids), ports=frozenset(ports),
                    formed_at=now,
                    entry_delivered={fid: sim.flows[fid].delivered
                                     for fid in ordered})
        part.theta = self._theta_for(fids)
        part.window = self._window_for(fids)
        self.parts[pid] = part
        for fid in ordered:
            f = sim.flows[fid]
            f.rate_hist.clear()
            f.last_sample_delivered = f.delivered
            f.last_sample_t = now
            self.metric_hist[fid] = deque(maxlen=self.cfg.window)

        if self.cfg.enable_memo and len(fids) >= self.cfg.min_flows_memo:
            part.fcg = self._build_fcg(part)
            remaining = [sim.flows[fid].remaining() for fid in part.fcg.fids]
            hit = self.db.lookup(part.fcg, remaining, atol=2 * sim.mtu)
            if hit is not None:
                self._apply_hit(part, hit, now)
                return
            part.miss = True

    def _theta_for(self, fids) -> float:
        cfg = self.cfg
        if not cfg.theta_auto:
            return cfg.theta
        # Eq. 11 is the DCTCP sawtooth guidance; other CCAs carry their own
        # steady-oscillation hint (the drift guard below keeps slow
        # convergence ramps from being admitted by a loose θ — before it,
        # DCQCN DP flows parked mid-ramp with 42% FCT error; §Perf notes).
        eps = 0.0
        for fid in fids:
            cca = self.sim.flows[fid].cca
            if cca.steady_eps_hint is not None:
                eps = max(eps, cca.steady_eps_hint)
            else:  # window/sawtooth CCAs (dctcp, hpcc): Eq. 11 guidance
                crtt = cca.line_rate * cca.base_rtt / self.sim.mtu
                eps = max(eps, theory.dctcp_relative_fluctuation(
                    len(fids), 1.0, crtt, mss=1.0))
        return min(max(cfg.theta, cfg.theta_slack * eps), cfg.theta_cap)

    def _window_for(self, fids) -> int:
        cfg = self.cfg
        if not cfg.window_auto:
            return cfg.window
        sim = self.sim
        f0 = sim.flows[next(iter(fids))]
        l = theory.l_guidance(len(fids), f0.cca.line_rate, f0.cca.base_rtt,
                              sim.ecn_k, sim.sample_interval, mss=sim.mtu)
        return min(max(l, cfg.window_min), cfg.window)

    def _build_fcg(self, part: Part) -> FCG:
        sim = self.sim
        fids = sorted(part.fids)
        # line-rate labels come from the *live* capacities, not the flow's
        # add-time cca.line_rate: after a chaos capacity retarget the same
        # flow pattern is a different regime and must miss entries recorded
        # under the old rates.  Without chaos _link_bw holds exactly
        # float(topo.link_bw[p]), so keys are unchanged bit-for-bit.
        return build_fcg(
            fids, {fid: self.index.flow_ports[fid] for fid in fids},
            rates={fid: sim.flows[fid].cca.rate() for fid in fids},
            line_rates={fid: min(sim._link_bw[p] for p in sim.flows[fid].path)
                        for fid in fids},
            ccas={fid: sim.flows[fid].spec.cca for fid in fids},
            rtts={fid: sim.flows[fid].cca.base_rtt for fid in fids},
        )

    def _apply_hit(self, part: Part, hit: MemoHit, now: float) -> None:
        """Fast-forward the transient: replay the stored per-flow transfer
        volumes over T_conv, then jump to the stored FCG_end (§4.4)."""
        sim = self.sim
        e = hit.entry
        t_conv = max(e.t_conv, 1e-9)
        vrates = {}
        for u, v in hit.mapping.items():
            fid = part.fcg.fids[v]
            vrates[fid] = max(e.sizes[u], 1.0) / t_conv
        part.state = REPLAY
        part.hit = hit
        part.park_t = now
        part.park_delivered = {fid: sim.flows[fid].delivered for fid in part.fids}
        sim.park_flows(list(part.fids), now, vrates)
        sim.schedule(now + t_conv, KERNEL, ("unpark", part.pid, part.gen))
        self.stats["replays"] += 1

    # ------------------------------------------------------------------ #
    # steady-state detection (Fig 6 step ④⑤) — runs on monitor samples
    # ------------------------------------------------------------------ #
    def on_sample(self, now: float) -> None:
        sim = self.sim
        cfg = self.cfg
        for fid, f in sim.flows.items():
            if not f.started or f.done or f.parked:
                continue
            hist = self.metric_hist.get(fid)
            if hist is None:
                continue
            if cfg.metric == "rate":
                if f.rate_hist:
                    hist.append(f.rate_hist[-1])
            elif cfg.metric == "inflight":
                hist.append(f.inflight)
            elif cfg.metric == "qlen":
                # _link_bw is the sim's plain-float list cache of
                # topo.link_bw — same IEEE doubles, no ndarray scalar boxing
                hist.append(max((max(0.0, (sim.busy_until[p] - now)) * sim._link_bw[p]
                                 for p in f.path), default=0.0))
            else:
                raise ValueError(f"unknown metric {cfg.metric!r}")
        if not cfg.enable_steady:
            return
        self._with_drain(lambda: self._detect(now), now)

    def _detect(self, now: float) -> None:
        cfg = self.cfg
        sim = self.sim
        for part in list(self.parts.values()):
            if part.state != UNSTEADY or part.pid not in self.parts:
                continue
            part.samples += 1
            if part.samples < part.window:
                continue
            flows = [sim.flows[fid] for fid in part.fids]
            if any(not f.started or f.done or f.parked for f in flows):
                continue
            atol = 2 * sim.mtu if cfg.metric == "qlen" else 0.0
            if not all(is_steady(self.metric_hist[f.fid], part.window, part.theta,
                                 atol)
                       for f in flows):
                part.pending_means = None
                continue
            if not cfg.confirm:
                self._enter_steady(part, now)
                continue
            means = {f.fid: rate_estimate(f.rate_hist, part.window) for f in flows}
            if part.pending_means is None:
                part.pending_means = means
                part.confirm_at = part.samples + max(part.window // 2, 2)
            elif part.samples >= part.confirm_at:
                prev = part.pending_means
                tot_now = sum(means.values())
                tot_prev = sum(prev.get(fid, m) for fid, m in means.items())
                # partition-level drift: a slow convergence ramp moves every
                # flow the same way; steady oscillation does not
                drifting = abs(tot_now - tot_prev) > (part.theta / 6) * max(tot_now, 1e-9)
                if not drifting and all(
                        fid in prev and abs(m - prev[fid]) <= (part.theta / 2) * max(m, 1e-9)
                        for fid, m in means.items()):
                    self._enter_steady(part, now)
                else:
                    part.pending_means = means
                    part.confirm_at = part.samples + max(part.window // 2, 2)

    def _enter_steady(self, part: Part, now: float) -> None:
        sim = self.sim
        vrates = {fid: max(rate_estimate(sim.flows[fid].rate_hist, part.window), 1e-3)
                  for fid in part.fids}
        if part.miss and self.cfg.enable_memo and part.fcg is not None:
            self._memo_insert(part, now, R_STEADY, vrates)
            part.miss = False
        self._park(part, now, vrates)

    def _park(self, part: Part, now: float, vrates: dict[int, float]) -> None:
        sim = self.sim
        part.state = PARKED
        part.park_t = now
        part.park_delivered = {fid: sim.flows[fid].delivered for fid in part.fids}
        sim.park_flows(list(part.fids), now, vrates)
        horizon = now + self.cfg.max_skip
        for fid in part.fids:
            f = sim.flows[fid]
            if not f.done:
                horizon = min(horizon, sim.virtual_completion(f))
        self._gen += 1
        part.gen = self._gen
        sim.schedule(max(horizon, now + 1e-9), KERNEL, ("unpark", part.pid, part.gen))
        self.stats["parks"] += 1

    def _memo_insert(self, part: Part, now: float, reason: str,
                     vrates: dict[int, float] | None = None) -> None:
        sim = self.sim
        fcg = part.fcg
        sizes, end_rates, completed = [], [], []
        for v, fid in enumerate(fcg.fids):
            f = sim.flows[fid]
            sizes.append(f.delivered - part.entry_delivered.get(fid, 0.0))
            end_rates.append(vrates[fid] if vrates else f.cca.rate())
            if f.done:
                completed.append(v)
        backlogs = [max(0.0, (sim.busy_until[p] - now)) * sim._link_bw[p]
                    for p in part.ports]
        shared = [b for b in backlogs if b > 0]
        self.db.insert(MemoEntry(
            fcg=fcg, end_rates=end_rates, sizes=sizes,
            t_conv=max(now - part.formed_at, 1e-9), end_reason=reason,
            mean_backlog=(sum(shared) / len(shared)) if shared else 0.0,
            completed=tuple(completed),
        ))

    # ------------------------------------------------------------------ #
    # park horizon reached (Fig 6 steps ⑥⑦: interrupts + re-partition)
    # ------------------------------------------------------------------ #
    def on_kernel_event(self, now: float, payload) -> None:
        kind, pid, gen = payload
        part = self.parts.get(pid)
        if part is None or part.gen != gen or part.state == UNSTEADY:
            return
        self._with_drain(lambda: self._unpark(part, now), now)

    def _unpark(self, part: Part, now: float) -> None:
        sim = self.sim
        was_replay = part.state == REPLAY
        self._account_skip(part, now)
        for fid in list(part.fids):
            sim._materialize(sim.flows[fid], now)   # finishes enqueue on the drain
        alive = [fid for fid in part.fids if not sim.flows[fid].done]
        sim.unpark_flows(alive, part.ports, now, now - part.park_t)
        self.stats["unparks"] += 1

        if was_replay and part.hit is not None:
            e = part.hit.entry
            # jump to FCG_end: converged CCA state + frozen contention queues
            for u, v in part.hit.mapping.items():
                fid = part.fcg.fids[v]
                f = sim.flows[fid]
                if f.done:
                    continue
                f.cca.r = max(e.end_rates[u], 1e-3)
                if f.cca.window_based:
                    # w is the control variable: set it so w/srtt == r
                    f.cca.w = f.cca.r * max(f.cca.srtt, f.cca.base_rtt)
                # rate-based CCAs (DCQCN/TIMELY) keep w as a loose in-flight
                # cap — shrinking it to r*srtt would pin the flow at its
                # parked rate after the fast-forward
            if e.mean_backlog > 0:
                port_users: dict[int, int] = {}
                for fid in alive:
                    for p in sim.flows[fid].path:
                        port_users[p] = port_users.get(p, 0) + 1
                for p, cnt in port_users.items():
                    if cnt >= 2:
                        sim.busy_until[p] = max(
                            sim.busy_until[p],
                            now + e.mean_backlog / sim._link_bw[p])
            if e.end_reason == R_STEADY and self.cfg.enable_steady and alive:
                vrates = {}
                ok = True
                for u, v in part.hit.mapping.items():
                    fid = part.fcg.fids[v]
                    if fid in alive:
                        vrates[fid] = max(e.end_rates[u], 1e-3)
                        h = self.metric_hist.get(fid)
                        if h is not None:
                            h.extend([vrates[fid]] * self.cfg.window)
                    elif sim.flows[fid].done:
                        ok = False  # unexpected completion → re-detect
                if ok and len(vrates) == len(alive):
                    self._park(part, now, vrates)
                    return
        part.state = UNSTEADY
        part.formed_at = now
        part.samples = 0

    def _account_skip(self, part: Part, now: float) -> None:
        sim = self.sim
        steady = part.state == PARKED
        for fid in part.fids:
            f = sim.flows[fid]
            end = min(now, f.finish_t) if f.done else now
            d = max(0.0, end - part.park_t)
            self.stats["skipped_flow_seconds"] += d
            if steady:
                self.stats["steady_flow_seconds"] += d
                self.flow_steady_time[fid] = self.flow_steady_time.get(fid, 0.0) + d
            prev = part.park_delivered.get(fid, f.delivered)
            cur = f.spec.size if f.done else (
                f.delivered + max(0.0, (min(now, sim.now) - f.park_t)) * f.vrate)
            adv = max(0.0, min(cur, f.spec.size) - prev)
            self.stats["est_events_skipped"] += (adv / sim.mtu) * (len(f.path) + 3)

    # ------------------------------------------------------------------ #
    def report(self) -> dict:
        out = dict(self.stats)
        out.update({f"db_{k}": v for k, v in self.db.stats().items()})
        out["events_processed"] = self.sim.events_processed
        out["partitions"] = self._gen
        return out
