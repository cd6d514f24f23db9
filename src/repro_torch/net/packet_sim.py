"""Packet-level discrete-event simulation oracle (the "ns-3 stand-in").

Faithful per-packet, per-hop event processing with FIFO ports, ECN marking at
threshold K, buffer drops, per-ACK CCA state machines and INT telemetry for
HPCC.  The event loop exposes a *kernel* plug-in interface — a no-op kernel
gives baseline ns-3 behavior, Wormhole (repro_torch.core.wormhole) layers
partitioning + memoization + fast-forwarding on top **without the workload
noticing** ("user-transparent", §1).

Mechanism hooks mirroring the paper's implementation (§6):
  * ``park_flows`` / ``unpark_flows``: packet pausing + per-partition
    timestamp offsetting.  A parked flow's pending events are stashed when
    they pop and re-injected at +ΔT on unpark (with their RTT-measurement
    timestamps shifted too); in-flight packets therefore resume seamlessly —
    no restart burst.  Port ``busy_until`` is shifted by the same ΔT so
    buffer occupancy is held constant across the skip (§6.2).  The global
    clock is never touched, only partition-local timestamps (§6.3).
  * the paper's "size and sequence number must be modified accordingly"
    (§6.3) is the analytic advance in ``_materialize``: ``delivered`` and
    ``sent`` both slide forward by R̂·Δt (capped so the frozen in-flight
    window keeps representing the newest unacked bytes).
  * skip-back (§6.3) is lazy: a parked partition's state is an analytic
    function of time, so an earlier-than-expected interrupt simply
    materializes state at its own timestamp — exact by construction.

Copy of ``repro.net.packet_sim``, which the port may not import.  The
reference's partition-sharded loop (``repro.net.sharded_sim``), for which
the handlers below keep their authoritative copies, is not ported yet.
"""
from __future__ import annotations

import gc
import heapq
from collections import deque
from dataclasses import dataclass, field
from collections.abc import Callable

from repro_torch.hotpath import hot_path
from repro_torch.net.cca import CCA, MTU, INTInfo, make_cca
from repro_torch.net.flows import FlowResult, FlowSpec
from repro_torch.net.soa import FlowTable
from repro_torch.net.topology import Topology

# event kinds
START, SEND, ARRIVE, ACK, LOSS, SAMPLE, KERNEL, CALL = range(8)


class SimKernel:
    """No-op kernel == plain packet-level DES (the ns-3 baseline)."""

    def attach(self, sim: PacketSim) -> None:
        self.sim = sim

    def on_flow_start(self, flow: FlowRT) -> None: ...

    def on_flows_start(self, flows: list[FlowRT]) -> None:
        # flows launched at the same instant (one collective) are announced
        # together so a kernel can treat them as one partition event
        for f in flows:
            self.on_flow_start(f)

    def on_flow_finish(self, flow: FlowRT, now: float) -> None: ...
    def on_sample(self, now: float) -> None: ...
    def on_kernel_event(self, now: float, payload) -> None: ...

    def on_chaos(self, now: float, ports) -> None:
        # a chaos injector retargeted these ports' capacities
        # (repro_torch.net.chaos); adaptive kernels re-measure affected partitions
        ...


@dataclass(slots=True)
class FlowRT:
    spec: FlowSpec
    path: list[int]                      # port ids src->dst
    ports: frozenset[int]
    cca: CCA
    ack_delay: float                     # reverse-path propagation
    started: bool = False
    done: bool = False
    start_actual: float = 0.0
    finish_t: float = 0.0
    sent_new: float = 0.0                # unique bytes handed to the wire
    delivered: float = 0.0               # bytes that reached the receiver
    inflight: float = 0.0
    retx: float = 0.0                    # bytes queued for retransmission
    blocked: bool = False
    send_scheduled: bool = False
    last_ack_t: float = 0.0
    # Wormhole bookkeeping ------------------------------------------------
    parked: bool = False
    epoch: int = 0
    void_before: int = 0                 # events from epochs < this are dead
    cum_shift: float = 0.0               # total timestamp offset applied
    shift_at_epoch: dict[int, float] = field(default_factory=dict)
    paused_events: list = field(default_factory=list)
    vrate: float = 0.0                   # analytic steady rate while parked
    park_t: float = 0.0                  # when analytic advance started
    # monitoring -----------------------------------------------------------
    rate_hist: deque = field(default_factory=deque)
    last_sample_delivered: float = 0.0
    last_sample_t: float = 0.0
    int_prev: dict = field(default_factory=dict)  # HPCC per-hop (txBytes, ts)
    rtt_samples: list = field(default_factory=list)  # (t, rtt) if recorded

    @property
    def fid(self) -> int:
        return self.spec.fid

    def remaining(self) -> float:
        return max(0.0, self.spec.size - self.delivered)


class PacketSim:
    # hot class (reprolint H205/C304): every per-event attribute store is a
    # slot write, never an instance-__dict__ store
    __slots__ = (
        "topo", "mtu", "ecn_k", "buffer_bytes", "window", "shared_buffer",
        "busy_until", "port_txbytes", "_link_bw", "_link_delay", "_link_src",
        "flow_table", "now", "events_processed", "packet_hop_events",
        "timeouts", "flows", "results", "_heap", "_seq",
        "sample_interval_explicit", "sample_interval", "kernel",
        "finish_listeners", "_sample_pending", "time_limit",
        "record_rtt_fids",
    )

    def __init__(
        self,
        topo: Topology,
        kernel: SimKernel | None = None,
        mtu: float = MTU,
        ecn_k: float = 64_000.0,          # bytes
        buffer_bytes: float = 512_000.0,  # per-port
        sample_interval: float | None = None,
        window: int = 16,                 # rate-history length l
        shared_buffer: float | None = None,  # per-switch shared pool (optional)
    ) -> None:
        self.topo = topo
        self.mtu = mtu
        self.ecn_k = ecn_k
        self.buffer_bytes = buffer_bytes
        self.window = window
        self.shared_buffer = shared_buffer
        # struct-of-arrays port state, plain Python lists: the hot handlers
        # index these per packet hop, and a list read returns a float where
        # an ndarray read allocates a fresh np scalar (same IEEE doubles —
        # results stay bit-identical, the allocation and boxing go away)
        self.busy_until = [0.0] * topo.n_links
        self.port_txbytes = [0.0] * topo.n_links   # INT counters
        self._link_bw = [float(v) for v in topo.link_bw]
        self._link_delay = [float(v) for v in topo.link_delay]
        self._link_src = [int(v) for v in topo.link_src]
        self.flow_table = FlowTable()
        self.now = 0.0
        self.events_processed = 0
        self.packet_hop_events = 0
        self.timeouts = 0
        self.flows: dict[int, FlowRT] = {}
        self.results: dict[int, FlowResult] = {}
        self._heap: list = []
        # plain-int tie-break counter (next value to use); an itertools
        # counter costs a C call per event on the hottest line in the sim
        self._seq = 0
        min_bw = float(topo.link_bw.min())
        # remembered for the SimDB regime fingerprint: an explicit override
        # changes the steady-detector cadence, the derived default does not
        self.sample_interval_explicit = sample_interval is not None
        self.sample_interval = sample_interval if sample_interval is not None else max(
            8e-6, 24 * mtu / min_bw)
        self.kernel = kernel or SimKernel()
        self.kernel.attach(self)   # reads the sim knobs above
        self.finish_listeners: list[Callable[[FlowRT, float], None]] = []
        self._sample_pending = False
        self.time_limit = float("inf")
        self.record_rtt_fids: set[int] = set()

    # ------------------------------------------------------------------ #
    # scheduling
    # ------------------------------------------------------------------ #
    def schedule(self, t: float, kind: int, *payload) -> None:
        s = self._seq
        self._seq = s + 1
        heapq.heappush(self._heap, (max(t, self.now), s, kind, payload))

    def call_at(self, t: float, fn) -> None:
        """Run ``fn(now)`` at simulated time t (workload-driver timers —
        compute barriers between communication phases)."""
        self.schedule(t, CALL, fn)

    def add_flow(self, spec: FlowSpec) -> FlowRT:
        path = self.topo.route(spec.src, spec.dst, spec.fid)
        if not path:
            raise ValueError(f"flow {spec.fid}: src==dst ({spec.src})")
        bw = float(self.topo.link_bw[path].min())
        prop = float(self.topo.link_delay[path].sum())
        base_rtt = 2 * prop + (len(path) + 1) * self.mtu / bw
        f = FlowRT(
            spec=spec, path=path, ports=frozenset(path),
            cca=make_cca(spec.cca, bw, base_rtt), ack_delay=prop,
        )
        self.flows[spec.fid] = f
        self.flow_table.add(spec.fid, path)
        self.schedule(max(spec.start, self.now), START, spec.fid)
        return f

    # ------------------------------------------------------------------ #
    # Wormhole mechanism hooks (packet pausing + timestamp offsetting)
    # ------------------------------------------------------------------ #
    @hot_path
    def park_flows(self, fids, now: float, vrates: dict[int, float]) -> None:
        """Freeze the partition's flows: pending events stash as they pop,
        in-flight packets stay frozen in the queues, state advances
        analytically at the steady rate (packet pausing, §6.2)."""
        for fid in fids:
            f = self.flows[fid]
            if f.done:
                continue
            f.shift_at_epoch[f.epoch] = f.cum_shift
            f.epoch += 1            # events from before the park become stale
            f.parked = True
            f.vrate = max(vrates.get(fid, f.cca.rate()), 1e-3)
            f.park_t = now

    @hot_path
    def update_parked_rates(self, fids, now: float, vrates: dict[int, float]) -> None:
        """Retarget the analytic rates of already-parked flows (memo replay →
        steady transition without an intermediate unpark)."""
        for fid in fids:
            f = self.flows[fid]
            if f.done or not f.parked:
                continue
            self._materialize(f, now)
            f.vrate = max(vrates.get(fid, f.vrate), 1e-3)
            f.park_t = now

    @hot_path
    def unpark_flows(self, fids, ports, now: float, shift: float) -> None:
        """End a steady period: advance analytic state to ``now``, re-inject
        the stashed events at +ΔT (with RTT timestamps equally shifted) and
        shift the frozen port backlogs (timestamp offsetting, §6.3)."""
        for fid in fids:
            f = self.flows[fid]
            if f.done:
                continue
            self._materialize(f, now)
            f.parked = False
            f.cum_shift += shift
            f.int_prev = {p: (txb, ts + shift, q) for p, (txb, ts, q) in f.int_prev.items()}
            f.last_ack_t = now
            f.last_sample_t = now
            f.last_sample_delivered = f.delivered
            f.send_scheduled = False
            for (t, kind, payload) in f.paused_events:
                self.schedule(t + shift, kind, *self._shift_payload(kind, payload, shift, f.epoch))
                if kind == SEND:
                    f.send_scheduled = True
            f.paused_events.clear()
            if (not f.done and not f.send_scheduled and f.inflight <= 0
                    and f.remaining() > 0):
                f.send_scheduled = True
                self.schedule(now, SEND, fid, f.epoch)
        for p in ports:
            if self.busy_until[p] > now - shift:
                # preserve the frozen backlog: whatever was queued at park
                # time is still queued now (packet pausing, §6.2)
                self.busy_until[p] += shift
        self._ensure_sampler(now)

    @staticmethod
    def _shift_int(int_vec, shift: float):
        if not int_vec:
            return int_vec
        return tuple((p, txb, ts + shift, q) for (p, txb, ts, q) in int_vec)

    @classmethod
    def _shift_payload(cls, kind: int, payload: tuple, shift: float, epoch: int) -> tuple:
        if kind == ARRIVE:   # (fid, hop, pkt, t_sent, ecn, int_vec, epoch)
            fid, hop, pkt, t_sent, ecn, iv, _ = payload
            return (fid, hop, pkt, t_sent + shift, ecn, cls._shift_int(iv, shift), epoch)
        if kind == ACK:      # (fid, pkt, t_sent, ecn, int_vec, epoch)
            fid, pkt, t_sent, ecn, iv, _ = payload
            return (fid, pkt, t_sent + shift, ecn, cls._shift_int(iv, shift), epoch)
        if kind == LOSS:     # (fid, pkt, epoch)
            fid, pkt, _ = payload
            return (fid, pkt, epoch)
        if kind == SEND:     # (fid, epoch)
            return (payload[0], epoch)
        return payload

    @hot_path
    def _materialize(self, f: FlowRT, t: float) -> None:
        """Lazy analytic state at time t for a parked flow.  ``delivered``
        and ``sent`` slide forward together (the paper's sequence-number
        modification, §6.3): the frozen in-flight window keeps representing
        the newest unacked bytes, so nothing is double-counted when the
        stashed packets resume.  If the analytic advance reaches the end of
        the flow, the frozen pipeline *is* the tail — it is absorbed into
        the analytic stream and the flow completes at the exact time the
        delivery front hits the last byte (re-serializing the in-flight
        window after unpark would cost a spurious extra RTT)."""
        if not f.parked or f.done:
            return
        budget = f.vrate * max(0.0, t - f.park_t)
        size = f.spec.size
        if f.delivered + budget >= size - 1e-6:
            t_fin = t - max(0.0, f.delivered + budget - size) / f.vrate
            f.sent_new = size
            f.inflight = 0.0
            f.retx = 0.0
            f.paused_events.clear()
            f.park_t = t
            self.finish_flow(f, max(t_fin, 0.0))
            return
        adv = min(budget, max(0.0, size - f.sent_new))
        f.delivered += adv
        f.sent_new += adv
        f.park_t = t

    def virtual_completion(self, f: FlowRT) -> float:
        """Absolute time the parked flow completes at its steady rate."""
        return f.park_t + f.remaining() / max(f.vrate, 1e-3)

    def finish_flow(self, f: FlowRT, t: float) -> None:
        f.done = True
        f.finish_t = t
        f.delivered = f.spec.size
        self.results[f.fid] = FlowResult(
            fid=f.fid, start=f.start_actual, fct=t - f.start_actual,
            bytes=f.spec.size, tag=f.spec.tag)
        self.kernel.on_flow_finish(f, t)
        for cb in self.finish_listeners:
            cb(f, t)

    # ------------------------------------------------------------------ #
    # main loop
    # ------------------------------------------------------------------ #
    @hot_path
    def run(self, until: float = float("inf")) -> None:
        """Serial event loop, specialized for the hot path.

        The packet kinds (ARRIVE — the per-hop walk, ~2/3 of all events —
        plus SEND and ACK) are inlined below with direct heap pushes and
        hoisted locals; the authoritative copies stay in :meth:`_do_arrive`
        / :meth:`_do_send` / :meth:`_do_ack` for the sharded lane
        executors, and a subclass that overrides scheduling or any packet
        handler gets :meth:`_run_generic` instead.  Both loops pop, count
        and order events identically — bit-identical event streams, which
        tests/test_maxmin.py and the CI counter gate pin.

        ``events_processed`` / ``packet_hop_events`` / ``_seq`` accumulate
        in locals and flush to the instance before every call-out (flow
        completion, kernel hooks, driver callbacks — anything that may
        observe a count or schedule an event) and on exit; ``seq`` reloads
        after each call-out since callees schedule through it.  The cyclic
        GC is paused for the duration of the loop: the millions of
        short-lived event tuples otherwise trigger a gen-0 collection every
        ~700 allocations, and none of them can form cycles.
        """
        cls = type(self)
        if (cls.schedule is not PacketSim.schedule
                or cls._do_arrive is not PacketSim._do_arrive
                or cls._do_send is not PacketSim._do_send
                or cls._do_ack is not PacketSim._do_ack):
            return self._run_generic(until)
        self.time_limit = until
        heap = self._heap
        heappop = heapq.heappop
        heappush = heapq.heappush
        flows = self.flows
        link_bw = self._link_bw
        link_delay = self._link_delay
        busy_until = self.busy_until
        port_txbytes = self.port_txbytes
        ecn_k = self.ecn_k
        mtu = self.mtu
        cca_mtu = MTU  # the CCA rate/cwnd floor (≠ self.mtu in principle)
        buffer_bytes = self.buffer_bytes
        shared = self.shared_buffer
        record_rtt = self.record_rtt_fids
        nev = self.events_processed
        nhop = self.packet_hop_events
        seq = self._seq
        gc_was_on = gc.isenabled()
        if gc_was_on:
            gc.disable()
        try:
            while heap:
                t, s, kind, payload = heappop(heap)
                if t > until:
                    # reinsert the same (t, seq, ...) tuple — identical seq,
                    # so a resumed run pops the exact order an uninterrupted
                    # one would (a fresh seq would reorder same-time ties)
                    heappush(heap, (t, s, kind, payload))
                    break
                self.now = t
                nev += 1
                if kind == ARRIVE:
                    fid, hop, pkt, t_sent, ecn, int_vec, epoch = payload
                    f = flows[fid]
                    if epoch != f.epoch:
                        self._seq = seq
                        stale = self._stale(f, epoch, t, ARRIVE, payload)
                        seq = self._seq
                        if stale:
                            continue
                    if f.done:
                        continue
                    nhop += 1
                    path = f.path
                    if hop >= len(path):  # delivered: turn around an ACK
                        heappush(heap, (t + f.ack_delay, seq, ACK,
                                        (fid, pkt, t_sent, ecn, int_vec,
                                         f.epoch)))
                        seq += 1
                        continue
                    port = path[hop]
                    bw = link_bw[port]
                    busy = busy_until[port]
                    depart = busy if busy > t else t
                    backlog = (depart - t) * bw
                    cap = (buffer_bytes if shared is None
                           else self._buffer_cap(port))
                    if backlog + pkt > cap:
                        # drop: sender learns after ~RTT
                        heappush(heap, (t + f.cca.srtt, seq, LOSS,
                                        (fid, pkt, f.epoch)))
                        seq += 1
                        continue
                    if backlog > ecn_k:
                        ecn = True
                    tx_end = depart + pkt / bw
                    busy_until[port] = tx_end
                    txb = port_txbytes[port] + pkt
                    port_txbytes[port] = txb
                    if int_vec is not None:
                        int_vec = int_vec + ((port, txb, tx_end, backlog),)
                    heappush(heap, (tx_end + link_delay[port], seq, ARRIVE,
                                    (fid, hop + 1, pkt, t_sent, ecn, int_vec,
                                     f.epoch)))
                    seq += 1
                elif kind == SEND:
                    fid, epoch = payload
                    f = flows[fid]
                    if epoch != f.epoch:
                        self._seq = seq
                        stale = self._stale(f, epoch, t, SEND, payload)
                        seq = self._seq
                        if stale:
                            continue
                    f.send_scheduled = False
                    if f.done or f.parked or not f.started:
                        continue
                    retx = f.retx
                    if retx > 0:
                        want = retx
                    else:
                        want = f.spec.size - f.sent_new
                        if mtu <= want:
                            want = mtu
                    if want <= 0:
                        continue
                    cca = f.cca
                    inflight = f.inflight
                    if inflight > 0:
                        # cwnd() inlined: the base-class accessor (w floored
                        # at one MTU); no registry CCA overrides it
                        w = cca.w
                        if inflight + mtu > (w if w >= cca_mtu else cca_mtu):
                            f.blocked = True
                            continue
                    pkt = mtu if mtu <= want else want
                    if retx > 0:
                        f.retx = retx - pkt
                    else:
                        f.sent_new += pkt
                    f.inflight = inflight + pkt
                    int_vec = () if cca.uses_int else None
                    heappush(heap, (t, seq, ARRIVE,
                                    (fid, 0, pkt, t, False, int_vec,
                                     f.epoch)))
                    seq += 1
                    if f.sent_new < f.spec.size or f.retx > 0:
                        f.send_scheduled = True
                        r = cca.r  # rate() inlined, same one-MTU floor
                        heappush(heap, (t + pkt / (r if r >= cca_mtu
                                                   else cca_mtu), seq, SEND,
                                        (fid, f.epoch)))
                        seq += 1
                elif kind == ACK:
                    fid, pkt, t_sent, ecn, int_vec, epoch = payload
                    f = flows[fid]
                    if epoch != f.epoch:
                        self._seq = seq
                        stale = self._stale(f, epoch, t, ACK, payload)
                        seq = self._seq
                        if stale:
                            continue
                    if f.done:
                        continue
                    inflight = f.inflight - pkt
                    f.inflight = inflight if inflight > 0.0 else 0.0
                    f.delivered += pkt
                    f.last_ack_t = t
                    rtt = t - t_sent
                    if record_rtt and fid in record_rtt:
                        f.rtt_samples.append((t, rtt))
                    cca = f.cca
                    info = None
                    if int_vec is not None:
                        # sender-side HPCC telemetry (see _do_ack)
                        int_prev = f.int_prev
                        base_rtt = cca.base_rtt
                        u_max = 0.0
                        for (port, txb, ts, qlen) in int_vec:
                            bw = link_bw[port]
                            prev = int_prev.get(port)
                            if prev is not None and ts > prev[1] + 1e-12:
                                pq = prev[2]
                                u = ((qlen if qlen <= pq else pq)
                                     / (bw * base_rtt)
                                     + (txb - prev[0])
                                     / ((ts - prev[1]) * bw))
                            else:
                                u = 0.95 + qlen / (bw * base_rtt)
                            int_prev[port] = (txb, ts, qlen)
                            if u > u_max:
                                u_max = u
                        info = INTInfo(u_max)
                    cca.on_ack(t, pkt, ecn, rtt, info)
                    if f.delivered >= f.spec.size:
                        self.events_processed = nev
                        self.packet_hop_events = nhop
                        self._seq = seq
                        self.finish_flow(f, t)
                        seq = self._seq
                        continue
                    if (f.blocked or not f.send_scheduled) and (
                            f.sent_new < f.spec.size or f.retx > 0):
                        f.blocked = False
                        f.send_scheduled = True
                        heappush(heap, (t, seq, SEND, (fid, f.epoch)))
                        seq += 1
                elif kind == START:
                    batch = [payload[0]]
                    while heap and heap[0][0] == t and heap[0][2] == START:
                        _, _, _, pl = heappop(heap)
                        nev += 1
                        batch.append(pl[0])
                    self.events_processed = nev
                    self.packet_hop_events = nhop
                    self._seq = seq
                    self._do_start_batch(t, batch)
                    seq = self._seq
                elif kind == LOSS:
                    self.events_processed = nev
                    self.packet_hop_events = nhop
                    self._seq = seq
                    self._do_loss(t, *payload)
                    seq = self._seq
                elif kind == SAMPLE:
                    self.events_processed = nev
                    self.packet_hop_events = nhop
                    self._seq = seq
                    self._do_sample(t)
                    seq = self._seq
                elif kind == KERNEL:
                    self.events_processed = nev
                    self.packet_hop_events = nhop
                    self._seq = seq
                    self.kernel.on_kernel_event(t, payload[0])
                    seq = self._seq
                elif kind == CALL:
                    self.events_processed = nev
                    self.packet_hop_events = nhop
                    self._seq = seq
                    payload[0](t)
                    seq = self._seq
        finally:
            self.events_processed = nev
            self.packet_hop_events = nhop
            # on an exceptional exit mid-call-out the instance counter may
            # already be ahead of the local — never roll it back
            if seq > self._seq:
                self._seq = seq
            if gc_was_on:
                gc.enable()

    def _run_generic(self, until: float = float("inf")) -> None:
        self.time_limit = until
        heap = self._heap
        while heap:
            if heap[0][0] > until:
                break
            t, _, kind, payload = heapq.heappop(heap)
            self.now = t
            self.events_processed += 1
            if kind == ARRIVE:
                self._do_arrive(t, *payload)
            elif kind == START:
                batch = [payload[0]]
                while heap and heap[0][0] == t and heap[0][2] == START:
                    _, _, _, pl = heapq.heappop(heap)
                    self.events_processed += 1
                    batch.append(pl[0])
                self._do_start_batch(t, batch)
            elif kind == SEND:
                self._do_send(t, *payload)
            elif kind == ACK:
                self._do_ack(t, *payload)
            elif kind == LOSS:
                self._do_loss(t, *payload)
            elif kind == SAMPLE:
                self._do_sample(t)
            elif kind == KERNEL:
                self.kernel.on_kernel_event(t, payload[0])
            elif kind == CALL:
                payload[0](t)

    # -- handlers --------------------------------------------------------- #
    def _stale(self, f: FlowRT, epoch: int, t: float, kind: int, payload: tuple) -> bool:
        """Timestamp-offsetting machinery (§6.3): an event from an older
        epoch is stashed while its flow is parked, or re-offset by the shift
        accumulated since it was scheduled if the flow has resumed."""
        if epoch == f.epoch:
            return False
        if f.done or epoch < f.void_before:
            # void epochs: events superseded by the timeout safety net must
            # die, not re-offset — their bytes already moved to ``retx``
            return True
        if f.parked:
            f.paused_events.append((t, kind, payload))
        else:
            shift = f.cum_shift - f.shift_at_epoch.get(epoch, f.cum_shift)
            self.schedule(t + shift, kind, *self._shift_payload(kind, payload, shift, f.epoch))
        return True

    def _do_start_batch(self, t: float, fids: list[int]) -> None:
        flows = []
        for fid in fids:
            f = self.flows[fid]
            f.started = True
            f.start_actual = t
            f.last_sample_t = t
            f.last_ack_t = t
            flows.append(f)
        self.kernel.on_flows_start(flows)
        for f in flows:
            if not f.parked and not f.send_scheduled and not f.done:
                f.send_scheduled = True
                self.schedule(t, SEND, f.fid, f.epoch)
        self._ensure_sampler(t)

    def _do_send(self, t: float, fid: int, epoch: int) -> None:
        f = self.flows[fid]
        if epoch != f.epoch and self._stale(f, epoch, t, SEND, (fid, epoch)):
            return
        f.send_scheduled = False
        if f.done or f.parked or not f.started:
            return
        want = f.retx if f.retx > 0 else min(self.mtu, f.spec.size - f.sent_new)
        if want <= 0:
            return
        # allow one packet in flight even when cwnd < mtu (TCP's one-MSS
        # floor): with nothing outstanding no ACK/LOSS can ever reopen the
        # window, so blocking here would stall the flow forever — reachable
        # since the timeout safety net voids all in-flight events
        if f.inflight > 0 and f.inflight + self.mtu > f.cca.cwnd():
            f.blocked = True
            return
        pkt = min(self.mtu, want)
        if f.retx > 0:
            f.retx -= pkt
        else:
            f.sent_new += pkt
        f.inflight += pkt
        int_vec = () if f.cca.uses_int else None
        # NOTE: sends stay on self.schedule — ShardedPacketSim overrides it
        # to route packet events into per-partition lanes
        self.schedule(t, ARRIVE, fid, 0, pkt, t, False, int_vec, f.epoch)
        if f.sent_new < f.spec.size or f.retx > 0:
            f.send_scheduled = True
            self.schedule(t + pkt / f.cca.rate(), SEND, fid, f.epoch)

    def _do_arrive(self, t: float, fid: int, hop: int, pkt: float, t_sent: float,
                   ecn: bool, int_vec, epoch: int) -> None:
        f = self.flows[fid]
        # the stale-payload tuple is only materialized on an epoch mismatch
        # (parks/timeouts) — the overwhelmingly common fresh path skips it
        if epoch != f.epoch and self._stale(
                f, epoch, t, ARRIVE, (fid, hop, pkt, t_sent, ecn, int_vec, epoch)):
            return
        if f.done:
            return
        self.packet_hop_events += 1
        if hop >= len(f.path):  # delivered: turn around an ACK
            self.schedule(t + f.ack_delay, ACK, fid, pkt, t_sent, ecn, int_vec, f.epoch)
            return
        port = f.path[hop]
        bw = self._link_bw[port]
        busy = self.busy_until[port]
        depart = busy if busy > t else t
        backlog = (depart - t) * bw
        cap = (self.buffer_bytes if self.shared_buffer is None
               else self._buffer_cap(port))
        if backlog + pkt > cap:
            # drop: sender learns after ~RTT
            self.schedule(t + f.cca.srtt, LOSS, fid, pkt, f.epoch)
            return
        if backlog > self.ecn_k:
            ecn = True
        tx_end = depart + pkt / bw
        self.busy_until[port] = tx_end
        txb = self.port_txbytes[port] + pkt
        self.port_txbytes[port] = txb
        if int_vec is not None:
            # INT telemetry (HPCC): per-hop (port, txBytes, ts, qlen) snapshot
            int_vec = int_vec + ((port, txb, tx_end, backlog),)
        self.schedule(tx_end + self._link_delay[port], ARRIVE,
                      fid, hop + 1, pkt, t_sent, ecn, int_vec, f.epoch)

    def _buffer_cap(self, port: int) -> float:
        if self.shared_buffer is None:
            return self.buffer_bytes
        sw = self._link_src[port]
        if sw < self.topo.n_hosts:
            return self.buffer_bytes
        used = 0.0
        now = self.now
        for lid, _ in self.topo.adj[sw]:
            backlog = (self.busy_until[lid] - now) * self._link_bw[lid]
            if backlog > 0.0:
                used += backlog
        return min(self.buffer_bytes, max(self.mtu, self.shared_buffer - used))

    def _do_ack(self, t: float, fid: int, pkt: float, t_sent: float, ecn: bool,
                int_vec, epoch: int) -> None:
        f = self.flows[fid]
        if epoch != f.epoch and self._stale(
                f, epoch, t, ACK, (fid, pkt, t_sent, ecn, int_vec, epoch)):
            return
        if f.done:
            return
        inflight = f.inflight - pkt
        f.inflight = inflight if inflight > 0.0 else 0.0
        f.delivered += pkt
        f.last_ack_t = t
        rtt = t - t_sent
        if self.record_rtt_fids and fid in self.record_rtt_fids:
            f.rtt_samples.append((t, rtt))
        info = None
        if int_vec is not None:
            # sender-side HPCC: U_hop = txRate/bw + qlen/(bw*T) from deltas
            # against the previous ACK's snapshots (Li et al., SIGCOMM'19)
            link_bw = self._link_bw
            int_prev = f.int_prev
            base_rtt = f.cca.base_rtt
            u_max = 0.0
            for (port, txb, ts, qlen) in int_vec:
                bw = link_bw[port]
                prev = int_prev.get(port)
                if prev is not None and ts > prev[1] + 1e-12:
                    pq = prev[2]
                    u = ((qlen if qlen <= pq else pq) / (bw * base_rtt)
                         + (txb - prev[0]) / ((ts - prev[1]) * bw))
                else:
                    u = 0.95 + qlen / (bw * base_rtt)  # no delta yet
                int_prev[port] = (txb, ts, qlen)
                if u > u_max:
                    u_max = u
            info = INTInfo(u_max)
        f.cca.on_ack(t, pkt, ecn, rtt, info)
        if f.delivered >= f.spec.size:
            self.finish_flow(f, t)
            return
        if (f.blocked or not f.send_scheduled) and (
                f.sent_new < f.spec.size or f.retx > 0):
            f.blocked = False
            f.send_scheduled = True
            self.schedule(t, SEND, fid, f.epoch)

    def _do_loss(self, t: float, fid: int, pkt: float, epoch: int) -> None:
        f = self.flows[fid]
        if epoch != f.epoch and self._stale(f, epoch, t, LOSS, (fid, pkt, epoch)):
            return
        if f.done:
            return
        f.inflight = max(0.0, f.inflight - pkt)
        f.retx += pkt
        f.cca.on_ack(t, 0.0, True, f.cca.srtt * 2,
                     INTInfo(2.0) if f.cca.uses_int else None)  # loss == severe congestion
        if not f.send_scheduled:
            f.send_scheduled = True
            self.schedule(t, SEND, fid, f.epoch)

    def _ensure_sampler(self, t: float) -> None:
        if not self._sample_pending and self._any_active_unparked():
            self._sample_pending = True
            self.schedule(t + self.sample_interval, SAMPLE)

    def _any_active_unparked(self) -> bool:
        return any(f.started and not f.done and not f.parked for f in self.flows.values())

    def _do_sample(self, t: float) -> None:
        self._sample_pending = False
        for f in self.flows.values():
            if not f.started or f.done or f.parked:
                continue
            dt = t - f.last_sample_t
            if dt <= 0:
                continue
            rate = (f.delivered - f.last_sample_delivered) / dt
            if len(f.rate_hist) >= self.window:
                f.rate_hist.popleft()
            f.rate_hist.append(rate)
            f.last_sample_delivered = f.delivered
            f.last_sample_t = t
            # timeout safety net: everything in flight counted lost.  The
            # superseded ARRIVE/ACK/LOSS events are still live in the heap;
            # void their epoch, or a late ACK would count bytes that are
            # *also* queued for retransmission and finish the flow early.
            if f.inflight > 0 and t - f.last_ack_t > max(10 * f.cca.srtt, 20 * self.sample_interval):
                f.retx += f.inflight
                f.inflight = 0.0
                f.shift_at_epoch[f.epoch] = f.cum_shift
                f.epoch += 1
                f.void_before = f.epoch
                f.last_ack_t = t   # restart the timer (RTO semantics) or
                #                    every later sample would void the fresh
                #                    retransmission again — livelock
                self.timeouts += 1
                # any pending SEND was voided with its epoch — re-arm
                f.blocked = False
                f.send_scheduled = True
                self.schedule(t, SEND, f.fid, f.epoch)
        self.kernel.on_sample(t)
        self._ensure_sampler(t)

    # ------------------------------------------------------------------ #
    def all_done(self) -> bool:
        return all(f.done for f in self.flows.values())
