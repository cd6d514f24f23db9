"""Partition-sharded event loop with intra-run parallel fan-out (§6.1).

The serial :class:`~repro_torch.net.packet_sim.PacketSim` loop pops one global
heap.  But partitions — connected components of the flow↔port bipartite
graph (`repro_torch.core.partition`) — share no ports, so their packet events
commute between the global synchronization points: flow entry (START/CALL),
flow completion reshape, sample ticks and kernel (unpark) events.

:class:`ShardedPacketSim` exploits that: per-partition *event lanes* (one
local heap + seq counter each, keyed by the live ``PartitionIndex``) plus
one global lane for START/SAMPLE/KERNEL/CALL events.  The loop runs in
*windows*: every lane advances independently up to the next global event's
timestamp (the barrier), then the barrier event executes against the merged
state.  Within a lane, events keep the serial loop's relative `(t, seq)`
order, so results are identical to the serial loop — the property the
equivalence tests pin down.

Intra-run fan-out (``intra_workers >= 2``) dispatches *heavy* lanes — big
UNSTEADY partitions that provably cannot complete a flow inside the window
— to a spawn-based process pool, while parked/replaying partitions stay
analytic and light lanes run in the parent.  Lane state (flows + port
backlogs + pending events) ships to the worker and back; the lane-local seq
counter travels with it, so the merged execution is bit-identical to the
serial sharded loop no matter how many workers run.

Two conservative guards keep the parallel path exact:

* a lane is only dispatched if no member flow can finish inside the window
  (remaining bytes > in-flight + retx + 2·line_rate·window); a worker that
  *does* hit a completion aborts, and the parent re-runs the whole window
  serially from its own (unmutated) state;
* if a parent-side completion schedules a new global event *inside* the
  window (flow-entry reshape: the driver launching a dependent phase), the
  barrier shrinks to it before any heavy lane is dispatched.

``shared_buffer`` couples ports of co-located partitions through the switch
pool, which breaks Definition 1 exclusivity — sharded mode refuses it.

Copy of ``repro.net.sharded_sim``, which the port may not import.  Its spawned
lane workers unpickle ``repro_torch`` lanes and import only the port's
packet path, which loads no torch.
"""
from __future__ import annotations

import heapq
import itertools
import math
import pickle
from collections import deque
from concurrent.futures import ProcessPoolExecutor

from repro_torch.core.partition import PartitionIndex
from repro_torch.net.packet_sim import (ACK, ARRIVE, CALL, KERNEL, LOSS, SAMPLE,
                                  SEND, START, PacketSim)
from repro_torch.net.soa import LaneState
from repro_torch.net.topology import Topology

PACKET_KINDS = frozenset((SEND, ARRIVE, ACK, LOSS))
GRAVE = 0   # lane id for residual events of completed flows


def _exec_packet_event(sim: PacketSim, t: float, kind: int,
                       payload: tuple) -> None:
    """The one packet-event dispatch switch every lane executor (parent
    serial/tight loops, worker loop) shares — keeping a single source of
    truth is what the sharded loop's identical-to-serial guarantee hangs
    on."""
    sim.now = t
    sim.events_processed += 1
    if kind == ARRIVE:
        sim._do_arrive(t, *payload)
    elif kind == SEND:
        sim._do_send(t, *payload)
    elif kind == ACK:
        sim._do_ack(t, *payload)
    elif kind == LOSS:
        sim._do_loss(t, *payload)
    else:
        raise RuntimeError(f"non-packet event kind {kind} in a lane")


# lane state lives in the struct-of-arrays module now (shared with the
# hybrid loop and the SoA parity tests); the old private name stays an
# alias because it *is* the same structure
_Lane = LaneState


class ShardedPacketSim(PacketSim):
    """Drop-in :class:`PacketSim` with a partition-sharded scheduler.

    intra_workers      worker processes for heavy-lane fan-out (1 = serial
                       sharded execution, still lane-structured and exact)
    intra_min_events   a lane is dispatched only if it holds at least this
                       many pending events (smaller lanes aren't worth IPC)
    validate           check lane/partition invariants per event + barrier
                       (property tests; slow)
    """

    # hot class (reprolint H205/C304): slots on top of PacketSim's
    __slots__ = (
        "_lanes", "_grave", "_split_log", "_fid_lane", "intra_workers",
        "intra_min_events", "validate", "_adopted_index", "_pindex",
        "_own_index", "_pool", "shard_stats", "_shell_key", "_shell_blob",
    )

    def __init__(self, topo: Topology, kernel=None, *,
                 intra_workers: int = 1, intra_min_events: int = 64,
                 validate: bool = False, **knobs) -> None:
        self._lanes: dict[int, _Lane] = {}
        self._grave = _Lane(GRAVE)
        self._split_log: list[tuple[int, list[int]]] = []
        self._fid_lane: dict[int, _Lane] = {}   # hot-path cache, see schedule
        # must exist before super().__init__: kernel.attach (called there)
        # may adopt_partition_index(), which writes this slot
        self._adopted_index: PartitionIndex | None = None
        super().__init__(topo, kernel=kernel, **knobs)
        if self.shared_buffer is not None:
            raise ValueError(
                "sharded mode needs per-port buffers: shared_buffer couples "
                "partitions through the switch pool (Definition 1 breaks)")
        self.intra_workers = max(1, int(intra_workers))
        self.intra_min_events = intra_min_events
        self.validate = validate
        if self._adopted_index is not None:
            self._pindex = self._adopted_index        # kernel-owned lifecycle
            self._own_index = False
        else:
            self._pindex = PartitionIndex()           # kernel-less: mirror it
            self._own_index = True
        self._pindex.observer = self
        self._pool: ProcessPoolExecutor | None = None
        self.shard_stats = {
            "windows": 0, "dispatches": 0, "dispatched_events": 0,
            "window_shrinks": 0, "serial_redos": 0, "merges": 0, "splits": 0,
            # batched run draining (LaneState.pop_run): runs of >= 2
            # same-timestamp events drained under one window-bound check
            "batched_drains": 0, "max_batch_width": 0,
        }

    # ------------------------------------------------------------------ #
    # partition lifecycle -> lane lifecycle (PartitionObserver protocol)
    # ------------------------------------------------------------------ #
    def adopt_partition_index(self, index: PartitionIndex) -> None:
        """Called by a kernel (Wormhole) during attach: its live
        PartitionIndex drives lane creation/merge/split instead of a
        duplicate one."""
        self._adopted_index = index

    def on_partition_merge(self, fid: int, new_pid: int,
                           merged_pids: set[int]) -> None:
        self._fid_lane.clear()
        olds = [self._lanes.pop(p) for p in sorted(merged_pids)
                if p in self._lanes]
        if not olds:
            return
        self.shard_stats["merges"] += 1
        merged = _Lane(new_pid)
        # Deterministic interleave: within one old lane, (t, seq) order is
        # preserved; across old lanes same-t events commute (their port sets
        # were disjoint pre-merge), ordered by lane rank for reproducibility.
        # New events get larger seqs — exactly the serial loop's "scheduled
        # after the merge" ordering.
        items: list = []
        for rank, ln in enumerate(olds):
            items.extend((t, s, rank, kind, payload)
                         for (t, s, kind, payload) in ln.heap)
        items.sort(key=lambda e: (e[0], e[1], e[2]))
        for (t, _s, _r, kind, payload) in items:
            merged.seq += 1
            merged.heap.append((t, merged.seq, kind, payload))
        self._lanes[new_pid] = merged

    def on_partition_split(self, fid: int, old_pid: int,
                           new_parts: list[tuple[int, set[int]]]) -> None:
        self._fid_lane.clear()
        old = self._lanes.pop(old_pid, None)
        if old is None:
            return
        self.shard_stats["splits"] += 1
        owner: dict[int, int] = {}
        for new_pid, flows in new_parts:
            for g in flows:
                owner[g] = new_pid
        buckets: dict[int, list] = {}
        for ev in sorted(old.heap, key=lambda e: (e[0], e[1])):
            pid2 = owner.get(ev[3][0])
            if pid2 is None:
                # the departing flow is finished (reshape interrupt ②): its
                # residual stale events drain through the graveyard lane
                self._grave.push(ev[0], ev[2], ev[3])
            else:
                buckets.setdefault(pid2, []).append(ev)
        for pid2, evs in buckets.items():
            ln = _Lane(pid2)
            for (t, _s, kind, payload) in evs:
                ln.seq += 1
                ln.heap.append((t, ln.seq, kind, payload))
            self._lanes[pid2] = ln
        self._split_log.append((old_pid, [p for p, _ in new_parts]))

    # ------------------------------------------------------------------ #
    # scheduling: packet events go to their partition's lane
    # ------------------------------------------------------------------ #
    def schedule(self, t: float, kind: int, *payload) -> None:
        t = max(t, self.now)
        if kind in PACKET_KINDS:
            # fid -> lane cache (invalidated wholesale on any merge/split —
            # partition reshapes are rare next to per-packet scheduling)
            lane = self._fid_lane.get(payload[0])
            if lane is None:
                pid = self._pindex.flow_pid.get(payload[0])
                if pid is None:
                    self._grave.push(t, kind, payload)
                    return
                lane = self._lanes.get(pid)
                if lane is None:
                    lane = self._lanes[pid] = _Lane(pid)
                self._fid_lane[payload[0]] = lane
            lane.push(t, kind, payload)
        else:
            s = self._seq
            self._seq = s + 1
            heapq.heappush(self._heap, (t, s, kind, payload))

    def _do_start_batch(self, t: float, fids: list[int]) -> None:
        if self._own_index:
            for fid in fids:
                self._pindex.add_flow(fid, self.flows[fid].ports)
        super()._do_start_batch(t, fids)

    def finish_flow(self, f, t: float) -> None:
        super().finish_flow(f, t)
        if self._own_index and f.fid in self._pindex.flow_pid:
            self._pindex.remove_flow(f.fid)

    # ------------------------------------------------------------------ #
    # main loop: lane windows between global barriers
    # ------------------------------------------------------------------ #
    def run(self, until: float = float("inf")) -> None:
        self.time_limit = until
        heap = self._heap
        while True:
            gtop = heap[0][0] if heap else math.inf
            if not self._lanes_have_events(until) and (not heap or gtop > until):
                break
            self._run_window(gtop, until)
            if not heap or heap[0][0] > until:
                continue
            # a clamped dispatch window may stop short of the barrier: the
            # global event must not run until every lane has drained up to it
            gtop = heap[0][0]
            if self._lanes_behind(gtop, until):
                continue
            t, _, kind, payload = heapq.heappop(heap)
            self.now = t
            self.events_processed += 1
            if kind == START:
                batch = [payload[0]]
                while heap and heap[0][0] == t and heap[0][2] == START:
                    _, _, _, pl = heapq.heappop(heap)
                    self.events_processed += 1
                    batch.append(pl[0])
                self._do_start_batch(t, batch)
            elif kind == SAMPLE:
                self._do_sample(t)
            elif kind == KERNEL:
                self.kernel.on_kernel_event(t, payload[0])
            elif kind == CALL:
                payload[0](t)
            else:  # a packet kind can only land here through a kernel bug
                raise RuntimeError(f"packet event kind {kind} in global lane")
            # splits during barrier processing (kernel reshapes on
            # completion/unpark) are fully applied by the observer itself;
            # the log is only for executors adopting splits *they* cause —
            # a stale entry would make the next window run a freshly
            # re-keyed lane in two executors at once
            self._split_log.clear()
            if self.validate:
                self.check_invariants()

    def _lanes_have_events(self, until: float) -> bool:
        if self._grave.heap and self._grave.heap[0][0] <= until:
            return True
        return any(ln.heap and ln.heap[0][0] <= until
                   for ln in self._lanes.values())

    def _lanes_behind(self, W: float, until: float) -> bool:
        """Any lane event strictly before the barrier still pending?"""
        if self._grave.heap and self._grave.heap[0][0] < W \
                and self._grave.heap[0][0] <= until:
            return True
        return any(ln.heap and ln.heap[0][0] < W and ln.heap[0][0] <= until
                   for ln in self._lanes.values())

    def _run_window(self, W: float, until: float) -> None:
        active = [ln for ln in itertools.chain(self._lanes.values(),
                                               (self._grave,))
                  if ln.heap and ln.heap[0][0] < W and ln.heap[0][0] <= until]
        if not active:
            return
        self.shard_stats["windows"] += 1
        if self.intra_workers <= 1:
            self._run_lanes_serial(active, W, until)
            return
        # Completion horizons clamp the dispatch barrier instead of pulling
        # whole lanes into the parent: windows thin out just before a flow
        # can possibly finish and fatten again right after, so the bulk of
        # every UNSTEADY partition's events still runs in the workers.
        heavy, light = [], []
        W_disp = W
        for ln in active:
            if ln is self._grave or math.isinf(W):
                light.append(ln)
                continue
            horizon = self._lane_safe_horizon(ln)
            if horizon <= ln.heap[0][0] + 0.25 * (W - ln.heap[0][0]):
                # completion-imminent: the parent runs this lane for the
                # whole window (completions + reshape are exact there);
                # clamping the shared barrier under it instead would
                # fragment everyone's window geometrically near each finish
                light.append(ln)
                continue
            W_disp = min(W_disp, horizon)
            heavy.append(ln)
        # cheap lanes aren't worth shipping: estimate the events the lane
        # will actually process inside the window (pending heap size is just
        # the in-flight set — a ramping flow holds 1 SEND yet generates
        # thousands of events per window)
        if heavy and not math.isinf(W_disp):
            still = []
            for ln in heavy:
                if self._lane_window_cost(ln, W_disp) >= self.intra_min_events:
                    still.append(ln)
                else:
                    light.append(ln)
            heavy = still
        if len(heavy) < 2 or self.intra_workers < 2:
            self._run_lanes_serial(active, W, until)
            return
        if W_disp < W:
            self.shard_stats["window_shrinks"] += 1
        self._run_window_parallel(heavy, light, W_disp, until)

    def _run_window_parallel(self, heavy: list[_Lane], light: list[_Lane],
                             W: float, until: float) -> None:
        """The parent is one of the ``intra_workers`` executors: it ships
        ``intra_workers - 1`` bins of heavy lanes to the pool, then runs the
        light lanes plus its own bin concurrently through the exact
        interleaved loop.  Worker results are merged only if the parent saw
        no barrier shrink (a completion spawning a global event inside the
        window); otherwise they are discarded unmerged and the worker lanes
        re-run serially — exactness is never at stake, only wall-clock."""
        cost = {ln.pid: self._lane_window_cost(ln, W) for ln in heavy}
        costed = sorted(heavy, key=lambda ln: -cost[ln.pid])
        nbins = min(self.intra_workers, len(costed))
        bins: list[list[_Lane]] = [[] for _ in range(nbins)]
        # the parent's bin (index 0) starts pre-loaded with the light lanes'
        # cost so the greedy packer hands it proportionally less heavy work
        loads = [0.0] * nbins
        loads[0] = sum(self._lane_window_cost(ln, W) for ln in light)
        for ln in costed:
            i = loads.index(min(loads))
            bins[i].append(ln)
            loads[i] += cost[ln.pid]
        futures = self._dispatch(bins[1:], W, until)
        W_eff = self._run_lanes_serial(light, W, until) if light else W
        if W_eff < W:
            # a light-lane completion spawned a global event inside the
            # window: the parent bin must stop there too, with the exact
            # (watermarked) loop — the tight path has no barrier bookkeeping
            self._run_lanes_serial(bins[0], W, until)
        else:
            self._run_lanes_tight(bins[0], W, until)
        gheap = self._heap
        shrunk = (W_eff < W) or (bool(gheap) and gheap[0][0] < W)
        results = [pickle.loads(f.result()) for f in futures]
        worker_lanes = [ln for group in bins[1:] for ln in group]
        if shrunk or any(res is None for res in results):
            # barrier moved (or a worker hit an "impossible" completion):
            # nothing was merged, so the worker lanes re-run exactly in the
            # parent, stopping at the (possibly shrunk) barrier
            self.shard_stats["serial_redos"] += 1
            self._run_lanes_serial(worker_lanes, W, until)
            return
        self._merge(worker_lanes, results)

    def _run_lanes_tight(self, lanes: list[_Lane], W: float,
                         until: float) -> None:
        """Lane-major fast path for the parent's own bin of heavy lanes —
        the in-process mirror of the worker loop.  No frontier interleaving
        (the lanes are port-disjoint, so their events commute) and no
        watermarks: the safe-horizon bound excludes completions below W.
        Should one fire anyway, the split is adopted, execution stops at
        the new global event, and the caller's shrink check re-runs the
        worker lanes; lanes of this bin that finished *before* the
        completion have then overrun the new barrier — the one residual
        inexactness, reachable only if the physical delivery bound
        (delivered <= inflight + retx + 1.05*line_rate*dur) is violated."""
        gheap = self._heap
        stats = self.shard_stats
        work = deque(ln.pid for ln in lanes)
        while work:
            pid = work.popleft()
            ln = self._lanes.get(pid)
            if ln is None:
                continue
            heap = ln.heap
            defunct = False
            while heap and heap[0][0] < W and heap[0][0] <= until:
                # drain the whole same-timestamp run under this one bound
                # check; popped events execute in (t, seq) order regardless
                # of a mid-run split (they are the top of the run with the
                # smallest seqs — anything redistributed or newly scheduled
                # orders after them, exactly as in the serial loop)
                run = ln.pop_run()
                width = len(run)
                if width > 1:
                    stats["batched_drains"] += 1
                    if width > stats["max_batch_width"]:
                        stats["max_batch_width"] = width
                for (t, _s, kind, payload) in run:
                    _exec_packet_event(self, t, kind, payload)
                    if self._split_log:
                        # an "impossible" completion split this lane: its
                        # remaining events moved to the residual lanes
                        for old_pid, new_pids in self._split_log:
                            if old_pid == pid:
                                defunct = True
                            work.extend(new_pids)
                        self._split_log.clear()
                if defunct:
                    break
            if gheap and gheap[0][0] < W:
                return        # barrier moved under us: stop at it

    def _lane_window_cost(self, ln: _Lane, W: float) -> float:
        """Rough events-in-window estimate: pending events plus ~4 hop/ack
        events per MTU the lane's live flows deliver over the window."""
        dur = max(0.0, W - ln.heap[0][0])
        rate = 0.0
        for fid in self._pindex.parts.get(ln.pid, ()):
            f = self.flows[fid]
            if not f.done and not f.parked and f.started:
                rate += f.cca.rate()
        return len(ln.heap) + 4.0 * rate * dur / self.mtu

    def _lane_safe_horizon(self, ln: _Lane) -> float:
        """Latest barrier up to which no member flow can possibly finish:
        ``delivered`` grows by ACKed bytes, physically capped by what was
        already in flight plus what the flow's bottleneck port can drain
        (line_rate · dur; 1.05x margin).  A worker that finishes a flow
        anyway aborts the dispatch, so this bound is a fast path, not a
        correctness axiom."""
        t0 = ln.heap[0][0]
        horizon = math.inf
        for fid in self._pindex.parts.get(ln.pid, ()):
            f = self.flows[fid]
            if f.done or f.parked or not f.started:
                continue
            slack = f.remaining() - f.inflight - f.retx - 2 * self.mtu
            if slack <= 0:
                return t0
            horizon = min(horizon, t0 + slack / (1.05 * f.cca.line_rate))
        return horizon

    # -- exact interleaved execution (parent side) ----------------------- #
    def _run_lanes_serial(self, lanes: list[_Lane], W: float,
                          until: float) -> float:
        """Run ``lanes`` in merged time order up to the barrier ``W``
        (exclusive).  If processing spawns a *new* global event below W, the
        barrier shrinks to it; lane events at exactly the shrunk barrier are
        processed only if they were already scheduled when it appeared
        (seq watermark) — precisely the serial loop's (t, seq) tie order."""
        gheap = self._heap
        pids = {ln.pid for ln in lanes}
        frontier = [(ln.heap[0][0], ln.heap[0][1], ln.pid) for ln in lanes]
        heapq.heapify(frontier)
        W_eff = W
        snap: dict[int, int] | None = None   # pid -> seq watermark at shrink
        if gheap and gheap[0][0] < W_eff:
            # a global event already sits inside the window (serial redo
            # after a shrink): everything pending predates it, anything
            # generated from here on is younger — watermark accordingly
            W_eff = gheap[0][0]
            snap = {ln.pid: ln.seq for ln in lanes}
        stats = self.shard_stats
        while frontier:
            _t, _s, pid = heapq.heappop(frontier)
            ln = self._lanes.get(pid) if pid != GRAVE else self._grave
            if ln is None or pid not in pids or not ln.heap:
                continue
            # batch: stay on this lane while its top is not later than any
            # other lane's (same-t cross-lane order commutes — no shared
            # ports), skipping the frontier churn for event bursts
            nb_t = frontier[0][0] if frontier else math.inf
            rebalance = False
            defunct = False
            while ln.heap:
                t, s, _kind, _payload = ln.heap[0]
                if t > until or t > W_eff or (
                        t == W_eff and (snap is None or s > snap.get(pid, -1))):
                    break          # lane rests at the barrier
                if t > nb_t:
                    rebalance = True
                    break          # another lane is earlier now
                # drain the whole same-timestamp run under the one bound
                # check above; at the shrunk barrier the seq watermark rides
                # into pop_run so post-shrink events rest in the lane
                run = ln.pop_run(snap.get(pid, -1)
                                 if (snap is not None and t == W_eff)
                                 else None)
                width = len(run)
                if width > 1:
                    stats["batched_drains"] += 1
                    if width > stats["max_batch_width"]:
                        stats["max_batch_width"] = width
                for (t, s, kind, payload) in run:
                    if self.validate and not defunct and ln is not self._grave:
                        assert payload[0] in self._pindex.parts.get(pid, ()), \
                            f"lane {pid} executed foreign flow {payload[0]}"
                    _exec_packet_event(self, t, kind, payload)
                    if self._split_log:
                        # a completion split this (or another) lane: adopt
                        # the residual lanes into the window's working set.
                        # Already-popped run events still execute here, in
                        # order — they are same-t with the smallest seqs, so
                        # everything the split redistributed (renumbered
                        # compactly, order-preserving) and everything newly
                        # scheduled sorts after them, exactly as serially.
                        for old_pid, new_pids in self._split_log:
                            if old_pid not in pids:
                                continue
                            pids.discard(old_pid)
                            defunct = defunct or old_pid == pid
                            for p2 in new_pids:
                                pids.add(p2)
                                l2 = self._lanes.get(p2)
                                if l2 is not None and l2.heap:
                                    heapq.heappush(
                                        frontier,
                                        (l2.heap[0][0], l2.heap[0][1], p2))
                        self._split_log.clear()
                    # a new global event inside the window shrinks the
                    # barrier; the watermark freezes "scheduled before it"
                    # per lane (the run's own events predate the shrink by
                    # construction, so finishing it stays exact)
                    if gheap and gheap[0][0] < W_eff:
                        W_eff = gheap[0][0]
                        snap = {}
                        # sorted: watermark snapshot order is pid order
                        for p2 in sorted(pids):
                            l2 = (self._lanes.get(p2) if p2 != GRAVE
                                  else self._grave)
                            if l2 is not None:
                                snap[p2] = l2.seq
                if defunct:
                    break          # this lane object is defunct now
            if rebalance and ln.heap:
                heapq.heappush(frontier, (ln.heap[0][0], ln.heap[0][1], pid))
        return W_eff

    # -- parallel fan-out (worker side lives at module level) ------------ #
    def _ensure_pool(self) -> ProcessPoolExecutor:
        if self._pool is None:
            # pools are shared process-wide by worker count (spawn startup
            # is ~0.5 s/worker — per run it would dominate short scenarios
            # and every sweep iteration); the per-topology shell rides with
            # each task and is cached worker-side by shell key
            self._shell_key = next(_SHELL_KEYS)
            self._shell_blob = pickle.dumps(
                (self.topo, {"mtu": self.mtu, "ecn_k": self.ecn_k,
                             "buffer_bytes": self.buffer_bytes,
                             "window": self.window,
                             "sample_interval": self.sample_interval}),
                protocol=pickle.HIGHEST_PROTOCOL)
            self._pool = _shared_pool(max(1, self.intra_workers - 1))
        return self._pool

    def _dispatch(self, bins: list[list[_Lane]], W: float, until: float):
        """Ship each bin of heavy lanes as one worker task (a single
        submit/collect round-trip per worker per window) and return the
        futures — the parent overlaps its own bin while they run."""
        pool = self._ensure_pool()
        futures = []
        for group in bins:
            tasks = []
            for ln in group:
                fids = sorted(self._pindex.parts[ln.pid])
                ports = set()
                for fid in fids:
                    ports |= self._pindex.flow_ports[fid]
                # sorted ports: the pickled task payload is byte-stable
                # across runs, not a function of set order
                tasks.append((ln.pid,
                              {fid: self.flows[fid] for fid in fids},
                              ln.heap, ln.seq,
                              {p: float(self.busy_until[p])
                               for p in sorted(ports)},
                              {p: float(self.port_txbytes[p])
                               for p in sorted(ports)},
                              self.record_rtt_fids.intersection(fids)))
            futures.append(pool.submit(
                _worker_run_lanes, self._shell_key, self._shell_blob,
                pickle.dumps((W, until, tasks),
                             protocol=pickle.HIGHEST_PROTOCOL)))
        return futures

    def _merge(self, lanes: list[_Lane], results) -> None:
        lane_by_pid = {ln.pid: ln for ln in lanes}
        stats = self.shard_stats
        for res in results:
            for (pid, flows, lheap, seq, busy, txb, nev, nhop,
                 ndrain, wmax) in res:
                ln = lane_by_pid[pid]
                for fid, f in flows.items():
                    self.flows[fid] = f
                ln.heap = lheap
                ln.seq = seq
                for p, v in busy.items():
                    self.busy_until[p] = v
                for p, v in txb.items():
                    self.port_txbytes[p] = v
                self.events_processed += nev
                self.packet_hop_events += nhop
                stats["dispatched_events"] += nev
                stats["batched_drains"] += ndrain
                if wmax > stats["max_batch_width"]:
                    stats["max_batch_width"] = wmax
        stats["dispatches"] += len(lane_by_pid)

    # ------------------------------------------------------------------ #
    def check_invariants(self) -> None:
        """Lane/partition exclusivity (property tests): every pending lane
        event belongs to its partition's flows, graveyard events only to
        finished flows, and the index satisfies Definition 1."""
        self._pindex.check_invariants()
        for pid, ln in self._lanes.items():
            fids = self._pindex.parts.get(pid)
            if fids is None:
                assert not ln.heap, f"orphan lane {pid} holds events"
                continue
            for (_t, _s, _k, payload) in ln.heap:
                assert payload[0] in fids, \
                    f"lane {pid} holds event of foreign flow {payload[0]}"
        for (_t, _s, _k, payload) in self._grave.heap:
            f = self.flows.get(payload[0])
            assert f is None or f.done, "graveyard holds a live flow's event"

    def shard_report(self) -> dict:
        out = dict(self.shard_stats)
        out["intra_workers"] = self.intra_workers
        out["lanes_live"] = sum(1 for ln in self._lanes.values() if ln.heap)
        return out

    def close(self) -> None:
        # the pool is shared process-wide (see _shared_pool) — just drop
        # the reference; shutdown_pools() tears the executors down
        self._pool = None


# ---------------------------------------------------------------------- #
# shared worker pools: spawn startup (~0.5 s/worker: fresh interpreter +
# numpy import) amortizes across every sharded run in the process instead
# of recurring per ShardedPacketSim
# ---------------------------------------------------------------------- #
_SHELL_KEYS = itertools.count(1)
_POOLS: dict[int, ProcessPoolExecutor] = {}


def _shared_pool(n_workers: int) -> ProcessPoolExecutor:
    pool = _POOLS.get(n_workers)
    if pool is None:
        import atexit
        import multiprocessing
        # spawn, not fork: the parent may hold live CUDA/torch threads
        # (fluid runs earlier in the process); workers import only the
        # packet-path modules, none of which loads torch
        ctx = multiprocessing.get_context("spawn")
        pool = _POOLS[n_workers] = ProcessPoolExecutor(
            max_workers=n_workers, mp_context=ctx)
        if len(_POOLS) == 1:
            atexit.register(shutdown_pools)
    return pool


def shutdown_pools() -> None:
    """Tear down the process-wide lane-worker pools (atexit does this too)."""
    for pool in _POOLS.values():
        pool.shutdown(wait=False, cancel_futures=True)
    _POOLS.clear()


# ---------------------------------------------------------------------- #
# worker side: a bare PacketSim shell executes one lane group per task
# ---------------------------------------------------------------------- #
class _LaneCompleted(Exception):
    """A flow finished inside a worker — the completion-reshape barrier
    belongs to the parent, so the task aborts and the window is redone."""


class _LaneSim(PacketSim):
    # hot class (reprolint H205/C304): adds no attributes of its own
    __slots__ = ()

    def finish_flow(self, f, t: float) -> None:
        raise _LaneCompleted


_SHELLS: dict[int, _LaneSim] = {}   # per-worker cache, keyed by shell key


def _worker_shell(key: int, shell_blob: bytes) -> _LaneSim:
    shell = _SHELLS.get(key)
    if shell is None:
        topo, knobs = pickle.loads(shell_blob)
        if len(_SHELLS) >= 4:        # a handful of live sims is plenty
            _SHELLS.pop(next(iter(_SHELLS)))
        shell = _SHELLS[key] = _LaneSim(topo, **knobs)
    return shell


def _worker_run_lanes(key: int, shell_blob: bytes, blob: bytes) -> bytes:
    """Execute a group of lanes' packet events up to the barrier W
    (exclusive), one lane after another.  Lane state rides in and out
    through pickle; each lane-local seq counter continues exactly where the
    parent left it, so ordering is identical to parent-side execution.
    Returns None (abort) if any lane completes a flow — the completion
    reshape belongs to the parent."""
    W, until, tasks = pickle.loads(blob)
    sim = _worker_shell(key, shell_blob)
    out = []
    aborted = False
    for (pid, flows, lheap, seq, busy, txb, rtt) in tasks:
        sim.flows = flows
        sim.record_rtt_fids = rtt
        sim.events_processed = 0
        sim.packet_hop_events = 0
        sim._heap = lheap             # lane heap IS the worker's only heap
        sim._seq = seq + 1                # next seq value to hand out
        for p, v in busy.items():
            sim.busy_until[p] = v
        for p, v in txb.items():
            sim.port_txbytes[p] = v
        heap = lheap
        ndrain = 0
        wmax = 0
        try:
            while heap and heap[0][0] < W and heap[0][0] <= until:
                # batched run drain (abort discards everything, so popping
                # the run ahead of execution risks nothing)
                t0 = heap[0][0]
                t, _s, kind, payload = heapq.heappop(heap)
                _exec_packet_event(sim, t, kind, payload)
                width = 1
                while heap and heap[0][0] == t0:
                    t, _s, kind, payload = heapq.heappop(heap)
                    _exec_packet_event(sim, t, kind, payload)
                    width += 1
                if width > 1:
                    ndrain += 1
                    if width > wmax:
                        wmax = width
        except _LaneCompleted:
            aborted = True
        if not aborted:
            out.append((pid, flows, heap, sim._seq - 1,
                        {p: float(sim.busy_until[p]) for p in busy},
                        {p: float(sim.port_txbytes[p]) for p in txb},
                        sim.events_processed, sim.packet_hop_events,
                        ndrain, wmax))
        # reset the shell's port state for the next lane/task
        for p in busy:
            sim.busy_until[p] = 0.0
            sim.port_txbytes[p] = 0.0
        sim.now = 0.0
        if aborted:
            break
    sim.flows = {}
    return pickle.dumps(None if aborted else out,
                        protocol=pickle.HIGHEST_PROTOCOL)
