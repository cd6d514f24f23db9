"""Port-level network partitioning (paper §3.1.1, §4.1, Appendix A/E).

Definition 1: flows sharing a port, together with all ports their paths
traverse, form one partition.  Equivalently: connected components of the
bipartite flow↔port graph.  ``network_partitioner`` is the from-scratch
Algorithm 1 (iterative DFS — recursion-free for large graphs);
``PartitionIndex`` maintains partitions incrementally under flow entry/exit
(Algorithm 2, Appendix E).

Copy of ``repro.core.partition``, which the port may not import.
"""
from __future__ import annotations

import itertools
from collections.abc import Iterable, Mapping


def construct_bipartite_graph(flow_ports: Mapping[int, frozenset[int]]):
    """connections: flow id -> ports, port -> flow ids (Algorithm 1 l.1-7)."""
    port_to_flows: dict[int, list[int]] = {}
    for fid, ports in flow_ports.items():
        for p in ports:
            port_to_flows.setdefault(p, []).append(fid)
    return port_to_flows


def network_partitioner(flow_ports: Mapping[int, frozenset[int]]) -> list[set[int]]:
    """Algorithm 1: connected components via DFS over the bipartite graph.
    O(N + M) with N flows, M ports."""
    port_to_flows = construct_bipartite_graph(flow_ports)
    visited_f: set[int] = set()
    visited_p: set[int] = set()
    partitions: list[set[int]] = []
    for start in flow_ports:
        if start in visited_f:
            continue
        comp: set[int] = set()
        stack: list[tuple[bool, int]] = [(True, start)]  # (is_flow, id)
        while stack:
            is_flow, v = stack.pop()
            if is_flow:
                if v in visited_f:
                    continue
                visited_f.add(v)
                comp.add(v)
                for p in flow_ports[v]:
                    if p not in visited_p:
                        stack.append((False, p))
            else:
                if v in visited_p:
                    continue
                visited_p.add(v)
                for g in port_to_flows.get(v, ()):
                    if g not in visited_f:
                        stack.append((True, g))
        partitions.append(comp)
    return partitions


class PartitionObserver:
    """Callback protocol for structures that shadow the partition lifecycle
    (e.g. the sharded event loop's per-partition lanes): ``add_flow`` emits
    one merge event, ``remove_flow`` one split event.  Callbacks fire *after*
    the index reflects the change, so observers may query it freely."""

    def on_partition_merge(self, fid: int, new_pid: int,
                           merged_pids: set[int]) -> None: ...

    def on_partition_split(self, fid: int, old_pid: int,
                           new_parts: list[tuple[int, set[int]]]) -> None: ...


class PartitionIndex:
    """Incremental partition maintenance (Algorithm 2).

    Tracks {pid -> flows}, {flow -> pid}, {port -> pid} and the per-flow port
    sets.  ``add_flow`` merges every partition the new flow touches;
    ``remove_flow`` re-partitions only the residual flows of the leaving
    flow's partition (worst case degrades to Algorithm 1 on that subset).
    An optional :class:`PartitionObserver` mirrors merges/splits — the
    sharded event loop keys its lanes off this exact lifecycle."""

    GRANULARITIES = ("packet", "flow")

    def __init__(self) -> None:
        self._pid = itertools.count(1)
        self.parts: dict[int, set[int]] = {}
        self.flow_pid: dict[int, int] = {}
        self.flow_ports: dict[int, frozenset[int]] = {}
        self.port_pid: dict[int, int] = {}
        # simulation granularity tag per partition (the hybrid backend's
        # per-partition fidelity control): merges reset to "packet" (new
        # contention pattern), splits inherit (contention only shrank)
        self.granularity: dict[int, str] = {}
        self.observer: PartitionObserver | None = None

    # ------------------------------------------------------------------ #
    def set_granularity(self, pid: int, gran: str) -> None:
        if gran not in self.GRANULARITIES:
            raise ValueError(f"unknown granularity {gran!r}; "
                             f"have {self.GRANULARITIES}")
        if pid not in self.parts:
            raise KeyError(f"no partition {pid}")
        self.granularity[pid] = gran

    def ports_of(self, pid: int) -> set[int]:
        out: set[int] = set()
        for fid in self.parts[pid]:
            out |= self.flow_ports[fid]
        return out

    def affected_partitions(self, ports: Iterable[int]) -> set[int]:
        return {self.port_pid[p] for p in ports if p in self.port_pid}

    # ------------------------------------------------------------------ #
    def add_flow(self, fid: int, ports: frozenset[int]) -> tuple[int, set[int]]:
        """Insert a flow; returns (new_pid, set of merged old pids)."""
        assert fid not in self.flow_pid, f"flow {fid} already present"
        affected = self.affected_partitions(ports)
        merged_flows = {fid}
        for pid in affected:
            merged_flows |= self.parts.pop(pid)
            self.granularity.pop(pid, None)
        self.flow_ports[fid] = ports
        new_pid = next(self._pid)
        self.parts[new_pid] = merged_flows
        self.granularity[new_pid] = "packet"
        # sorted: flow_pid/port_pid insertion order becomes a pure function
        # of the flow ids, not of set-merge history
        for g in sorted(merged_flows):
            self.flow_pid[g] = new_pid
            for p in sorted(self.flow_ports[g]):
                self.port_pid[p] = new_pid
        if self.observer is not None:
            self.observer.on_partition_merge(fid, new_pid, affected)
        return new_pid, affected

    def remove_flow(self, fid: int) -> tuple[int, list[tuple[int, set[int]]]]:
        """Remove a flow; returns (old_pid, [(new_pid, flows)...] splits)."""
        old_pid = self.flow_pid.pop(fid)
        ports = self.flow_ports.pop(fid)
        rest = self.parts.pop(old_pid)
        gran = self.granularity.pop(old_pid, "packet")
        rest.discard(fid)
        for p in ports:
            if self.port_pid.get(p) == old_pid:
                del self.port_pid[p]
        new_parts: list[tuple[int, set[int]]] = []
        if rest:
            # residual may split: rerun Algorithm 1 locally (Appendix E)
            # sorted: component discovery order (and therefore pid
            # assignment) is a pure function of the flow ids
            for comp in network_partitioner(
                    {g: self.flow_ports[g] for g in sorted(rest)}):
                new_pid = next(self._pid)
                self.parts[new_pid] = comp
                self.granularity[new_pid] = gran
                for g in sorted(comp):
                    self.flow_pid[g] = new_pid
                    for p in sorted(self.flow_ports[g]):
                        self.port_pid[p] = new_pid
                new_parts.append((new_pid, comp))
        if self.observer is not None:
            self.observer.on_partition_split(fid, old_pid, new_parts)
        return old_pid, new_parts

    # ------------------------------------------------------------------ #
    def check_invariants(self) -> None:
        """Partition invariants (used by property tests):
        1. partitions are disjoint and cover every flow;
        2. no port is traversed by flows of two different partitions;
        3. incremental state matches a from-scratch Algorithm 1 run."""
        seen: set[int] = set()
        for pid, flows in self.parts.items():
            assert flows, f"empty partition {pid}"
            assert not (flows & seen), "partitions overlap"
            seen |= flows
            for f in flows:
                assert self.flow_pid[f] == pid
        assert seen == set(self.flow_pid)
        port_seen: dict[int, int] = {}
        for fid, ports in self.flow_ports.items():
            pid = self.flow_pid[fid]
            for p in ports:
                assert port_seen.setdefault(p, pid) == pid, "port shared across partitions"
        fresh = {frozenset(c) for c in network_partitioner(self.flow_ports)}
        incr = {frozenset(c) for c in self.parts.values()}
        assert fresh == incr, "incremental drifted from Algorithm 1"
        assert set(self.granularity) == set(self.parts), \
            "granularity tags out of sync with partitions"
        assert all(g in self.GRANULARITIES for g in self.granularity.values())
