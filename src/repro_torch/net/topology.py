"""Data-center topologies and deterministic ECMP routing.

A topology is a directed multigraph.  Every *directed* link is a "port" in the
paper's terminology (§3.1.1: partitioning happens at port granularity); the
forward and reverse directions of a cable are distinct ports with independent
FIFO queues.

Units: bandwidth in bytes/s, delay in seconds.

The PyTorch port keeps its own copy of ``repro.net.topology``, which the
port may not import; the tests hold the two to identical outputs.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np

@dataclasses.dataclass
class Topology:
    name: str
    n_hosts: int
    n_nodes: int                      # hosts + switches; hosts are 0..n_hosts-1
    link_src: np.ndarray              # int32 [n_links]
    link_dst: np.ndarray              # int32 [n_links]
    link_bw: np.ndarray               # float64 [n_links] bytes/s
    link_delay: np.ndarray            # float64 [n_links] seconds
    # Optional metadata used by placement (rail-optimized topologies).
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.n_links = len(self.link_src)
        # adjacency[node] = list of (link_id, neighbor)
        adj: list[list[tuple[int, int]]] = [[] for _ in range(self.n_nodes)]
        for lid in range(self.n_links):
            adj[int(self.link_src[lid])].append((lid, int(self.link_dst[lid])))
        self.adj = adj
        self._dist_cache: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------ #
    # Routing
    # ------------------------------------------------------------------ #
    def _dist_to(self, dst: int) -> np.ndarray:
        """BFS hop distance from every node to ``dst`` (reverse graph ==
        forward graph here because every cable is bidirectional)."""
        cached = self._dist_cache.get(dst)
        if cached is not None:
            return cached
        dist = np.full(self.n_nodes, np.iinfo(np.int32).max, dtype=np.int32)
        dist[dst] = 0
        frontier = [dst]
        # reverse adjacency equals adjacency for our symmetric builders
        while frontier:
            nxt = []
            for u in frontier:
                du = dist[u]
                for _, v in self.adj[u]:
                    if dist[v] > du + 1:
                        dist[v] = du + 1
                        nxt.append(v)
            frontier = nxt
        self._dist_cache[dst] = dist
        return dist

    def route(self, src: int, dst: int, flow_id: int) -> list[int]:
        """Deterministic ECMP: shortest path, ties broken by a hash of
        (flow_id, hop) — the same flow always takes the same path, different
        flows spread over the equal-cost fan-out (standard 5-tuple ECMP
        behavior, which is what makes contention patterns *reproducible*,
        the property Wormhole's memoization exploits)."""
        if src == dst:
            return []
        dist = self._dist_to(dst)
        if dist[src] >= np.iinfo(np.int32).max:
            raise ValueError(f"no path {src}->{dst} in {self.name}")
        path: list[int] = []
        node = src
        step = 0
        while node != dst:
            cands = [(lid, v) for lid, v in self.adj[node] if dist[v] == dist[node] - 1]
            h = (flow_id * 1000003 + node * 10007 + step * 101) % len(cands)
            lid, node = cands[h]
            path.append(lid)
            step += 1
        return path


# ---------------------------------------------------------------------- #
# Builders.  All create bidirectional cables (two directed links each).
# ---------------------------------------------------------------------- #
def _finish(name: str, n_hosts: int, n_nodes: int, cables: list[tuple[int, int, float, float]],
            meta: dict | None = None) -> Topology:
    src, dst, bw, dly = [], [], [], []
    for a, b, c, d in cables:
        src += [a, b]
        dst += [b, a]
        bw += [c, c]
        dly += [d, d]
    return Topology(
        name=name, n_hosts=n_hosts, n_nodes=n_nodes,
        link_src=np.asarray(src, np.int32), link_dst=np.asarray(dst, np.int32),
        link_bw=np.asarray(bw, np.float64), link_delay=np.asarray(dly, np.float64),
        meta=meta or {},
    )


def fat_tree(k: int, bw: float = 12.5e9, delay: float = 1e-6) -> Topology:
    """Classic 3-tier k-ary fat-tree [Al-Fares et al., SIGCOMM'08]:
    k pods, (k/2)^2 hosts/pod, (k/2)^2 core switches.  Requires even k."""
    assert k % 2 == 0, "fat-tree arity must be even"
    half = k // 2
    n_hosts = k * half * half
    n_edge = k * half
    n_agg = k * half
    n_core = half * half
    edge0 = n_hosts
    agg0 = edge0 + n_edge
    core0 = agg0 + n_agg
    n_nodes = core0 + n_core
    cables: list[tuple[int, int, float, float]] = []
    for pod in range(k):
        for e in range(half):
            edge = edge0 + pod * half + e
            for h in range(half):
                host = pod * half * half + e * half + h
                cables.append((host, edge, bw, delay))
            for a in range(half):
                agg = agg0 + pod * half + a
                cables.append((edge, agg, bw, delay))
        for a in range(half):
            agg = agg0 + pod * half + a
            for c in range(half):
                core = core0 + a * half + c
                cables.append((agg, core, bw, delay))
    return _finish(f"fat_tree_k{k}", n_hosts, n_nodes, cables,
                   meta={"kind": "fat_tree", "k": k, "hosts_per_pod": half * half})


def rail_optimized_fat_tree(n_servers: int, gpus_per_server: int = 8,
                            leaf_radix: int = 32, n_spines: int = 8,
                            bw: float = 12.5e9, delay: float = 1e-6) -> Topology:
    """Rail-optimized fat-tree [NVIDIA SuperPod]: GPU ``r`` of every server
    attaches to rail-``r`` leaves; DP traffic (same GPU index across servers)
    stays inside one rail; cross-rail traffic (EP all-to-all, some PP) rides
    the shared spine layer.  Each GPU is its own host (multi-NIC servers, as
    in the paper's setup §7)."""
    n_hosts = n_servers * gpus_per_server
    leaves_per_rail = max(1, -(-n_servers // leaf_radix))
    n_leaves = gpus_per_server * leaves_per_rail
    leaf0 = n_hosts
    spine0 = leaf0 + n_leaves
    n_nodes = spine0 + n_spines
    cables: list[tuple[int, int, float, float]] = []
    for s in range(n_servers):
        for r in range(gpus_per_server):
            host = s * gpus_per_server + r
            leaf = leaf0 + r * leaves_per_rail + (s // leaf_radix)
            cables.append((host, leaf, bw, delay))
    for leaf in range(leaf0, spine0):
        for sp in range(n_spines):
            cables.append((leaf, spine0 + sp, bw * 2, delay))  # 2x uplink trunks
    return _finish(
        f"roft_s{n_servers}x{gpus_per_server}", n_hosts, n_nodes, cables,
        meta={"kind": "roft", "gpus_per_server": gpus_per_server,
              "n_servers": n_servers, "leaves_per_rail": leaves_per_rail},
    )


def leaf_spine_clos(n_hosts: int, leaf_down: int = 16, n_spines: int = 4,
                    bw: float = 12.5e9, delay: float = 1e-6) -> Topology:
    """2-tier folded Clos (leaf-spine)."""
    n_leaves = -(-n_hosts // leaf_down)
    leaf0 = n_hosts
    spine0 = leaf0 + n_leaves
    n_nodes = spine0 + n_spines
    cables: list[tuple[int, int, float, float]] = []
    for h in range(n_hosts):
        cables.append((h, leaf0 + h // leaf_down, bw, delay))
    for l in range(n_leaves):
        for sp in range(n_spines):
            cables.append((leaf0 + l, spine0 + sp, bw * 2, delay))
    return _finish(f"clos_h{n_hosts}", n_hosts, n_nodes, cables,
                   meta={"kind": "clos", "leaf_down": leaf_down})


TOPOLOGY_BUILDERS: dict[str, Callable[..., Topology]] = {
    "fat_tree": fat_tree,
    "roft": rail_optimized_fat_tree,
    "clos": leaf_spine_clos,
}
