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
import functools
from collections.abc import Callable

import numpy as np

from repro_torch import obs


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

    # ------------------------------------------------------------------ #
    # Routing
    # ------------------------------------------------------------------ #
    @functools.cached_property
    def _hops(self) -> _NextHops:
        """The next-hop table, built at the first route."""
        return _NextHops(self)

    def route(self, src: int, dst: int, flow_id: int) -> list[int]:
        """Deterministic ECMP: shortest path, ties broken by a hash of
        (flow_id, hop) — the same flow always takes the same path, different
        flows spread over the equal-cost fan-out (standard 5-tuple ECMP
        behavior, which is what makes contention patterns *reproducible*,
        the property Wormhole's memoization exploits).  The candidates at a
        hop are the node's neighbours one hop closer to ``dst``, in
        adjacency order: one flow's walk of the next-hop table
        (``_NextHops.path``)."""
        if src == dst:
            return []
        return self._hops.path(src, dst, flow_id)

    def routes(self, fid, src, dst) -> tuple[np.ndarray, np.ndarray]:
        """``route`` for a whole set of flows at once: ``flat``, every flow's
        link ids, flow after flow, and ``hops``, each flow's path length
        (int64; 0 where ``src == dst``).  All flows advance one hop a round
        on the rows of the next-hop table that ``route`` walks
        (``_NextHops.walk``), each hop by ``route``'s hash, so every path is
        ``route``'s.  Ids are int64, or Python ints where int64 does not
        hold them."""
        try:
            fid = np.asarray(fid, np.int64)
        except OverflowError:
            fid = np.asarray(fid, object)
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        out = self._hops.walk(fid, src, dst)
        obs.count("topology.array_routes", len(fid))
        return out


class _NextHops:
    """A topology's equal-cost next hops: the one table that ``route`` and
    ``routes`` walk.

    A destination on one neighbour ``s`` (a host on its cable) is reached
    through ``s``, every other destination is its own root: one BFS a
    root, for the roots of the destinations asked, all at once, kept for
    the object's life.  A root's row holds, for every node, its out-links
    one hop closer to the root in ascending link id (adjacency order), as
    CSR: a count and an offset into one array of link ids.  Toward a
    one-cable ``d`` a path is a walk to ``s`` on ``s``'s row, then one of
    the links into ``d``, which a first section of the table holds by
    destination.  It takes every link to have its reverse, as the
    builders' cables do.  The hop out of ``node`` at step ``step`` takes
    candidate ``(fid * 1000003 + node * 10007 + step * 101) % c`` of its
    ``c``; ``walk`` reduces ``fid`` modulo ``c`` first, which picks the
    same one, so that any integer id hashes in int64."""

    def __init__(self, topo: Topology) -> None:
        self.name = topo.name
        n = self.n = topo.n_nodes
        src = self.link_src = topo.link_src.astype(np.int64)
        dst = self.link_dst = topo.link_dst.astype(np.int64)
        pairs = np.unique(src * n + dst)                   # distinct (node, neighbour)
        one = np.bincount(pairs // n, minlength=n)[pairs // n] == 1
        self.root = np.arange(n)
        self.root[pairs[one] // n] = pairs[one] % n
        self.row = np.full(n, -1)                          # root -> its row
        self.known = np.zeros(n, bool)                     # destinations asked
        self.dist = np.empty((0, n), np.int64)             # each row's hop distances
        self.out = np.argsort(src, kind="stable")          # links by node, then id
        cnt = np.bincount(dst, minlength=n)
        self.cnt, self.off = cnt, np.cumsum(cnt) - cnt
        self.cand = np.argsort(dst, kind="stable")         # the links into each node
        # Python-list copies for ``path``'s one flow at a time, which a numpy
        # scalar read a hop would slow by about half: ``_lists`` extends them to
        # the rows built since, as ``path`` meets a destination
        self.l_root, self.l_known, self.l_row = self.root.tolist(), [False] * n, []
        self.l_cnt, self.l_off, self.l_cand = [], [], []   # the candidates as (link, next node)

    def _ask(self, fresh: list[int]) -> None:
        """Count the destinations ``fresh``, asked for the first time, as
        ``topology.dist_builds``, and build the rows of their roots that the
        table lacks: one BFS from every such root at once."""
        obs.count("topology.dist_builds", len(fresh))
        self.known[fresh] = True
        roots = np.unique(self.root[fresh])
        roots = roots[self.row[roots] < 0]
        if not roots.size:
            return
        n, k = self.n, len(roots)
        dist = np.full((k, n), -1, np.int64)
        dist[np.arange(k), roots] = 0
        front = dist == 0
        level = 0
        while front.any():
            level += 1
            r, lid = np.nonzero(front[:, self.link_src])
            hit = np.zeros(k * n, bool)
            hit[r * n + self.link_dst[lid]] = True
            front = hit.reshape(k, n) & (dist < 0)
            dist[front] = level
        s, d = self.link_src[self.out], self.link_dst[self.out]
        near = dist[:, s]
        r, p = np.nonzero((near > 0) & (dist[:, d] == near - 1))
        cnt = np.bincount(r * n + s[p], minlength=k * n)   # rows in order, nodes in order
        self.row[roots] = len(self.dist) + np.arange(k)
        self.dist = np.concatenate([self.dist, dist])
        self.off = np.concatenate([self.off, len(self.cand) + np.cumsum(cnt) - cnt])
        self.cnt = np.concatenate([self.cnt, cnt])
        self.cand = np.concatenate([self.cand, self.out[p]])

    def _lists(self, dst: int) -> None:
        """Ask for ``dst`` as ``walk`` does, and extend the list copies to the
        rows built since the last call."""
        if not self.known[dst]:
            self._ask([dst])
        i, j = len(self.l_cnt), len(self.l_cand)
        self.l_cnt += self.cnt[i:].tolist()
        self.l_off += self.off[i:].tolist()
        self.l_cand += zip(self.cand[j:].tolist(), self.link_dst[self.cand[j:]].tolist())
        self.l_row = self.row.tolist()
        self.l_known[dst] = True

    def path(self, src: int, dst: int, fid: int) -> list[int]:
        """One flow's links, hop by hop on the rows, as ``walk`` takes them."""
        if not self.l_known[dst]:
            self._lists(dst)
        root = self.l_root[dst]
        key = self.n * (self.l_row[root] + 1)
        cnt, off, cand = self.l_cnt, self.l_off, self.l_cand
        if not cnt[key + src] and src != root:             # no link closer to the root
            raise ValueError(f"no path {src}->{dst} in {self.name}")
        path: list[int] = []
        node = src
        h = fid * 1000003                                  # + step * 101 at each step
        while node != root:
            at = key + node
            lid, node = cand[off[at] + (h + node * 10007) % cnt[at]]
            path.append(lid)
            h += 101
        if node != dst:                                    # into a one-cable dst
            path.append(cand[off[dst] + (h + node * 10007) % cnt[dst]][0])
        return path

    def walk(self, fid: np.ndarray, src: np.ndarray,
             dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Every flow one hop a round, on the rows its destination needs:
        toward its root, then from a one-cable destination's root into it."""
        if not self.known[dst].all():
            self._ask(np.unique(dst[~self.known[dst]]).tolist())
        root = self.root[dst]
        row = self.row[root]
        up = self.dist[row, src]                           # hops to the root
        if (up < 0).any():
            i = int(np.argmax(up < 0))
            raise ValueError(f"no path {src[i]}->{dst[i]} in {self.name}")
        hops = up + (root != dst)
        hops[src == dst] = 0
        pos = np.cumsum(hops) - hops
        flat = np.empty(int(hops.sum()), np.int64)
        node, last, to, key, left = src, root, dst, self.n * (row + 1), hops
        for step in range(hops.max(initial=0)):
            go = left > step
            if not go.all():
                fid, node, last, to, key, pos, left = (
                    x[go] for x in (fid, node, last, to, key, pos, left))
            at = np.where(node == last, to, key + node)    # into dst, else the row
            c = self.cnt[at]
            h = (fid % c).astype(np.int64, copy=False) * 1000003 + node * 10007 + step * 101
            lid = self.cand[self.off[at] + h % c]
            flat[pos] = lid
            node = self.link_dst[lid]
            pos = pos + 1
        return flat, hops


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
