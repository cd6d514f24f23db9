"""Flow Conflict Graph (paper §4.2) and weighted-isomorphism matching (§4.4).

FCG abstracts an unsteady partition: vertices are flows (labelled with a
bucketised instantaneous rate + CCA + bottleneck-bandwidth class), edges join
flows sharing ≥1 link (weight = number of shared links).  Absolute paths and
spatial positions are deliberately dropped (§4.2: "the resulting error is
negligible") — that is what makes recurring collective phases collide into
the same key.

Matching = two stages, as in the paper:
  1. cheap structural filter — a Weisfeiler-Leman canonical hash buckets
     candidates (mismatched vertex/edge counts or label multisets never meet);
  2. exact weighted graph isomorphism (VF2-style backtracking over WL colors)
     that also returns the vertex mapping needed to apply the memoized value.

Copy of ``repro.core.fcg``, which the port may not import.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections.abc import Sequence

RATE_BUCKET = 0.025   # vertex rate weights quantised to 2.5% of line rate


def stable_hash(obj) -> int:
    """Process-stable 48-bit hash of a (nested) tuple of ints/strings.

    ``hash()`` is salted per interpreter (PYTHONHASHSEED), which would make
    WL colors — and therefore SimDB bucket keys — meaningless the moment an
    FCG is persisted to disk or shipped to a worker process.  Every key that
    can outlive this process must come from here."""
    digest = hashlib.blake2b(repr(obj).encode(), digest_size=6).digest()
    return int.from_bytes(digest, "big") & 0x7FFFFFFFFFFF


@dataclasses.dataclass
class FCG:
    n: int
    labels: list[tuple]                 # per-vertex (cca, rate_bucket, bw_bucket)
    edges: dict[tuple[int, int], int]   # (i<j) -> #shared links
    fids: list[int]                     # vertex -> flow id (not part of the key)
    wl_colors: list[int] = dataclasses.field(default_factory=list)
    key: int = 0

    def nbytes(self) -> int:
        """Approximate storage footprint (Fig 9b accounting)."""
        return 24 * self.n + 12 * len(self.edges) + 16

    def refresh(self) -> None:
        """(Re)derive the WL colors and the canonical bucket key from the
        labels + edges.  Deterministic across processes (stable_hash)."""
        self.wl_colors = _wl_refine(self.labels, self.edges)
        self.key = stable_hash((
            self.n, len(self.edges),
            tuple(sorted(self.wl_colors)),
            tuple(sorted(self.edges.values())),
        ))

    # ------------------------------------------------------------------ #
    # serialization (SimDB persistence): labels/edges/fids are the data,
    # colors + key are recomputed on load so a DB always matches the
    # canonicalisation of the code that reads it
    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        return {
            "n": self.n,
            "labels": [list(l) for l in self.labels],
            "edges": [[i, j, w] for (i, j), w in sorted(self.edges.items())],
            "fids": list(self.fids),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FCG":
        g = cls(
            n=int(d["n"]),
            labels=[tuple(l) for l in d["labels"]],
            edges={(int(i), int(j)): int(w) for i, j, w in d["edges"]},
            fids=[int(f) for f in d["fids"]],
        )
        g.refresh()
        return g


def _wl_refine(labels: Sequence[tuple], edges: dict[tuple[int, int], int],
               rounds: int = 3) -> list[int]:
    n = len(labels)
    adj: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for (i, j), w in edges.items():
        adj[i].append((j, w))
        adj[j].append((i, w))
    colors = [stable_hash(l) for l in labels]
    for _ in range(rounds):
        colors = [
            stable_hash((colors[i], tuple(sorted((colors[j], w) for j, w in adj[i]))))
            for i in range(n)
        ]
    return colors


def build_fcg(fids: Sequence[int], flow_ports: dict[int, frozenset[int]],
              rates: dict[int, float], line_rates: dict[int, float],
              ccas: dict[int, str],
              rtts: dict[int, float] | None = None) -> FCG:
    order = sorted(fids)
    labels: list[tuple] = []
    for fid in order:
        lr = max(line_rates[fid], 1.0)
        rb = int(round(rates[fid] / (lr * RATE_BUCKET)))
        # beyond-paper robustness: an RTT class keeps transients from being
        # replayed across very different path lengths (the paper drops path
        # length entirely — exact on its symmetric fabrics, §4.2; the class
        # collapses to one value there so hit rates are unaffected)
        rtt_b = int(round((rtts or {}).get(fid, 0.0) / 2e-6))
        labels.append((ccas[fid], rb, int(round(lr / 1e9)), rtt_b))
    edges: dict[tuple[int, int], int] = {}
    for a in range(len(order)):
        pa = flow_ports[order[a]]
        for b in range(a + 1, len(order)):
            shared = len(pa & flow_ports[order[b]])
            if shared:
                edges[(a, b)] = shared
    g = FCG(n=len(order), labels=labels, edges=edges, fids=list(order))
    g.refresh()
    return g


def isomorphism(a: FCG, b: FCG) -> dict[int, int] | None:
    """Exact weighted-isomorphism a→b respecting labels + edge weights.
    Returns {vertex_in_a: vertex_in_b} or None.  Partitions are small
    (EP degree caps them at ≤128 flows, §3.1.1) so backtracking is cheap —
    WL colors prune almost all branching."""
    if a.n != b.n or len(a.edges) != len(b.edges):
        return None
    if sorted(a.wl_colors) != sorted(b.wl_colors):
        return None

    adj_a: list[dict[int, int]] = [dict() for _ in range(a.n)]
    adj_b: list[dict[int, int]] = [dict() for _ in range(b.n)]
    for (i, j), w in a.edges.items():
        adj_a[i][j] = w
        adj_a[j][i] = w
    for (i, j), w in b.edges.items():
        adj_b[i][j] = w
        adj_b[j][i] = w

    # candidates per a-vertex: equal label AND equal WL color
    cand = [
        [v for v in range(b.n) if b.labels[v] == a.labels[u] and b.wl_colors[v] == a.wl_colors[u]]
        for u in range(a.n)
    ]
    if any(not c for c in cand):
        return None
    order = sorted(range(a.n), key=lambda u: (len(cand[u]), -len(adj_a[u])))
    mapping: dict[int, int] = {}
    used: set[int] = set()

    def bt(k: int) -> bool:
        if k == a.n:
            return True
        u = order[k]
        for v in cand[u]:
            if v in used:
                continue
            ok = True
            for un, w in adj_a[u].items():
                vn = mapping.get(un)
                if vn is not None and adj_b[v].get(vn) != w:
                    ok = False
                    break
            if ok and sum(1 for un in adj_a[u] if un in mapping) != \
                    sum(1 for vn2 in adj_b[v] if vn2 in used):
                ok = False
            if ok:
                mapping[u] = v
                used.add(v)
                if bt(k + 1):
                    return True
                del mapping[u]
                used.discard(v)
        return False

    return dict(mapping) if bt(0) else None
