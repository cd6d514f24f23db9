"""Simulation database (paper §4.3/§4.4): memoization of unsteady-state
transients.

    key:   FCG_start            (canonical WL hash buckets + exact iso check)
    value: (FCG_end rates, {Size_f}, T_conv, end_reason)

Only entry/exit snapshots are stored, never packet traces — flow sizes
determine steady durations but are independent of the transient dynamics
(§4.3), so this is sufficient to reconstruct per-flow FCTs.  The whole DB is
O(100KB) at 1024-GPU scale (Fig 9b), lives in memory during a run, and is a
durable artifact between runs: ``save``/``load`` round-trip it through a
versioned JSON file and ``merge`` folds several DBs (e.g. the deltas of
parallel sweep workers) into one warm store (§6.1 multi-experiment reuse).

A DB is stamped with a *fingerprint* of the simulator regime it was recorded
under (MTU, ECN threshold, buffer sizing).  Those knobs shape transient
dynamics but are invisible to the FCG key, so replaying a DB across regimes
would silently corrupt results — ``bind_fingerprint`` (called when a kernel
attaches) and ``merge`` both refuse mismatches instead.

Copy of ``repro.core.memo``, which the port may not import.
"""
from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.core.fcg import FCG, isomorphism

STEADY = "steady"
COMPLETION = "completion"

FORMAT_VERSION = 1

# default completion-match tolerance: ~2 packets at the scaled 1000B MTU;
# callers that know the simulation MTU pass atol=2*mtu instead (a jumbo-frame
# sim would otherwise spuriously reject, a tiny-MTU sim spuriously accept)
_DEFAULT_COMPLETION_ATOL = 2e3
# ...and the absolute slack is additionally capped relative to the flow's
# remaining bytes: 2 MTUs is packet-quantization noise for an elephant but
# ~10% of a 20KB flow, where accepting a near-miss completion transient
# (e.g. recorded under an adjacent sweep variant in a merged multi-variant
# DB) mis-fast-forwards the whole flow
_COMPLETION_RTOL = 0.02


def sim_fingerprint(mtu: float, ecn_k: float, buffer_bytes: float,
                    shared_buffer: float | None = None,
                    sample_interval: float | None = None) -> str:
    """Canonical string for the sim knobs that change transient dynamics or
    their measurement without showing up in the FCG key (CCA/link-speed/RTT
    classes do).  ``sample_interval`` paces the steady-state detector, so the
    stored t_conv / end-rate snapshots are only valid under the cadence they
    were recorded at (its default derives from mtu + line rate, so DBs from
    default-configured sims keep matching across topologies)."""
    shared = "none" if shared_buffer is None else f"{shared_buffer:g}"
    si = "default" if sample_interval is None else f"{sample_interval:g}"
    return (f"mtu={mtu:g};ecn_k={ecn_k:g};buf={buffer_bytes:g};"
            f"shared={shared};si={si}")


@dataclasses.dataclass(slots=True)
class MemoEntry:
    fcg: FCG                       # FCG_start (the key graph)
    end_rates: list[float]         # FCG_end vertex weights, by key-graph vertex
    sizes: list[float]             # bytes transferred during the transient
    t_conv: float                  # measured convergence time (s)
    end_reason: str                # STEADY | COMPLETION
    mean_backlog: float = 0.0      # mean bottleneck-port backlog at exit
    completed: tuple[int, ...] = ()  # key-graph vertices that completed at t_conv
    hits: int = 0

    def nbytes(self) -> int:
        # end_rates and sizes are equal-length float lists; completed is a
        # small int tuple — all three are stored, so all three are counted
        return (self.fcg.nbytes() + 16 * len(self.end_rates)
                + 16 * len(self.sizes) + 8 * len(self.completed) + 32)

    def to_dict(self) -> dict:
        return {
            "fcg": self.fcg.to_dict(),
            "end_rates": list(self.end_rates),
            "sizes": list(self.sizes),
            "t_conv": self.t_conv,
            "end_reason": self.end_reason,
            "mean_backlog": self.mean_backlog,
            "completed": list(self.completed),
            "hits": self.hits,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MemoEntry":
        return cls(
            fcg=FCG.from_dict(d["fcg"]),
            end_rates=[float(r) for r in d["end_rates"]],
            sizes=[float(s) for s in d["sizes"]],
            t_conv=float(d["t_conv"]),
            end_reason=str(d["end_reason"]),
            mean_backlog=float(d.get("mean_backlog", 0.0)),
            completed=tuple(int(v) for v in d.get("completed", ())),
            hits=int(d.get("hits", 0)),
        )


@dataclasses.dataclass(slots=True)
class MemoHit:
    entry: MemoEntry
    mapping: dict[int, int]        # stored vertex -> current vertex


class SimDBMismatch(ValueError):
    """The DB was recorded under a different simulator regime or an
    incompatible on-disk format — refusing to replay it silently."""


class SimDB:
    """Hash-bucketed store with exact weighted-isomorphism verification."""

    def __init__(self, fingerprint: str | None = None) -> None:
        self._buckets: dict[int, list[MemoEntry]] = {}
        self._log: list[MemoEntry] = []    # runtime inserts, in order
        self.fingerprint = fingerprint
        self.inserts = 0
        self.lookups = 0
        self.hits = 0

    # ------------------------------------------------------------------ #
    def insert(self, entry: MemoEntry) -> None:
        self._buckets.setdefault(entry.fcg.key, []).append(entry)
        self._log.append(entry)
        self.inserts += 1

    def _add(self, entry: MemoEntry) -> None:
        """Pre-existing knowledge (load/merge): bucketed but not counted as
        a runtime insert and not part of any delta."""
        self._buckets.setdefault(entry.fcg.key, []).append(entry)

    def lookup(self, fcg: FCG, remaining: list[float],
               atol: float | None = None) -> MemoHit | None:
        """Find an isomorphic stored transient whose per-flow transfer fits
        within the current flows' remaining bytes (otherwise the stored
        transient would run past a completion event and be semantically
        different — fall through to packet simulation).

        ``atol`` is the completion-match tolerance in bytes; pass ~2 MTUs of
        the running simulation (the kernel does) so the guard scales with
        the packet size instead of assuming 1500B frames."""
        if atol is None:
            atol = _DEFAULT_COMPLETION_ATOL
        self.lookups += 1
        for entry in self._buckets.get(fcg.key, ()):  # WL structural filter
            m = isomorphism(entry.fcg, fcg)
            if m is None:
                continue
            if any(entry.sizes[u] > remaining[v] + 1e-6 for u, v in m.items()):
                continue
            if entry.end_reason == COMPLETION:
                # the stored transient *ends with* these vertices completing:
                # replaying it is only semantically equivalent if the mapped
                # flows run out of bytes at the same point (within ~2 packets,
                # and never more than a few % of the flow)
                if any(abs(entry.sizes[u] - remaining[m[u]])
                       > min(atol, max(_COMPLETION_RTOL * remaining[m[u]], 1.0))
                       for u in entry.completed):
                    continue
            entry.hits += 1
            self.hits += 1
            return MemoHit(entry=entry, mapping=m)
        return None

    # ------------------------------------------------------------------ #
    # regime binding
    # ------------------------------------------------------------------ #
    def bind_fingerprint(self, fingerprint: str) -> None:
        """Adopt the simulator-regime fingerprint, or refuse if this DB was
        recorded under a different one (never silently replay across MTU /
        ECN / buffer regimes)."""
        if self.fingerprint is None:
            self.fingerprint = fingerprint
        elif self.fingerprint != fingerprint:
            raise SimDBMismatch(
                f"SimDB was recorded under {self.fingerprint!r} but the "
                f"attaching simulation runs {fingerprint!r}; load/merge a DB "
                f"from the matching regime instead")

    # ------------------------------------------------------------------ #
    # deltas (parallel sweep workers ship newly inserted entries back)
    # ------------------------------------------------------------------ #
    def mark(self) -> int:
        """Position token for ``entries_since`` — take one before a run."""
        return len(self._log)

    def entries_since(self, mark: int) -> list[MemoEntry]:
        return self._log[mark:]

    def entries(self):
        for bucket in self._buckets.values():
            yield from bucket

    # ------------------------------------------------------------------ #
    # persistence + merging
    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        return {
            "format_version": FORMAT_VERSION,
            "fingerprint": self.fingerprint,
            "entries": [e.to_dict() for e in self.entries()],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SimDB":
        version = d.get("format_version")
        if version != FORMAT_VERSION:
            raise SimDBMismatch(
                f"SimDB format_version {version!r} is not the supported "
                f"{FORMAT_VERSION}; re-record the DB with this code version")
        db = cls(fingerprint=d.get("fingerprint"))
        for ed in d.get("entries", ()):
            db._add(MemoEntry.from_dict(ed))
        return db

    def save(self, path: str) -> None:
        """Durable JSON snapshot (atomic rename so readers never see a
        half-written DB)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "SimDB":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    @classmethod
    def load_or_new(cls, path: str | None) -> "SimDB":
        """Load ``path`` if it exists, else start a fresh DB — the shared
        open-for-warm-start semantics of campaigns and served stores."""
        if path is not None and os.path.exists(path):
            return cls.load(path)
        return cls()

    def merge(self, other: "SimDB") -> int:
        """Fold ``other``'s entries in, dropping duplicates — entries whose
        key graphs are weighted-isomorphic to an existing entry with matching
        per-flow sizes and t_conv (the same transient memoized twice, e.g.
        by two cold parallel workers).  Returns the number of entries added."""
        if other.fingerprint is not None:
            self.bind_fingerprint(other.fingerprint)
        added = 0
        for entry in other.entries():
            if self._duplicate(entry) is None:
                self._add(entry)
                added += 1
        return added

    @staticmethod
    def _sized_fcg(fcg: FCG, sizes: list[float]) -> FCG:
        """The key graph with per-vertex transient sizes folded into the
        labels, so dedup matching searches over size-respecting mappings
        (a bare isomorphism may return a mapping that misaligns sizes on
        symmetric graphs even when an aligned one exists)."""
        g = FCG(n=fcg.n,
                labels=[l + (round(s),) for l, s in zip(fcg.labels, sizes)],
                edges=dict(fcg.edges), fids=list(fcg.fids))
        g.refresh()
        return g

    def _duplicate(self, entry: MemoEntry) -> MemoEntry | None:
        sized = None
        for cand in self._buckets.get(entry.fcg.key, ()):
            if cand.end_reason != entry.end_reason:
                continue
            if abs(cand.t_conv - entry.t_conv) > 1e-6 * max(cand.t_conv,
                                                            entry.t_conv):
                continue
            if isomorphism(entry.fcg, cand.fcg) is None:
                continue
            if sized is None:
                sized = self._sized_fcg(entry.fcg, entry.sizes)
            if isomorphism(sized, self._sized_fcg(cand.fcg, cand.sizes)) \
                    is not None:
                return cand
        return None

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return sum(len(b) for b in self._buckets.values())

    def nbytes(self) -> int:
        return sum(e.nbytes() for b in self._buckets.values() for e in b) + 48 * len(self._buckets)

    def stats(self) -> dict:
        return {
            "entries": len(self), "bytes": self.nbytes(),
            "lookups": self.lookups, "hits": self.hits, "inserts": self.inserts,
            "hit_rate": self.hits / max(1, self.lookups),
        }
