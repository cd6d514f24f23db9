"""Collective → flow decomposition.

Ring collectives are modelled as one steady stream per ring member to its
neighbour carrying the collective's total per-member traffic (the standard
flow-level decomposition used by SimAI/ASTRA-sim: ring steps overlap
perfectly on disjoint links, so the aggregate is a single long flow —
exactly the elephant-flow shape whose steady-state Wormhole fast-forwards):

    all-reduce      : 2·(n-1)/n · bytes   per member → next
    reduce-scatter  :   (n-1)/n · bytes
    all-gather      :   (n-1)/n · bytes
    all-to-all      : bytes/n per ordered pair (n·(n-1) flows)
    p2p             : bytes, one flow

Frozen copy of ``src/repro/workload/collectives.py``, the JAX package's pure-Python
module (no JAX in it), which the port's tests hold the port to; part of
the benchmark's plain reference: its imports are rewritten to stay inside
``simbench``, and it imports neither the program nor the JAX package.
"""
from __future__ import annotations

from simbench.reference.flows import FlowSpec


class FidAlloc:
    def __init__(self, start: int = 0) -> None:
        self._next = start

    def __call__(self) -> int:
        v = self._next
        self._next += 1
        return v


def ring_allreduce(members: list[int], bytes_total: float, fid: FidAlloc,
                   cca: str, tag: str, bidirectional: bool = True) -> list[FlowSpec]:
    n = len(members)
    assert n >= 2
    per = 2 * (n - 1) / n * bytes_total
    if bidirectional:
        per /= 2
    out = []
    for i, src in enumerate(members):
        out.append(FlowSpec(fid(), src, members[(i + 1) % n], per, 0.0, cca, tag))
        if bidirectional:
            out.append(FlowSpec(fid(), src, members[(i - 1) % n], per, 0.0, cca, tag))
    return out


def ring_reduce_scatter(members: list[int], bytes_total: float, fid: FidAlloc,
                        cca: str, tag: str) -> list[FlowSpec]:
    n = len(members)
    per = (n - 1) / n * bytes_total
    return [FlowSpec(fid(), m, members[(i + 1) % n], per, 0.0, cca, tag)
            for i, m in enumerate(members)]


ring_allgather = ring_reduce_scatter  # same traffic shape


def all_to_all(members: list[int], bytes_per_rank: float, fid: FidAlloc,
               cca: str, tag: str) -> list[FlowSpec]:
    n = len(members)
    per = bytes_per_rank / n
    out = []
    for src in members:
        for dst in members:
            if src != dst:
                out.append(FlowSpec(fid(), src, dst, per, 0.0, cca, tag))
    return out


def p2p(src: int, dst: int, bytes_total: float, fid: FidAlloc,
        cca: str, tag: str) -> list[FlowSpec]:
    return [FlowSpec(fid(), src, dst, bytes_total, 0.0, cca, tag)]
