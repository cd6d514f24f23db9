"""Flow specifications handed to the engines by the workload layer, plus
the flow-level max-min fair-share solver the analytic backend is driven by.

Copy of ``repro.net.flows``, which the port may not import."""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence

from repro_torch.kernels.maxmin.ops import solve_paths as _solve_paths


def maxmin_rates(paths: Mapping[int, Sequence[int]], link_bw) -> dict[int, float]:
    """Progressive water-filling: max-min fair-share rates (bytes/s) for
    ``paths`` (flow id -> port ids) over capacities ``link_bw`` (indexable
    by port id).  Repeatedly saturates the most-contended link and freezes
    its flows at the fair share.  Delegates to the exact array solver in
    ``repro_torch.kernels.maxmin`` (bit-identical outputs to
    :func:`maxmin_rates_dict`)."""
    return _solve_paths(paths, link_bw)


def maxmin_rates_dict(paths: Mapping[int, Sequence[int]], link_bw) -> dict[int, float]:
    """The historical scalar dict/set water-filling loop, kept verbatim as
    the parity oracle for the array and dense solvers.  Quirks the array
    solver reproduces bit-for-bit: links enter in first-appearance order
    and ties break toward the earliest link; a link repeated within one
    path counts a single user but has its capacity decremented once per
    occurrence."""
    cap: dict[int, float] = {}
    users: dict[int, set[int]] = {}
    for fid, path in paths.items():
        for l in path:
            users.setdefault(l, set()).add(fid)
            cap.setdefault(l, float(link_bw[l]))
    rates: dict[int, float] = {}
    unfrozen = set(paths)
    while unfrozen:
        best_share, best_link = None, None
        for l, us in users.items():
            if not us:
                continue
            share = cap[l] / len(us)
            if best_share is None or share < best_share:
                best_share, best_link = share, l
        if best_link is None:
            for fid in sorted(unfrozen):  # unconstrained (cannot happen:
                rates[fid] = 1e12         # every flow crosses >= 1 link)
            break
        share = max(best_share, 0.0)
        for fid in list(users[best_link]):
            rates[fid] = share
            unfrozen.discard(fid)
            for l in paths[fid]:
                users[l].discard(fid)
                cap[l] -= share
    return rates


@dataclasses.dataclass
class FlowSpec:
    fid: int
    src: int
    dst: int
    size: float                 # bytes
    start: float = 0.0          # seconds (may be rescheduled by the traffic DAG)
    cca: str = "dctcp"
    tag: str = ""               # e.g. "dp.allreduce.l3" — used for grouping in reports
    phase: int = -1             # traffic-program phase index (-1: standalone)

    def __post_init__(self) -> None:
        if not self.size > 0:
            raise ValueError(f"flow size must be positive, got {self.size}")


@dataclasses.dataclass
class FlowResult:
    fid: int
    start: float
    fct: float                  # flow completion time (seconds, absolute finish - start)
    bytes: float
    tag: str = ""

    @property
    def finish(self) -> float:
        return self.start + self.fct
