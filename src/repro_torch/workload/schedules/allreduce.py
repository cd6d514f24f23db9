"""Staged allreduce schedules.

Every builder has the same shape::

    builder(members, bytes_total, fid, cca, tag, topo_meta=None)
        -> list[(step_name, [FlowSpec, ...])]

``members`` are host/rank ids, ``bytes_total`` is the full gradient buffer
per rank, ``fid`` a callable id allocator (``collectives.FidAlloc``), and
``topo_meta`` the topology's builder params (``Scenario.topology.params``)
— only the hierarchical schedule reads it, to discover rail/leaf locality
on the rail-optimized fat-tree.  Steps are strictly ordered: all flows of
step k-1 finish before step k starts (the caller encodes that as phase
dependencies), which is what distinguishes these from the flat overlapped
ring in ``workload/collectives.py``.

The PyTorch port keeps its own copy of
``repro.workload.schedules.allreduce``, which the port may not import; the
tests hold the two to identical outputs.
"""
from __future__ import annotations

from repro_torch.net.flows import FlowSpec
from repro_torch.workload import collectives as C
from repro_torch.workload.traffic import Phase

# step: (name, flows) — flows of one step run concurrently, steps run in order
Step = tuple[str, list[FlowSpec]]


def ring_allreduce_steps(members, bytes_total, fid, cca="dctcp", tag="ar",
                         topo_meta=None):
    """The baseline: one step holding the flat bidirectional ring."""
    del topo_meta
    return [(tag, C.ring_allreduce(members, bytes_total, fid, cca, tag))]


def tree_allreduce(members, bytes_total, fid, cca="dctcp", tag="ar",
                   topo_meta=None):
    """Binomial-tree allreduce: log2(n) reduce rounds into members[0], then
    the mirrored broadcast rounds back out.

    Round d pairs rank i with rank i+d (i a multiple of 2d); the full
    buffer moves on every hop, so the root's last reduce hop and first
    broadcast hop are the serial bottleneck — cheap for latency-bound
    (small) buffers, 2*bytes_total*log-ish on the wire for large ones.
    """
    del topo_meta
    n = len(members)
    if n < 2:
        raise ValueError(f"tree allreduce needs >= 2 members, got {n}")
    up_rounds: list[list[FlowSpec]] = []
    d = 1
    while d < n:
        flows = []
        for i in range(0, n, 2 * d):
            j = i + d
            if j < n:
                flows.append(FlowSpec(fid(), members[j], members[i],
                                      bytes_total, 0.0, cca, tag))
        if flows:
            up_rounds.append(flows)
        d *= 2
    steps: list[Step] = [(f"{tag}.up{k}", fl) for k, fl in enumerate(up_rounds)]
    for k, fl in enumerate(reversed(up_rounds)):
        steps.append((f"{tag}.down{k}",
                      [FlowSpec(fid(), f.dst, f.src, bytes_total, 0.0, cca, tag)
                       for f in fl]))
    return steps


def halving_doubling_allreduce(members, bytes_total, fid, cca="dctcp",
                               tag="ar", topo_meta=None):
    """Recursive halving-doubling: log2(n) reduce-scatter rounds over XOR
    pairs (payload halves each round), then log2(n) allgather rounds back
    (payload doubles).  Total bytes per rank = 2(n-1)/n * bytes_total, the
    same optimality as the ring but in log rounds instead of n-1.
    """
    del topo_meta
    n = len(members)
    if n < 2 or n & (n - 1):
        raise ValueError(
            f"halving-doubling needs a power-of-two group, got {n} members")
    steps: list[Step] = []
    d, size, k = n // 2, bytes_total / 2, 0
    while d >= 1:
        steps.append((f"{tag}.rs{k}",
                      [FlowSpec(fid(), members[i], members[i ^ d], size,
                                0.0, cca, tag) for i in range(n)]))
        d //= 2
        size /= 2
        k += 1
    d, size, k = 1, bytes_total / n, 0
    while d < n:
        steps.append((f"{tag}.ag{k}",
                      [FlowSpec(fid(), members[i], members[i ^ d], size,
                                0.0, cca, tag) for i in range(n)]))
        d *= 2
        size *= 2
        k += 1
    return steps


def hierarchical_allreduce(members, bytes_total, fid, cca="dctcp", tag="ar",
                           topo_meta=None):
    """Locality-aware 3-stage allreduce on the rail-optimized fat-tree:
    local ring reduce-scatter -> cross-group ring allreduce of the shards
    -> local ring allgather.

    Locality cascades: members are grouped by rail (``host %
    gpus_per_server``) when they span several rails, else by leaf switch,
    else — when the whole group already shares one locality domain, the
    common case for this repo's rail-local DP groups — into equal
    contiguous chunks of the ring, which still converts one n-wide ring
    into parallel short rings plus a thin cross-ring exchange.  Groups
    must come out equal-sized (the shard exchange pairs i-th locals).
    """
    n = len(members)
    if n < 2:
        raise ValueError(f"hierarchical allreduce needs >= 2 members, got {n}")
    meta = topo_meta or {}
    gps = int(meta.get("gpus_per_server", 8))
    leaf_radix = int(meta.get("leaf_radix", 32))
    subs = _bucket(members, lambda h: h % gps)
    if len(subs) == 1:
        subs = _bucket(members, lambda h: (h // gps) // leaf_radix)
    if len(subs) == 1:
        width = _mid_divisor(n)
        subs = [list(members[i:i + width]) for i in range(0, n, width)]
    sizes = {len(s) for s in subs}
    if len(sizes) != 1:
        raise ValueError(
            "hierarchical allreduce needs equal-size locality groups, got "
            f"sizes {sorted(len(s) for s in subs)} for members {list(members)}")
    m = sizes.pop()
    if len(subs) == 1:
        # degenerate (prime-size single-domain group): plain ring
        return [(tag, C.ring_allreduce(subs[0], bytes_total, fid, cca, tag))]
    steps: list[Step] = []
    if m >= 2:
        flows = []
        for sub in subs:
            flows += C.ring_reduce_scatter(sub, bytes_total, fid, cca, tag)
        steps.append((f"{tag}.rs", flows))
    flows = []
    for i in range(m):
        flows += C.ring_allreduce([sub[i] for sub in subs], bytes_total / m,
                                  fid, cca, tag)
    steps.append((f"{tag}.xg", flows))
    if m >= 2:
        flows = []
        for sub in subs:
            flows += C.ring_allgather(sub, bytes_total, fid, cca, tag)
        steps.append((f"{tag}.ag", flows))
    return steps


SCHEDULES = {
    "ring": ring_allreduce_steps,
    "tree": tree_allreduce,
    "halving_doubling": halving_doubling_allreduce,
    "hierarchical": hierarchical_allreduce,
}


def allreduce_steps(collective, members, bytes_total, fid, cca="dctcp",
                    tag="ar", topo_meta=None):
    """Dispatch to a registered schedule by name."""
    try:
        builder = SCHEDULES[collective]
    except KeyError:
        raise ValueError(f"unknown collective {collective!r}; "
                         f"choose from {sorted(SCHEDULES)}") from None
    return builder(members, bytes_total, fid, cca=cca, tag=tag,
                   topo_meta=topo_meta)


def steps_to_phases(steps, deps=None, compute=0.0):
    """Chain ordered steps into sequential :class:`Phase` objects — step 0
    takes ``deps`` (and ``compute``), each later step depends on its
    predecessor."""
    phases: list[Phase] = []
    for k, (name, flows) in enumerate(steps):
        phases.append(Phase(name, flows,
                            list(deps or []) if k == 0 else [k - 1],
                            compute if k == 0 else 0.0))
    return phases


def _bucket(members, key):
    groups: dict = {}
    for m in members:
        groups.setdefault(key(m), []).append(m)
    return [groups[k] for k in sorted(groups)]


def _mid_divisor(n: int) -> int:
    """Smallest divisor of n that is >= sqrt(n) (n itself when n is prime)."""
    d = int(n ** 0.5)
    while d > 1 and n % d:
        d -= 1
    return n // d
