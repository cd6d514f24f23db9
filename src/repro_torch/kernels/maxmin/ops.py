"""Max-min water-filling: the exact host solver, the dense device solver's
wrapper with its launch count, and its plain PyTorch version.

Copy of ``repro.kernels.maxmin.ops`` (and its oracle ``ref.py``), which the
port may not import.  One CSR flow-path layout (``path_links`` +
``path_off``, see ``repro_torch.net.soa``) feeds every implementation:

* :func:`maxmin_rates_arrays`: the exact float64 numpy solver, bit-identical
  to the historical dict loop (``repro_torch.net.flows.maxmin_rates_dict``).
  It is what the analytic engine runs, on the host, as the reference does.
* :func:`maxmin_rates_torch`: the dense float32 fixed-point solver on the
  incidence ``[F, L]``, the counterpart of the reference's
  ``maxmin_rates_jax``.  ``impl="kernel"`` goes through :func:`maxmin`, the
  wrapper of the hand-written CUDA kernels ``repro_torch/csrc/maxmin.cu``
  (which replace the Pallas kernel ``_maxmin_kernel`` of
  ``repro/kernels/maxmin/kernel.py``: the incidence packed into bitmasks,
  the rounds in one thread-block cluster or, for masks too large for one,
  a cooperative grid); ``impl="ref"`` through :func:`maxmin_plain`, line
  for line with ``ref.maxmin_ref``.

The dense solvers cover simple paths only (no link repeated within one
path, as every real route is): 0/1 incidence cannot express the dict
loop's per-occurrence capacity decrement.  Both refuse an incidence with
any other value, where the reference's oracle would weigh it.

The exact solver is what the packet family's flow lanes and the learned
features run, down to the sharded loop's spawned workers, so torch (and
``repro_torch.kernels.build``) are imported only inside the dense solvers' functions.
"""
from __future__ import annotations

import ctypes
import functools
from collections.abc import Mapping, Sequence

from typing import TYPE_CHECKING

import numpy as np

from repro_torch.kernels import float32_input

if TYPE_CHECKING:
    import torch

BIG = 3e38                   # sentinel share for user-less links (a float32 value)
NOLINK_RATE = 1e12           # rate for flows that cross no link (dict parity)

# deterministic instrumentation: every solver invocation (any impl) bumps
# these, as the reference's CI counter gate expects
SOLVER_COUNTERS = {"invocations": 0, "max_flows": 0}


def reset_counters() -> dict:
    """Zero the module counters and return the values they held."""
    held = dict(SOLVER_COUNTERS)
    SOLVER_COUNTERS["invocations"] = 0
    SOLVER_COUNTERS["max_flows"] = 0
    return held


def paths_to_arrays(paths: Mapping[int, Sequence[int]]):
    """CSR layout of a ``{fid: [port ids]}`` mapping, preserving the
    mapping's iteration order (the order seeds link first-appearance order,
    which the exact solver's tie-breaks depend on)."""
    fids = list(paths)
    off = np.zeros(len(fids) + 1, dtype=np.int64)
    chunks = []
    for i, fid in enumerate(fids):
        p = paths[fid]
        off[i + 1] = off[i] + len(p)
        if len(p):
            chunks.append(np.asarray(p, dtype=np.int64))
    links = (np.concatenate(chunks) if chunks
             else np.zeros(0, dtype=np.int64))
    return fids, links, off


def _capacities(link_bw, links: np.ndarray) -> np.ndarray:
    """Gather ``link_bw[l]`` for dense link ids — ``link_bw`` is anything
    indexable by port id (ndarray, list, or dict)."""
    if isinstance(link_bw, np.ndarray):
        return link_bw[links].astype(np.float64)
    return np.array([float(link_bw[int(l)]) for l in links], dtype=np.float64)


def _gather_csr(off: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Concatenated entry indices of CSR ``rows`` (vectorized range-concat)."""
    starts = off[rows]
    lens = (off[rows + 1] - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    out = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    return out + np.arange(total, dtype=np.int64)


def _count(F: int) -> None:
    SOLVER_COUNTERS["invocations"] += 1
    if F > SOLVER_COUNTERS["max_flows"]:
        SOLVER_COUNTERS["max_flows"] = F


def maxmin_rates_arrays(path_links: np.ndarray, path_off: np.ndarray,
                        link_bw) -> np.ndarray:
    """Exact progressive water-filling over CSR paths: float64 rates
    (bytes/s) per flow, bit-identical to the historical dict solver.

    ``path_links``: concatenated port ids; ``path_off``: per-flow offsets
    (len F+1); ``link_bw``: capacities indexable by port id.
    """
    F = len(path_off) - 1
    _count(F)
    rates = np.zeros(F, dtype=np.float64)
    if F == 0:
        return rates
    E = int(path_off[-1])
    if E == 0:                      # no flow crosses a link
        rates[:] = NOLINK_RATE
        return rates
    path_links = np.asarray(path_links, dtype=np.int64)
    path_off = np.asarray(path_off, dtype=np.int64)
    # dense link ids in first-appearance order (== dict insertion order)
    uniq, first, inv = np.unique(path_links, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[order] = np.arange(len(uniq), dtype=np.int64)
    dense = rank[inv]               # per path entry: dense link index
    L = len(uniq)
    cap = _capacities(link_bw, uniq[order])
    flow_of_entry = np.repeat(np.arange(F, dtype=np.int64),
                              np.diff(path_off))
    # link -> entries CSR (which flows cross each link)
    by_link = np.argsort(dense, kind="stable")
    link_off = np.searchsorted(dense[by_link], np.arange(L + 1))
    # per-flow *unique* links (the dict kept a set per link, so a repeated
    # link in one path counts one user — but its capacity is decremented
    # once per occurrence, which the raw-entry subtraction below preserves)
    pair = flow_of_entry * L + dense
    upair = np.unique(pair)
    u_link = (upair % L).astype(np.int64)
    u_flow = (upair // L).astype(np.int64)
    u_off = np.searchsorted(u_flow, np.arange(F + 1))
    users = np.bincount(u_link, minlength=L).astype(np.int64)

    unfrozen = np.ones(F, dtype=bool)
    n_left = F
    while n_left:
        with np.errstate(divide="ignore", invalid="ignore"):
            share = np.where(users > 0, cap / users, np.inf)
        best = int(np.argmin(share))
        if users[best] <= 0:        # only link-less flows remain
            rates[unfrozen] = NOLINK_RATE
            break
        s = share[best]
        if s < 0.0:
            s = 0.0
        sel = flow_of_entry[by_link[link_off[best]:link_off[best + 1]]]
        sel = np.unique(sel)
        sel = sel[unfrozen[sel]]
        rates[sel] = s
        unfrozen[sel] = False
        n_left -= len(sel)
        # every decrement this round subtracts the identical scalar ``s``
        # (or integer 1), so the order of repeated updates cannot change
        # the result — np.subtract.at is bit-equal to the dict loop
        np.subtract.at(cap, dense[_gather_csr(path_off, sel)], s)
        np.subtract.at(users, u_link[_gather_csr(u_off, sel)], 1)
    return rates


def solve_paths(paths: Mapping[int, Sequence[int]], link_bw) -> dict[int, float]:
    """Dict-in/dict-out convenience over :func:`maxmin_rates_arrays` —
    the drop-in body of ``repro_torch.net.flows.maxmin_rates``."""
    fids, links, off = paths_to_arrays(paths)
    rates = maxmin_rates_arrays(links, off, link_bw)
    return dict(zip(fids, rates.tolist()))


# ---------------------------------------------------------------------- #
# dense fixed-point solver (incidence [F, L]) on a torch device
# ---------------------------------------------------------------------- #
def incidence_from_csr(path_links: np.ndarray, path_off: np.ndarray,
                       link_bw) -> tuple[np.ndarray, np.ndarray]:
    """Dense ``(incidence [F, L], cap [L])`` float32 arrays over the links
    that actually appear, in first-appearance order — the fixed-shape input
    of the dense solvers."""
    F = len(path_off) - 1
    path_links = np.asarray(path_links, dtype=np.int64)
    if len(path_links) == 0:
        return np.zeros((F, 0), np.float32), np.zeros(0, np.float32)
    uniq, first, inv = np.unique(path_links, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[order] = np.arange(len(uniq), dtype=np.int64)
    dense = rank[inv]
    L = len(uniq)
    inc = np.zeros((F, L), dtype=np.float32)
    flow_of_entry = np.repeat(np.arange(F, dtype=np.int64),
                              np.diff(np.asarray(path_off, dtype=np.int64)))
    inc[flow_of_entry, dense] = 1.0
    cap = _capacities(link_bw, uniq[order]).astype(np.float32)
    return inc, cap


def _check(inc: torch.Tensor, cap: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    inc, cap = float32_input(inc, "inc"), float32_input(cap, "cap")
    if inc.dim() != 2 or cap.dim() != 1 or cap.shape[0] != inc.shape[1]:
        raise ValueError(f"maxmin takes inc [F, L] and cap [L], got "
                         f"{tuple(inc.shape)} and {tuple(cap.shape)}")
    if inc.device != cap.device:
        raise ValueError(f"inc lies on {inc.device}, cap on {cap.device}")
    if inc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {inc.device}")
    return inc, cap


def maxmin_plain(inc: torch.Tensor, cap: torch.Tensor, *,
                 with_rounds: bool = False):
    """``inc``: [F, L] 0/1 flow-over-link incidence; ``cap``: [L] capacities
    (bytes/s).  Returns [F] float32 max-min fair rates (and, with
    ``with_rounds``, a 0-d tensor counting the rounds that froze flows).

    Line for line with the reference's oracle: ``max(L, 1)`` static rounds,
    each saturating every link tied at the smallest fair share ``s`` and
    freezing the flows that cross one at ``max(s, 0)``.  An ``inc`` with a
    value other than 0 or 1 raises ``ValueError``: the kernel holds it as
    bits, so both versions take only a 0/1 incidence."""
    inc, cap = _check(inc, cap)
    if bool(((inc != 0) & (inc != 1)).any()):       # one reduction; syncs on the card
        raise ValueError("maxmin: inc must be a 0/1 incidence")
    import torch
    F, L = inc.shape
    if L == 0:
        rates = torch.full((F,), NOLINK_RATE, dtype=torch.float32, device=inc.device)
        return (rates, torch.zeros((), dtype=torch.int64)) if with_rounds else rates
    big = torch.tensor(BIG, dtype=torch.float32, device=inc.device)
    rates = torch.zeros(F, dtype=torch.float32, device=inc.device)
    active = torch.ones(F, dtype=torch.float32, device=inc.device)
    rounds = torch.zeros((), dtype=torch.int64, device=inc.device)
    for _ in range(max(L, 1)):
        users = (inc * active[:, None]).sum(0)
        share = torch.where(users > 0, cap / users.clamp_min(1.0), big)
        s = share.min()
        sat = ((share <= s) & (users > 0)).float()
        hit = (inc * sat[None, :]).sum(1) > 0
        newly = (active > 0) & hit & (s < big)
        r = s.clamp_min(0.0)
        rates = torch.where(newly, r, rates)
        newly_f = newly.float()
        # a multiply, then a subtract: two roundings, as the kernel does
        dec = r * (inc * newly_f[:, None]).sum(0)
        cap = cap - dec
        active = active * (1.0 - newly_f)
        rounds += (s < big).long()
    rates = torch.where(active > 0, torch.tensor(NOLINK_RATE, dtype=torch.float32,
                                                 device=inc.device), rates)
    return (rates, rounds) if with_rounds else rates


_PLAN_KEYS = ("regime", "cluster", "kernels", "threads", "blocks", "pack_blocks",
              "smem_bytes", "scratch_words", "global_links")


@functools.cache
def _library():
    from repro_torch.kernels.build import load
    cdll = load("maxmin")["maxmin"].cdll
    cdll.maxmin_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    cdll.maxmin_launch.restype = ctypes.c_int
    cdll.maxmin_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    cdll.maxmin_plan.restype = ctypes.c_int
    return cdll


@functools.lru_cache(maxsize=256)
def _plan(F: int, L: int, device_index: int):
    """The kernel's plan for F x L on a card, as the C array that
    ``maxmin_launch`` takes.  Planning sets the kernels' attributes on the
    device and asks the occupancy calculator, which costs more than a
    launch, so each shape is planned once."""
    import torch
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    with torch.cuda.device(device_index):
        err = _library().maxmin_plan(F, L, out)
    if err != 0:
        raise RuntimeError(f"maxmin kernel planning failed for {F} x {L}: CUDA error {err}")
    return out


def plan(F: int, L: int, device=None) -> dict:
    """How the kernel solves an F x L incidence on a card: ``regime``
    ("cluster": one thread-block cluster of ``cluster`` CTAs holds the
    packed incidence in shared memory; "grid": a cooperative grid over
    L2-resident masks, with the link state in each block's shared memory,
    or in global memory where ``global_links``), ``kernels`` launched per
    solve (1, or 2 where a pack kernel over every SM comes first),
    ``threads``, ``blocks``, ``pack_blocks``, ``smem_bytes`` per block and
    ``scratch_words``."""
    import torch
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    how = dict(zip(_PLAN_KEYS, _plan(F, L, index)))
    how["regime"] = ("cluster", "grid")[how["regime"]]
    how["global_links"] = bool(how["global_links"])
    return how


def maxmin_kernel(inc: torch.Tensor, cap: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's launch alone, on contiguous float32 CUDA inputs that
    :func:`maxmin` has checked (F, L >= 1): returns ``rates`` [F] and a
    2-element int32 tensor of the rounds that froze flows and the 0/1
    flag (1: ``inc`` holds another value, and ``rates`` are not written).
    It counts nothing and does not synchronise, so a timing loop may call
    it to time the device's work alone."""
    import torch
    F, L = inc.shape
    dev = inc.device
    how = _plan(F, L, dev.index)
    words = how[_PLAN_KEYS.index("scratch_words")]
    rates = torch.empty(F, dtype=torch.float32, device=dev)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _library().maxmin_launch(inc.data_ptr(), cap.data_ptr(), rates.data_ptr(),
                                       scratch.data_ptr(), words, F, L, how,
                                       torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"maxmin kernel launch failed for {F} x {L}: CUDA error {err}")
    return rates, scratch[-2:]


def maxmin(inc: torch.Tensor, cap: torch.Tensor, *, with_rounds: bool = False):
    """Dense max-min water-filling; returns [F] float32 rates (and, with
    ``with_rounds``, a 0-d tensor of the rounds that froze flows).  Inputs
    are upcast to float32 and must be contiguous, and ``inc`` must be a 0/1
    incidence (``ValueError`` otherwise, on either device).  On CUDA tensors
    this launches the kernel (one solve, counted once in
    ``maxmin.launches``; :func:`plan` says how many kernels it takes) and
    reads its 0/1 flag back, which waits for the solve; on CPU tensors it
    runs :func:`maxmin_plain`.  With no links there is nothing to solve:
    every flow gets ``NOLINK_RATE`` and nothing is launched."""
    import torch
    inc, cap = _check(inc, cap)
    if inc.device.type == "cpu":
        return maxmin_plain(inc, cap, with_rounds=with_rounds)
    F, L = inc.shape
    if L == 0 or F == 0:
        rates = torch.full((F,), NOLINK_RATE, dtype=torch.float32, device=inc.device)
        rounds = torch.zeros((), dtype=torch.int64, device=inc.device)
        return (rates, rounds) if with_rounds else rates
    for k, v in (("inc", inc), ("cap", cap)):
        if not v.is_contiguous():
            raise ValueError(f"maxmin: {k} must be contiguous")
    if F * L >= 2**31:
        raise ValueError(f"maxmin: F*L = {F * L} overflows the kernel's indexing")
    rates, out = maxmin_kernel(inc, cap)
    maxmin.launches += 1
    if int(out[1]) != 0:             # the pack pass's flag; waits for the solve
        raise ValueError("maxmin: inc must be a 0/1 incidence")
    return (rates, out[0].long()) if with_rounds else rates


maxmin.launches = 0


def maxmin_rates_torch(path_links, path_off, link_bw, *, impl: str = "kernel",
                       device=None) -> np.ndarray:
    """Fixed-point max-min over CSR paths on a torch device: the
    counterpart of the reference's ``maxmin_rates_jax``.  float32, within
    about 1e-4 relative of the exact solver on simple paths.

    ``impl="kernel"`` (the default) runs :func:`maxmin`, which launches the
    CUDA kernel on a card and takes the plain version only on the CPU;
    ``impl="ref"`` runs :func:`maxmin_plain` on either.  The reference
    defaults to its oracle; the port defaults to the kernel, so nothing on
    a card takes the plain version unless asked.  ``device=None`` means the
    CUDA card (raises where there is none); pass ``device="cpu"`` for the
    CPU.  Returns numpy float32 [F]."""
    import torch

    from repro_torch.device import resolve_device
    if impl not in ("ref", "kernel"):
        raise ValueError(f"unknown impl {impl!r} (use 'ref' or 'kernel')")
    dev = resolve_device(device)
    _count(len(path_off) - 1)
    inc, cap = incidence_from_csr(path_links, path_off, link_bw)
    inc_t = torch.from_numpy(inc).to(dev)
    cap_t = torch.from_numpy(cap).to(dev)
    solve = maxmin if impl == "kernel" else maxmin_plain
    return solve(inc_t, cap_t).cpu().numpy()
