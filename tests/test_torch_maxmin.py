"""The port's max-min solver package against the JAX package's, on the CPU.

The same seeded inputs (``random_case`` of ``tests/test_maxmin.py``) go
through ``repro.kernels.maxmin`` / ``repro.net.{flows,soa}`` and through
their copies in ``repro_torch``:

* the exact float64 solver, its dict oracle and ``FlowTable`` must be
  bit-identical to the reference's (the analytic engine's parity rests on
  it);
* the dense float32 solver's plain version (``maxmin_plain``, what the
  ``maxmin`` wrapper runs on CPU tensors) must be within rtol 1e-6 of the
  reference's jax oracle and of its Pallas kernel in interpret mode, and
  within rtol 1e-4 of the exact solver (the reference's own bars,
  ``tests/test_maxmin.py``).  Not bit-equal: XLA on the CPU contracts the
  oracle's ``cap - r * count`` into one fused multiply-add, while the port
  rounds the multiply and the subtract apart, as its CUDA kernel does.
"""
import random

import numpy as np
import pytest
import torch

from repro.kernels.maxmin import ops as ref_ops
from repro.kernels.maxmin.kernel import maxmin_kernel
from repro.kernels.maxmin.ref import maxmin_ref
from repro.net import flows as ref_flows
from repro.net.soa import FlowTable as RefFlowTable
from repro_torch.kernels.maxmin import ops
from repro_torch.kernels.maxmin import maxmin, maxmin_plain, maxmin_rates_torch
from repro_torch.net import flows
from repro_torch.net.soa import FlowTable
from test_maxmin import random_case

SEEDS = range(24)


def _bitwise(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for fid in want:
        assert got[fid] == want[fid], fid     # bitwise, not approx


# --------------------------------------------------------------------- #
# exact solver, dict oracle, FlowTable: bit for bit
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", SEEDS)
def test_exact_solver_bit_identical_to_reference(seed):
    paths, link_bw = random_case(random.Random(seed))
    fids, links, off = ops.paths_to_arrays(paths)
    ref_fids, ref_links, ref_off = ref_ops.paths_to_arrays(paths)
    assert fids == ref_fids
    np.testing.assert_array_equal(links, ref_links)
    np.testing.assert_array_equal(off, ref_off)
    got = ops.maxmin_rates_arrays(links, off, link_bw)
    want = ref_ops.maxmin_rates_arrays(ref_links, ref_off, link_bw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    want_dict = ref_flows.maxmin_rates_dict(paths, link_bw)
    _bitwise(ops.solve_paths(paths, link_bw), ref_ops.solve_paths(paths, link_bw))
    _bitwise(flows.maxmin_rates(paths, link_bw), ref_flows.maxmin_rates(paths, link_bw))
    got_dict = flows.maxmin_rates_dict(paths, link_bw)
    assert set(got_dict) == set(want_dict)
    for fid in want_dict:
        assert got_dict[fid] == want_dict[fid]
        assert got_dict[fid] == ops.solve_paths(paths, link_bw)[fid]


@pytest.mark.parametrize("seed", SEEDS)
def test_flow_table_bit_identical_to_reference(seed):
    r = random.Random(seed)
    paths, link_bw = random_case(r)
    table, ref_table = FlowTable(), RefFlowTable()
    for fid, p in paths.items():
        table.add(fid, p)
        ref_table.add(fid, p)
    assert len(table) == len(paths) and all(fid in table for fid in paths)
    _bitwise(table.solve_rates(list(paths), link_bw),
             ref_table.solve_rates(list(paths), link_bw))
    # subset solves in the caller's order (the tie-break contract)
    sub = [fid for fid in paths if r.random() < 0.5]
    r.shuffle(sub)
    got = table.solve_rates(sub, link_bw)
    _bitwise(got, ref_table.solve_rates(sub, link_bw))
    assert got == flows.maxmin_rates_dict({fid: paths[fid] for fid in sub}, link_bw)
    for a, b in zip(table.csr(sub), ref_table.csr(sub)):
        np.testing.assert_array_equal(a, b)


def test_flow_table_verify_against():
    class Dummy:
        def __init__(self, path):
            self.path = path

    table = FlowTable()
    table.add(1, [0, 1])
    table.verify_against({1: Dummy([0, 1]), 2: Dummy([5])})
    with pytest.raises(AssertionError, match="diverged"):
        table.verify_against({1: Dummy([0, 2])})


@pytest.mark.parametrize("paths,bw", [
    ({}, [5.0]),                              # no flows
    ({1: []}, [5.0]),                         # only link-less flows
    ({1: [0]}, [0.0]),                        # zero-bandwidth link
    ({1: [0], 2: [0]}, [0.0]),                # shared zero-bw link
    ({1: [0]}, [7.5]),                        # single flow
    ({1: [0], 2: []}, [3.0]),                 # mixed
    ({1: [0, 0], 2: [0]}, [12.0]),            # the duplicate-link quirk
    ({5: [0, 1, 2]}, [9.0, 3.0, 6.0]),        # single flow, its bottleneck
])
def test_degenerate_cases_match_reference(paths, bw):
    got = ops.solve_paths(paths, bw)
    assert got == ref_ops.solve_paths(paths, bw)
    assert got == flows.maxmin_rates_dict(paths, bw)


def test_solver_counters_track_invocations():
    ops.reset_counters()
    ops.solve_paths({1: [0], 2: [0]}, [4.0])
    ops.solve_paths({1: [0]}, [4.0])
    assert ops.SOLVER_COUNTERS == {"invocations": 2, "max_flows": 2}
    fids, links, off = ops.paths_to_arrays({1: [0], 2: [0], 3: [1]})
    maxmin_rates_torch(links, off, [4.0, 2.0], device="cpu")
    maxmin_rates_torch(links, off, [4.0, 2.0], impl="ref", device="cpu")
    assert ops.SOLVER_COUNTERS == {"invocations": 4, "max_flows": 3}
    held = ops.reset_counters()
    assert held == {"invocations": 4, "max_flows": 3}
    assert ops.SOLVER_COUNTERS == {"invocations": 0, "max_flows": 0}


@pytest.mark.parametrize("seed", SEEDS)
def test_incidence_from_csr_bit_identical_to_reference(seed):
    paths, link_bw = random_case(random.Random(seed), simple=True)
    _, links, off = ops.paths_to_arrays(paths)
    inc, cap = ops.incidence_from_csr(links, off, link_bw)
    ref_inc, ref_cap = ref_ops.incidence_from_csr(links, off, link_bw)
    assert inc.dtype == ref_inc.dtype and cap.dtype == ref_cap.dtype
    np.testing.assert_array_equal(inc, ref_inc)
    np.testing.assert_array_equal(cap, ref_cap)


def test_incidence_from_csr_layout():
    _, links, off = ops.paths_to_arrays({1: [4, 2], 2: [2, 9]})
    inc, cap = ops.incidence_from_csr(links, off, {4: 1.0, 2: 2.0, 9: 3.0})
    np.testing.assert_array_equal(cap, np.asarray([1.0, 2.0, 3.0], np.float32))
    np.testing.assert_array_equal(inc, np.asarray([[1, 1, 0], [0, 1, 1]], np.float32))


# --------------------------------------------------------------------- #
# the dense solver's plain version against the jax oracle and kernel
# --------------------------------------------------------------------- #
def _dense(paths, link_bw):
    _, links, off = ops.paths_to_arrays(paths)
    return ops.incidence_from_csr(links, off, link_bw)


def _plain(inc, cap):
    return maxmin_plain(torch.from_numpy(inc), torch.from_numpy(cap)).numpy()


@pytest.mark.parametrize("seed", range(12))
def test_plain_matches_jax_ref_and_exact_solver(seed):
    paths, link_bw = random_case(random.Random(seed), simple=True, allow_zero_bw=False)
    inc, cap = _dense(paths, link_bw)
    got = _plain(inc, cap)
    np.testing.assert_allclose(got, np.asarray(maxmin_ref(inc, cap)), rtol=1e-6)
    _, links, off = ops.paths_to_arrays(paths)
    np.testing.assert_allclose(got, ref_ops.maxmin_rates_arrays(links, off, link_bw),
                               rtol=1e-4)


@pytest.mark.parametrize("seed", range(4))
def test_plain_matches_pallas_kernel_in_interpret_mode(seed):
    paths, link_bw = random_case(random.Random(100 + seed), simple=True)
    inc, cap = _dense(paths, link_bw)
    want = np.asarray(maxmin_kernel(inc, cap, interpret=True))
    np.testing.assert_allclose(_plain(inc, cap), want, rtol=1e-6)


@pytest.mark.parametrize("case", ["zero_bw", "single_flow", "no_links"])
def test_plain_degenerate_cases_match_jax(case):
    paths, bw, want = {
        "zero_bw": ({1: [0, 1], 2: [1]}, [5.0, 0.0], [0.0, 0.0]),
        "single_flow": ({1: [0]}, [7.0], [7.0]),
        "no_links": ({1: [], 2: []}, [7.0], [1e12, 1e12]),
    }[case]
    inc, cap = _dense(paths, bw)
    got = _plain(inc, cap)
    np.testing.assert_allclose(got, np.asarray(maxmin_ref(inc, cap)), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got, np.asarray(maxmin_kernel(inc, cap, interpret=True)),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    _, links, off = ops.paths_to_arrays(paths)
    for impl in ("kernel", "ref"):
        np.testing.assert_allclose(maxmin_rates_torch(links, off, bw, impl=impl, device="cpu"),
                                   want, rtol=1e-6, atol=1e-9)


def test_plain_at_10k_flows():
    """The reference's ceiling case (tests/test_maxmin.py): 10k flows, 128
    links, 3 distinct links per flow."""
    rng = np.random.default_rng(11)
    F, L = 10_000, 128
    links = rng.random((F, L)).argpartition(3, axis=1)[:, :3].astype(np.int64).ravel()
    off = np.arange(0, 3 * (F + 1), 3, dtype=np.int64)
    bw = rng.uniform(1e9, 1e10, L)
    got = maxmin_rates_torch(links, off, bw, impl="ref", device="cpu")
    assert got.dtype == np.float32 and got.shape == (F,)
    np.testing.assert_allclose(got, ref_ops.maxmin_rates_jax(links, off, bw, impl="ref"),
                               rtol=1e-6)
    exact = ref_ops.maxmin_rates_arrays(links, off, bw)
    np.testing.assert_allclose(got, exact, rtol=1e-4)
    # the wrapper takes the plain version for CPU tensors: same bits
    np.testing.assert_array_equal(maxmin_rates_torch(links, off, bw, device="cpu"), got)
    # one round per distinct rate: the early exit the kernel takes
    inc, cap = ops.incidence_from_csr(links, off, bw)
    _, rounds = maxmin_plain(torch.from_numpy(inc), torch.from_numpy(cap), with_rounds=True)
    assert int(rounds) == len(np.unique(exact)) < L


def test_maxmin_wrapper_on_cpu_is_the_plain_version():
    paths, link_bw = random_case(random.Random(3), simple=True, allow_zero_bw=False)
    inc, cap = _dense(paths, link_bw)
    launches = maxmin.launches
    got, rounds = maxmin(torch.from_numpy(inc).double(), torch.from_numpy(cap),
                         with_rounds=True)
    want, want_rounds = maxmin_plain(torch.from_numpy(inc), torch.from_numpy(cap),
                                     with_rounds=True)
    assert maxmin.launches == launches
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert int(rounds) == int(want_rounds) >= 1
    with pytest.raises(ValueError, match=r"inc \[F, L\]"):
        maxmin(torch.ones(3), torch.ones(3))
    with pytest.raises(ValueError, match=r"inc \[F, L\]"):
        maxmin(torch.ones(2, 3), torch.ones(2))
    with pytest.raises(TypeError, match="floating-point"):
        maxmin(torch.ones(2, 3, dtype=torch.int32), torch.ones(3))


def test_maxmin_rates_torch_refuses_to_leave_the_card(monkeypatch):
    _, links, off = ops.paths_to_arrays({1: [0]})
    with pytest.raises(ValueError, match="unknown impl"):
        maxmin_rates_torch(links, off, [1.0], impl="pallas", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for impl in ("kernel", "ref"):
        with pytest.raises(RuntimeError, match="none is available"):
            maxmin_rates_torch(links, off, [1.0], impl=impl)


# --------------------------------------------------------------------- #
# the 0/1 contract, and the bit-packed rounds of the CUDA kernel
# --------------------------------------------------------------------- #
PROBE_INC = np.array([[1, .5], [0, 1], [1, 1]], np.float32)
PROBE_CAP = np.array([10, 6], np.float32)


@pytest.mark.parametrize("bad", [0.5, 2.0, -1.0, float("nan")])
def test_dense_solvers_refuse_a_non_binary_incidence(bad):
    """The reference's oracle weighs an entry by its value (2.4 for every
    flow of the probe); the port's kernel holds the incidence as bits, so
    both its versions refuse anything but 0/1, on the CPU as on the card."""
    np.testing.assert_allclose(np.asarray(maxmin_ref(PROBE_INC, PROBE_CAP)), [2.4] * 3,
                               rtol=1e-6)
    inc = torch.from_numpy(PROBE_INC.copy())
    inc[0, 1] = bad
    cap = torch.from_numpy(PROBE_CAP)
    for solve in (maxmin, maxmin_plain):
        with pytest.raises(ValueError, match="0/1 incidence"):
            solve(inc, cap)
        with pytest.raises(ValueError, match="0/1 incidence"):
            solve(inc, cap, with_rounds=True)


BIG32 = np.float32(3e38)


def _share(cap, users):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(users > 0, cap / np.maximum(users, 1).astype(np.float32), BIG32)


def bitpacked_rounds(inc: np.ndarray, cap: np.ndarray, ctas: int):
    """numpy emulation of ``csrc/maxmin.cu``: the incidence packed into row
    words (bit l % 32 of word l // 32, 4 ceil(L / 128) words a row), the
    flows in ``ctas`` slices that each count the set bits of their newly
    frozen rows as integers, and a replica of the link state updated from
    the summed counts with float32 operations each rounded on its own.
    Returns (rates, rounds)."""
    F, L = inc.shape
    WLp = 4 * -(-L // 128)
    bits = np.zeros((F, 32 * WLp), bool)
    bits[:, :L] = inc != 0
    rows = np.packbits(bits.reshape(F, WLp, 32), axis=-1, bitorder="little").view("<u4")[..., 0]
    n_f = -(-F // ctas)
    slices = [slice(c * n_f, min(F, (c + 1) * n_f)) for c in range(ctas)]

    def counts(flows):                    # each slice's integer counts, summed
        per_cta = [np.unpackbits(rows[s][flows[s]].view(np.uint8), axis=-1,
                                 bitorder="little")[:, :L].sum(0, dtype=np.int64)
                   for s in slices]
        return np.sum(per_cta, axis=0)

    active = np.ones(F, bool)
    rates = np.zeros(F, np.float32)
    users = counts(active)
    cap = cap.astype(np.float32).copy()
    s = _share(cap, users).min()
    rounds = 0
    for _ in range(L):
        if not s < BIG32:
            break
        rounds += 1
        r = np.float32(max(s, np.float32(0.0)))
        sat_bits = np.zeros(32 * WLp, bool)
        sat_bits[:L] = (users > 0) & (_share(cap, users) <= s)
        sat = np.packbits(sat_bits.reshape(WLp, 32), axis=-1, bitorder="little").view("<u4")[:, 0]
        newly = active & ((rows & sat[None, :]) != 0).any(1)
        rates[newly] = r
        active &= ~newly
        c = counts(newly)
        hit = c != 0
        cap[hit] = cap[hit] - (r * c[hit].astype(np.float32)).astype(np.float32)
        users = users - c
        s = _share(cap, users).min()
    rates[active] = np.float32(1e12)
    return rates, rounds


def _emulation_agrees(inc, cap):
    want, want_rounds = maxmin_plain(torch.from_numpy(inc), torch.from_numpy(cap),
                                     with_rounds=True)
    for ctas in (1, 3, 16):
        got, rounds = bitpacked_rounds(inc, cap, ctas)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want.numpy())
        assert rounds == int(want_rounds)


@pytest.mark.parametrize("seed", SEEDS)
def test_bitpacked_rounds_bit_equal_to_plain(seed):
    paths, link_bw = random_case(random.Random(seed), simple=True)
    _emulation_agrees(*_dense(paths, link_bw))


def test_bitpacked_rounds_bit_equal_to_plain_at_10k_flows():
    """The ceiling case, 118 rounds: where one fused multiply-add in the
    capacity update would move 464 of the 10 000 rates."""
    rng = np.random.default_rng(11)
    F, L = 10_000, 128
    links = rng.random((F, L)).argpartition(3, axis=1)[:, :3].astype(np.int64).ravel()
    off = np.arange(0, 3 * (F + 1), 3, dtype=np.int64)
    inc, cap = ops.incidence_from_csr(links, off, rng.uniform(1e9, 1e10, L))
    _emulation_agrees(inc, cap)
