"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions; the fluid engine, the serving path and the training path
through them against their CPU runs; the learned engine's fit and predict
on the card against the CPU.

Every test here takes the ``cuda`` fixture and skips where there is no
card.  The file imports no JAX (the machine with the card has none); the
JAX parity of the plain versions is ``tests/test_torch_kernels.py``,
``tests/test_torch_fluid.py``, ``tests/test_torch_flash.py`` and
``tests/test_torch_models.py``.  On the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import (FlowSpec, Scenario, TopologySpec, compare, run, run_many,
                              training_scenario)
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.cca_step import cca_step, cca_step_plain, fluid_scan, fluid_scan_plain
from repro_torch.kernels.cca_step.ops import workspace_bytes
from repro_torch.kernels.flash_attention import (attention_backward_plain, attention_plain,
                                                 flash_attention, flash_attention_backward)
from repro_torch.kernels.flash_attention.ops import _forward as flash_forward
from repro_torch.kernels.maxmin import (maxmin, maxmin_plain, maxmin_rates_arrays,
                                        maxmin_rates_torch)
from repro_torch.kernels.maxmin.ops import plan
from repro_torch.kernels.steady_scan import steady_scan, steady_scan_plain
from repro_torch.launch import serve
from repro_torch.learned import build_dataset, fit, heldout_fct_error
from repro_torch.learned import model as learned_model
from repro_torch.models.api import build_model
from repro_torch.models.crosscheck import (card_vs_cpu, grads_card_vs_cpu, tame,
                                           to_device, train_batch)
from repro_torch.models.params import leaves, map_tree
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import TrainConfig, make_train_step
from repro_torch.net.fluid import fluid_run
from test_torch_fluid_memo import distinct_solves

pytestmark = pytest.mark.gpu
RNG = np.random.default_rng(5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in full float32
    return torch.device("cuda")


def _cca_inputs(F, L, batch=(), device="cpu"):
    """tests/test_kernels.py's state distribution."""
    M = (RNG.random((*batch, F, L)) < 0.3).astype(np.float32)
    M[..., 0] = 1.0
    f = lambda lo, hi, n: RNG.uniform(lo, hi, (*batch, n))
    a = dict(R=f(1e8, 1e10, F), W=f(1e4, 1e6, F), alpha=f(0, 1, F),
             delivered=f(0, 1e6, F), size=f(5e5, 2e6, F),
             line=np.full((*batch, F), 12.5e9), rtt0=f(5e-6, 2e-5, F),
             M=M, q=f(0, 2e5, L), bw=np.full((*batch, L), 12.5e9))
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in a.items()}


@pytest.mark.parametrize("F,L,B", [(1, 1, None), (64, 64, None), (129, 96, None),
                                   (1024, 400, None), (100, 40, 16)])
def test_cca_step_kernel_matches_plain(cuda, F, L, B):
    a = _cca_inputs(F, L, batch=(B,) if B else (), device=cuda)
    launches = cca_step.launches
    out = cca_step(**a, dt=1e-5)
    ref = cca_step_plain(**a, dt=1e-5)
    torch.cuda.synchronize()
    assert cca_step.launches == launches + 1
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=1e-5, atol=1e-3)


def test_cca_step_kernel_refuses_a_non_contiguous_input(cuda):
    a = _cca_inputs(64, 32, device=cuda)
    M_t = a["M"].T.contiguous().T                      # same values, column-major
    with pytest.raises(ValueError, match="contiguous"):
        cca_step(**{**a, "M": M_t}, dt=1e-5)


SCAN_KEYS = ("M", "line", "rtt0", "size", "bw", "W", "alpha", "delivered", "q")
# the histories' bar (tests/test_torch_fluid.py): rtol 1e-4, and one byte
# of atol on byte counts (queues, delivered)
SCAN_ATOL = {"queues": 1.0, "queue_hist": 1.0, "delivered": 1.0}
SMEM_OPTIN = 232_448          # an H100 block's shared memory limit, bytes


def _assert_scan_close(out, ref):
    for k, r in ref.items():
        torch.testing.assert_close(out[k], r, rtol=1e-4, atol=SCAN_ATOL.get(k, 0.0),
                                   msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.parametrize("steps", [1, 200])
@pytest.mark.parametrize("F,L,B", [(1, 1, None), (64, 64, None), (129, 96, None),
                                   (1024, 400, None), (100, 40, 16), (4096, 2048, None)])
def test_fluid_scan_kernel_matches_plain(cuda, F, L, B, steps):
    """From a mid-run state; 4096 x 2048's workspace exceeds shared memory,
    so it runs from the global scratch buffer."""
    if (F, L) == (4096, 2048):
        assert workspace_bytes(F, L) > SMEM_OPTIN
    elif F <= 1024:
        assert workspace_bytes(F, L) <= SMEM_OPTIN
    a = _cca_inputs(F, L, batch=(B,) if B else (), device=cuda)
    args = [a[k] for k in SCAN_KEYS]
    launches = fluid_scan.launches
    out = fluid_scan(*args, dt=1e-5, steps=steps)
    ref = fluid_scan_plain(*args, dt=1e-5, steps=steps)
    torch.cuda.synchronize()
    assert fluid_scan.launches == launches + 1
    assert out["rate_hist"].shape == ((B,) if B else ()) + (steps, F)
    _assert_scan_close(out, ref)


@pytest.mark.parametrize("steps", [1, 200])
@pytest.mark.parametrize("F,L,B", [(1, 1, None), (64, 64, None), (129, 96, None),
                                   (1024, 400, None), (100, 40, 16), (4096, 2048, None)])
def test_fluid_scan_window_is_bit_equal_to_steady_scan(cuda, F, L, B, steps):
    """The scan's fused detector against the stand-alone kernel (K3) over
    the scan's own rate history, at every scan case: bit for bit, and the
    window leaves the scan's other outputs as they were."""
    a = _cca_inputs(F, L, batch=(B,) if B else (), device=cuda)
    args = [a[k] for k in SCAN_KEYS]
    w = max(1, steps // 10)
    launches = fluid_scan.launches, steady_scan.launches
    out = fluid_scan(*args, dt=1e-5, steps=steps, window=w)
    assert (fluid_scan.launches, steady_scan.launches) == (launches[0] + 1, launches[1])
    fl, mn = steady_scan(out["rate_hist"].transpose(-1, -2), w)
    torch.cuda.synchronize()
    assert torch.equal(out["win_mean"], mn) and torch.equal(out["win_fluct"], fl)
    bare = fluid_scan(*args, dt=1e-5, steps=steps)
    for k, v in bare.items():
        assert torch.equal(out[k], v), k


def test_fluid_scan_window_dead_band_on_card(cuda):
    a = _cca_inputs(300, 120, batch=(2,), device=cuda)
    a["size"][:, :50] = 0.0                          # finished flows: rates pinned at 0
    args = [a[k] for k in SCAN_KEYS]
    out = fluid_scan(*args, dt=1e-5, steps=100, window=30, atol=1e3)
    fl, mn = steady_scan(out["rate_hist"].transpose(-1, -2), 30, atol=1e3)
    assert torch.equal(out["win_mean"], mn) and torch.equal(out["win_fluct"], fl)
    assert bool((out["win_fluct"][:, :50] == 0).all())


def test_fluid_scan_kernel_is_deterministic_and_steps_zero_launches_nothing(cuda):
    a = _cca_inputs(300, 120, batch=(3,), device=cuda)
    args = [a[k] for k in SCAN_KEYS]
    one, two = (fluid_scan(*args, dt=1e-5, steps=200) for _ in range(2))
    for k in one:
        assert torch.equal(one[k], two[k]), k
    launches = fluid_scan.launches
    none = fluid_scan(*args, dt=1e-5, steps=0)
    assert fluid_scan.launches == launches
    assert none["rate_hist"].shape == (3, 0, 300) and torch.equal(none["queues"], a["q"])


def test_fluid_run_is_one_scan_launch(cuda):
    a = _cca_inputs(200, 80, device=cuda)
    scans, steps = fluid_scan.launches, cca_step.launches
    out = fluid_run(a["M"], a["line"], a["rtt0"], a["size"], a["bw"], 1e-5, 200)
    assert (fluid_scan.launches, cca_step.launches) == (scans + 1, steps)
    line, bw = a["line"], a["bw"]
    ref = fluid_scan_plain(a["M"], line, a["rtt0"], a["size"], bw, line * a["rtt0"],
                           torch.ones_like(line), torch.zeros_like(line),
                           torch.zeros_like(bw), dt=1e-5, steps=200)
    _assert_scan_close({"rates": out["rates"], "delivered": out["delivered"],
                        "queues": out["queues"], "rate_hist": out["rate_hist"],
                        "queue_hist": out["queue_hist"]},
                       {k: ref[k] for k in ("rates", "delivered", "queues", "rate_hist",
                                            "queue_hist")})


def test_kernel_wrappers_refuse_a_non_binary_incidence_on_card(cuda):
    a = _cca_inputs(64, 32, device=cuda)
    a["M"][5, 3] = 0.5
    launches = fluid_scan.launches, cca_step.launches
    with pytest.raises(ValueError, match="0/1 incidence"):
        fluid_scan(*(a[k] for k in SCAN_KEYS), dt=1e-5, steps=10)
    with pytest.raises(ValueError, match="0/1 incidence"):
        cca_step(**a, dt=1e-5)
    assert (fluid_scan.launches, cca_step.launches) == launches


def test_steady_scan_kernel_matches_plain(cuda):
    hist = torch.tensor(RNG.uniform(1e8, 1e10, (4, 200, 300)), dtype=torch.float32,
                        device=cuda)
    for h in (hist.transpose(1, 2), hist[0].T, hist[0]):
        launches = steady_scan.launches
        fl, mn = steady_scan(h, 20)
        fr, mr = steady_scan_plain(h, 20)
        assert steady_scan.launches == launches + 1
        torch.testing.assert_close(fl, fr, rtol=1e-4, atol=0.0)
        torch.testing.assert_close(mn, mr, rtol=1e-5, atol=0.0)
    dead = torch.zeros(130, 32, device=cuda)          # crosses a 128-series block
    dead[1] = 1500.0
    dead[2] = torch.linspace(1e8, 1e10, 32, device=cuda)
    fl, _ = steady_scan(dead, 32, atol=2000.0)
    fr, _ = steady_scan_plain(dead, 32, atol=2000.0)
    torch.testing.assert_close(fl, fr, rtol=1e-4, atol=0.0)
    assert float(fl[0]) == 0.0 and float(fl[1]) == 0.0


def _close(a, b):
    assert set(a.fcts) == set(b.fcts)
    for fid, fct in b.fcts.items():
        assert a.fcts[fid] == pytest.approx(fct, rel=1e-4), fid
    assert a.iteration_time == pytest.approx(b.iteration_time, rel=1e-4)


def test_run_on_card_goes_through_the_kernels(cuda):
    scn = training_scenario(n_gpus=32, moe=True)
    distinct = distinct_solves(scn)
    cca_step.launches = fluid_scan.launches = steady_scan.launches = 0
    card = run(scn, backend="fluid")                 # the card is the default
    # one scan per distinct phase, its steady detector fused into it
    assert (fluid_scan.launches, steady_scan.launches) == (distinct, 0)
    assert cca_step.launches == 0
    assert card.extras["device"] == torch.cuda.get_device_name(0)
    _close(card, run(scn, backend="fluid", device="cpu"))


def test_run_many_on_card_is_one_batched_run(cuda):
    topo = TopologySpec("clos", {"n_hosts": 16, "leaf_down": 4, "n_spines": 2})
    scns = [Scenario(f"s{i}", topo, flows=[
        FlowSpec(j, j, 8 + (j + i) % 8, size=1e6 * (i + 1)) for j in range(4 + i)])
        for i in range(4)]
    cca_step.launches = fluid_scan.launches = steady_scan.launches = 0
    card = run_many(scns, backend="fluid", steps=120)
    assert (fluid_scan.launches, steady_scan.launches) == (1, 0)
    assert cca_step.launches == 0
    for a, b in zip(card, run_many(scns, backend="fluid", steps=120, device="cpu")):
        _close(a, b)


def test_compare_packet_against_fluid_on_the_card(cuda):
    """tests/test_wormhole.py's ring workload (8 servers x 4 GPUs, 6 MB per
    flow) through compare(): the packet oracle on the host, the fluid
    engine on the card, one fluid_scan per distinct wave."""
    topo = TopologySpec("roft", {"n_servers": 8, "gpus_per_server": 4, "leaf_radix": 8,
                                 "n_spines": 2})
    flows = [FlowSpec(w * 32 + r * 8 + s, s * 4 + r, ((s + 1) % 8) * 4 + r, size=6e6,
                      start=w * 0.02, tag=f"ring{w}")
             for w in range(2) for r in range(4) for s in range(8)]
    scn = Scenario("ring", topo, flows=flows)
    n_phases = sum(1 for ph in scn.build_phases() if ph.flows)
    fluid_scan.launches = 0
    cmp = compare(scn, backends=("packet", "fluid"))
    assert fluid_scan.launches == distinct_solves(scn) and n_phases == 2
    assert list(cmp.results) == ["packet", "fluid"] and cmp.baseline == "packet"
    assert cmp["fluid"].extras["device"] == torch.cuda.get_device_name(0)
    (row,) = cmp.rows()
    assert row["backend"] == "fluid"
    assert np.isfinite(row["fct_err_mean"]) and np.isfinite(row["fct_err_max"])
    assert set(cmp["fluid"].fcts) == set(cmp["packet"].fcts) == {f.fid for f in flows}


def _maxmin_inputs(F, L, k):
    """k distinct links per flow (simple paths), capacities U(1e9, 1e10)."""
    links = np.argsort(RNG.random((F, L)), axis=1)[:, :k].astype(np.int64).ravel()
    off = np.arange(0, k * (F + 1), k, dtype=np.int64)
    bw = RNG.uniform(1e9, 1e10, L)
    return links, off, bw


def _maxmin_dense(F, L, k, device):
    links, off, bw = _maxmin_inputs(F, L, k)
    inc = torch.zeros(F, L, device=device)
    inc.view(-1)[torch.as_tensor(np.repeat(np.arange(F), k) * L + links, device=device)] = 1.0
    cap = torch.tensor(bw, dtype=torch.float32, device=device)
    cap[0] = 0.0                                       # a zero-bandwidth link
    return inc, cap


# (F, L, links a flow, regime, kernels a solve): moe@1024's largest solve is
# 8064 x 2096; 16384 x 2048's masks (4 MB) exceed a 16-CTA cluster's shared
# memory, so it runs on the cooperative grid.  L % 4 != 0 takes the pack's
# 4-byte loads, in both regimes.
@pytest.mark.parametrize("F,L,k,regime,kernels", [
    (1, 1, 1, "cluster", 1), (7, 5, 2, "cluster", 1), (64, 64, 2, "cluster", 1),
    (128, 192, 3, "cluster", 2), (1000, 37, 4, "cluster", 2), (10_000, 128, 3, "cluster", 2),
    (300, 2100, 6, "cluster", 2),
    (8064, 2096, 4, "cluster", 2), (16_384, 2048, 4, "grid", 1), (16_384, 2047, 4, "grid", 1)])
def test_maxmin_kernel_bit_equal_to_plain(cuda, F, L, k, regime, kernels):
    inc, cap = _maxmin_dense(F, L, k, cuda)
    how = plan(F, L)
    assert (how["regime"], how["kernels"]) == (regime, kernels)
    launches = maxmin.launches
    got, rounds = maxmin(inc, cap, with_rounds=True)
    want, want_rounds = maxmin_plain(inc, cap, with_rounds=True)
    torch.cuda.synchronize()
    assert maxmin.launches == launches + 1
    assert torch.equal(got, want)
    assert int(rounds) == int(want_rounds) <= L


# Past about 19 000 links a block's shared memory no longer holds the grid's
# link replica (12 L bytes), and the grid keeps the link state in global
# memory: the largest L of the first form and the smallest of the second.
@pytest.mark.parametrize("L,global_links", [(19_000, False), (19_200, True), (20_000, True)])
def test_maxmin_grid_link_state_beyond_shared_memory(cuda, L, global_links):
    F = 512
    inc, cap = _maxmin_dense(F, L, 3, cuda)
    how = plan(F, L)
    assert (how["regime"], how["global_links"]) == ("grid", global_links)
    got, rounds = maxmin(inc, cap, with_rounds=True)
    want, want_rounds = maxmin_plain(inc, cap, with_rounds=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(rounds) == int(want_rounds) <= L


def test_maxmin_kernel_refuses_a_non_binary_incidence_on_card(cuda):
    inc = torch.tensor([[1, .5], [0, 1], [1, 1]], device=cuda)
    cap = torch.tensor([10.0, 6.0], device=cuda)
    for solve in (maxmin, maxmin_plain):
        with pytest.raises(ValueError, match="0/1 incidence"):
            solve(inc, cap)
    for F, L in ((10_000, 128), (16_384, 2048), (512, 20_000)):  # pack kernel's; grid's
        big, cap = _maxmin_dense(F, L, 3, cuda)
        big[F - 1, L - 1] = 2.0
        with pytest.raises(ValueError, match="0/1 incidence"):
            maxmin(big, cap)


def test_maxmin_rates_torch_on_card_tracks_the_exact_solver(cuda):
    links, off, bw = _maxmin_inputs(10_000, 128, 3)
    launches = maxmin.launches
    got = maxmin_rates_torch(links, off, bw)            # the card, the kernel
    assert maxmin.launches == launches + 1
    np.testing.assert_allclose(got, maxmin_rates_arrays(links, off, bw), rtol=1e-4)
    np.testing.assert_array_equal(got, maxmin_rates_torch(links, off, bw, impl="ref"))
    no_links = maxmin_rates_torch(np.zeros(0, np.int64), np.zeros(3, np.int64), bw)
    assert maxmin.launches == launches + 1 and (no_links == 1e12).all()


def test_maxmin_kernel_refuses_a_non_contiguous_input(cuda):
    inc = (torch.rand(64, 32, device=cuda) < 0.2).float()
    cap = torch.rand(32, device=cuda) * 1e10
    with pytest.raises(ValueError, match="contiguous"):
        maxmin(inc.T.contiguous().T, cap)
    with pytest.raises(ValueError, match="contiguous"):
        maxmin(inc, torch.rand(64, device=cuda)[::2])


# tests/test_kernels.py:136-143, plus head dim 32 (the reduced configs) and
# a window without the causal mask
FLASH_CASES = [
    (1, 2, 2, 128, 64, True, None),
    (2, 4, 2, 256, 64, True, None),     # GQA 2:1
    (1, 8, 1, 128, 128, True, None),    # MQA
    (1, 4, 4, 200, 64, True, None),     # ragged
    (1, 4, 2, 256, 64, True, 128),      # sliding window
    (1, 2, 2, 256, 64, False, None),    # bidirectional (encoder)
    (2, 4, 2, 77, 32, True, 16),
    (1, 2, 1, 300, 32, False, 40),
]


def _flash_inputs(B, Hq, Hk, S, D, device, dtype=torch.float32):
    return (torch.tensor(RNG.normal(size=(B, Hq, S, D)), dtype=dtype, device=device),
            torch.tensor(RNG.normal(size=(B, Hk, S, D)), dtype=dtype, device=device),
            torch.tensor(RNG.normal(size=(B, Hk, S, D)), dtype=dtype, device=device))


@pytest.mark.parametrize("B,Hq,Hk,S,D,causal,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, B, Hq, Hk, S, D, causal, window):
    q, k, v = _flash_inputs(B, Hq, Hk, S, D, cuda)
    launches = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    torch.testing.assert_close(out, attention_plain(q, k, v, causal=causal, window=window),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,Hq,Hk,S,D,causal,window", [
    *FLASH_CASES,
    (1, 4, 2, 128, 64, True, None),     # tests/test_kernels.py:157-165
    (4, 32, 8, 2048, 64, True, None),   # granite-3-2b's prefill
    (1, 8, 2, 640, 128, True, None),    # a 128-head-dim GQA model's heads
    # every prefill shape of chip_smoke.py's zoo phase
    (2, 20, 20, 1500, 64, False, None),  # whisper-large-v3's encoder: bidirectional, ragged
    (2, 20, 20, 64, 64, True, None),     # whisper-large-v3's decoder: under one 128-row tile
    (2, 32, 16, 2048, 128, True, 1024),  # gemma3-27b's local layers
    (2, 32, 16, 2048, 128, True, None),  # gemma3-27b's global layers
    (1, 48, 8, 4608, 128, True, 4096),   # mixtral-8x22b's sliding window, past its end
    (2, 32, 8, 2048, 128, True, None),   # jamba-v0.1-52b's attention layer
    (2, 56, 8, 1088, 128, True, None),   # llava-next-34b: GQA 7, 576 patches + 512 tokens
])
def test_flash_attention_kernel_bf16(cuda, B, Hq, Hk, S, D, causal, window):
    """The tensor-core kernel at every float32 case's shape and mask, the
    reference's bf16 case, granite-3-2b's prefill shape and the zoo's
    prefill shapes, at the bf16 bar; and each output row within 2e-2 of
    that row's largest |ref|, so rows that average over thousands of keys
    are held to their own scale."""
    q, k, v = _flash_inputs(B, Hq, Hk, S, D, cuda, torch.bfloat16)
    launches = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert out.dtype == torch.bfloat16
    ref = attention_plain(q, k, v, causal=causal, window=window).float()
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
    row_err = (out.float() - ref).abs().amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)
    assert float(row_err.max()) <= 2e-2


def test_flash_attention_kernel_rows_are_convex_combinations(cuda):
    q, k, v = _flash_inputs(1, 2, 2, 128, 64, cuda)
    out = flash_attention(q, k, v)
    assert float(out.max()) <= float(v.max()) + 1e-4
    assert float(out.min()) >= float(v.min()) - 1e-4


def test_flash_attention_kernel_reads_strided_views_in_place(cuda):
    """``[B, S, H, D]`` tensors transposed to ``[B, H, S, D]``, as the layers
    hand them over, and a misaligned view, which the wrapper copies."""
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in _flash_inputs(2, 8, 2, 96, 64, cuda, torch.bfloat16))
    ref = attention_plain(q, k, v, window=33)
    torch.testing.assert_close(flash_attention(q, k, v, window=33), ref, rtol=2e-2, atol=2e-2)
    flat = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda)
    q_odd = flat[1:].view(q.shape).copy_(q)                # 2-byte offset
    torch.testing.assert_close(flash_attention(q_odd, k, v, window=33), ref,
                               rtol=2e-2, atol=2e-2)


def test_reduced_granite_prefill_on_card_matches_cpu(cuda):
    """Weights drawn on the CPU and copied over; float32 (TF32 off).  Logits
    and cache norm-wise at 1e-4 (``tests/test_torch_models.py`` says why
    norm-wise); one kernel launch per layer in prefill, none in decode."""
    m = build_model(ARCHS["granite-3-2b"].reduced())
    cpu_params = m.init(3, device="cpu")
    params = to_device(cpu_params, cuda)
    prompt = torch.tensor(RNG.integers(0, m.cfg.vocab, (2, 40)))
    launches = flash_attention.launches
    logits, cache = m.prefill(params, {"tokens": prompt.to(cuda)})
    assert flash_attention.launches == launches + m.cfg.n_layers
    want, want_cache = m.prefill(cpu_params, {"tokens": prompt})
    for a, b in [(logits, want), *((cache["stage0"]["b0"][n], want_cache["stage0"]["b0"][n])
                                   for n in "kv")]:
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), err
    res = serve.generate(m, params, {"tokens": prompt.to(cuda)}, 5)
    assert res.kernel_launches == {"prefill": m.cfg.n_layers, "decode": 0}
    assert res.all_finite
    cpu_res = serve.generate(m, cpu_params, {"tokens": prompt}, 5)
    assert torch.equal(res.tokens.cpu(), cpu_res.tokens)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_reduced_zoo_on_card_matches_cpu(cuda, name):
    """Every architecture's reduced config in float32 (TF32 off), weights
    drawn on the CPU and copied over: prefill and one decode step, logits
    and every cache leaf, card against CPU norm-wise at 1e-4, and MoE
    logits also at the reference's continuation bar; one kernel launch per
    self-attention layer in prefill, none in decode
    (:func:`repro_torch.models.crosscheck.card_vs_cpu`)."""
    res = card_vs_cpu(name, cuda)
    assert res["ok"], res["failures"]


@pytest.mark.parametrize("op", ["mlstm_scan", "slstm_scan", "slstm_scan_backward"])
def test_recurrent_operator_on_card_matches_cpu(cuda, op):
    """xlstm's recurrence operators at reduced xlstm's widths (4 heads of
    64), 40 steps from a random state: card against CPU norm-wise at 1e-4,
    every output on the card, and no host synchronisation while the
    operator runs (``torch.cuda.set_sync_debug_mode("error")``), so no
    state is copied to the host."""
    g = torch.Generator().manual_seed(9)
    B, S, H, hd = 2, 40, 4, 64
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    if op == "mlstm_scan":
        args = (r(B, S, H, hd), r(B, S, H, hd) / hd ** 0.5, r(B, S, H, hd), r(B, S, H),
                r(B, S, H), r(B, H, hd, hd), r(B, H, hd), r(B, H))
    else:
        args = (r(B, S, 4 * H * hd), r(H, hd, 4 * hd) * 0.5 / hd ** 0.5, r(B, H, hd),
                r(B, H, hd).abs() + 0.5, r(B, H, hd), r(B, H, hd))
        if op == "slstm_scan_backward":
            args += tuple(r(*o.shape) for o in torch.ops.repro_torch.slstm_scan(*args))
    fn = getattr(torch.ops.repro_torch, op)
    want = fn(*args)
    on_card = [a.to(cuda) for a in args]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for out, ref in zip(got, want):
        assert out.device.type == "cuda" and out.shape == ref.shape
        assert float((out.cpu() - ref).abs().max() / ref.abs().max()) <= 1e-4


# --------------------------------------------------------------------- #
# the flash-attention backward and the training path
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hk,S,D,causal,window,strided", [
    *((*case, False) for case in FLASH_CASES),
    (1, 4, 2, 96, 32, True, None, False),       # D 32
    (2, 6, 3, 77, 64, False, None, True),       # bidirectional, GQA, ragged, strided views
    (4, 32, 8, 2048, 64, True, None, True),     # granite-3-2b's training shape, as layers pass it
    (2, 32, 16, 2048, 128, True, 1024, False),  # gemma3-27b's local layers
    (2, 20, 20, 1500, 64, False, None, False),  # whisper-large-v3's encoder
    # the edges of the bf16 kernels' 128-row blocks and 64-row tiles
    (1, 4, 2, 40, 64, True, None, False),       # S below one tile
    (1, 4, 2, 333, 64, True, 100, True),        # ragged S, a window across tiles
    (2, 56, 8, 1088, 128, True, None, False),   # llava-next-34b's heads: GQA 7 at D 128
    (2, 8, 2, 200, 32, True, None, True),       # D 32, strided views
])
def test_flash_attention_backward_kernel_matches_plain(cuda, B, Hq, Hk, S, D, causal, window,
                                                      strided, dtype):
    """The backward kernels from the forward's output and log-sum-exp
    against ``attention_backward_plain`` on the same inputs: dq, dk and dv
    norm-wise 1e-4 in float32, and within 2e-2 of their own largest |ref|
    in bf16; a second launch gives the same bits; the forward's
    log-sum-exp matches the plain one."""
    from repro_torch.kernels.flash_attention import attention_lse_plain
    q, k, v, do = (torch.tensor(RNG.normal(size=(B, S, h, D)), dtype=dtype, device=cuda)
                   .transpose(1, 2) for h in (Hq, Hk, Hk, Hq))
    if not strided:
        q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    kw = dict(causal=causal, window=window)
    o, lse = flash_forward(q, k, v, causal, window, D ** -0.5, True)
    torch.testing.assert_close(lse, attention_lse_plain(q, k, **kw), rtol=1e-5, atol=1e-5)
    launches = flash_attention_backward.launches
    got = flash_attention_backward(q, k, v, o, do, lse, **kw)
    again = flash_attention_backward(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == launches + 2
    ref = attention_backward_plain(q, k, v, o, do, lse, **kw)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, a2, r in zip("qkv", got, again, ref):
        assert a.dtype == dtype and a.shape == r.shape and torch.equal(a, a2), name
        err = float((a.float() - r.float()).abs().max() / r.float().abs().max())
        assert err <= tol, (name, err)


def test_attention_gradients_on_card_reach_the_projections(cuda):
    """A loss on the card trains attention: ``flash_attention`` under
    autograd launches the backward kernel once a layer, and the gradients
    of ``wq``, ``wk`` and ``wv`` are those of the CPU (norm-wise 1e-4)."""
    res = grads_card_vs_cpu("granite-3-2b", cuda)
    assert res["ok"], res["failures"]
    layers = ARCHS["granite-3-2b"].reduced().n_layers
    assert res["launches"] == {"forward": layers, "backward": layers}
    for w in ("wq", "wk", "wv"):
        err = res["errors"][f"grad/stage0/b0/mixer/{w}"]
        assert err["normwise_err"] <= 1e-4


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_reduced_zoo_gradients_on_card_match_cpu(cuda, name):
    """Every architecture's loss and the gradient of every parameter leaf
    on the card against the CPU (:func:`grads_card_vs_cpu`)."""
    res = grads_card_vs_cpu(name, cuda)
    assert res["ok"], res["failures"]


def test_reduced_train_step_on_card_matches_cpu(cuda):
    """One ``make_train_step`` step of reduced granite (microbatches 2,
    float32, tamed weights) on the card against the CPU: loss and gradient
    norm rtol 1e-5, parameters and moments norm-wise 2e-3 (Adam's first
    step divides each gradient entry by its own magnitude;
    ``tests/test_torch_train.py`` says why)."""
    m = build_model(ARCHS["granite-3-2b"].reduced())
    tcfg = TrainConfig(microbatches=2, opt=O.AdamWConfig(lr=1e-3, warmup=0))
    cpu_params = tame(m.init(0, device="cpu"))
    batch = train_batch(m.cfg, 4, 64, seed=1)
    out = {}
    for dev in ("cpu", cuda):
        params = map_tree(lambda t: t.clone().to(dev), cpu_params)   # the step updates in place
        step = make_train_step(m, tcfg)
        params, state, _, loss, gn = step(params, O.init_state(params, tcfg.opt), None,
                                          to_device(batch, dev))
        out[str(dev)] = (float(loss), float(gn), [x.cpu() for x in leaves(params)],
                         [x.cpu() for x in leaves(state["m"])])
    (l0, g0, p0, m0), (l1, g1, p1, m1) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(g1, g0, rtol=1e-5)
    for a, b in (*zip(p1, p0), *zip(m1, m0)):
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())


# --------------------------------------------------------------------- #
# the learned engine's MLP on the card
# --------------------------------------------------------------------- #
def _learned_dataset():
    """tests/test_torch_learned.py's fixture: 16 hybrid flow-fidelity runs
    as records."""
    from types import SimpleNamespace

    from repro_torch.api import run_key, scenario_fingerprint
    records = []
    for i in range(16):
        flows = [FlowSpec(fid, i_ % 4, 12 + (i_ % 2), size=8e6 * (0.5 + 0.1 * i),
                          start=wave, cca="dctcp", tag=f"wave@{wave}")
                 for fid, (wave, i_) in enumerate((w, k) for w in (0.0, 0.02) for k in range(4))]
        scn = Scenario(f"tw{i}", TopologySpec("clos", {"n_hosts": 16, "leaf_down": 4,
                                                       "n_spines": 2}), flows=flows)
        r = run(scn, backend="hybrid", fidelity="flow")
        records.append({"key": run_key(scn, "hybrid", {"fidelity": "flow"}),
                        "backend": "hybrid", "scenario_fingerprint": scenario_fingerprint(scn),
                        "scenario": scn.to_dict(), "result": r.to_dict()})
    return build_dataset(SimpleNamespace(records=lambda: iter(records)))


def test_learned_predict_on_card_matches_cpu(cuda):
    ds = _learned_dataset()
    params = fit(ds, seed=0, hidden=(16, 16), steps=250, device="cpu")
    X = np.concatenate([ds.X, RNG.normal(size=(300, ds.X.shape[1])) * 3.0])
    card = learned_model.predict(params, X)
    cpu = learned_model.predict(params, X, device="cpu")
    np.testing.assert_allclose(card, cpu, rtol=1e-5, atol=1e-6)


def test_learned_fit_on_card_meets_the_bar_and_repeats(cuda):
    """Two fixed-seed fits on the card are identical, and the fit meets the
    reference's held-out bar (tests/test_learned.py:125-128)."""
    ds = _learned_dataset()
    a = fit(ds, seed=0, hidden=(16, 16), steps=250)
    b = fit(ds, seed=0, hidden=(16, 16), steps=250)
    assert a.fingerprint == b.fingerprint
    assert heldout_fct_error(a, ds) < 0.10


def test_learned_engine_runs_on_the_card_by_default(cuda):
    from repro_torch.api import get_engine
    ds = _learned_dataset()
    params = fit(ds, seed=0, hidden=(16, 16), steps=100, device="cpu")
    scn = Scenario.from_dict({
        "name": "query", "topology": {"kind": "clos", "params": {
            "n_hosts": 16, "leaf_down": 4, "n_spines": 2}},
        "flows": [{"fid": f, "src": f % 4, "dst": 12 + f % 2, "size": 9e6,
                   "start": 0.02 * (f // 4), "cca": "dctcp", "tag": "q"} for f in range(8)],
        "kernel": {}, "sim": {}})
    r = get_engine("learned").run(scn, params=params)
    assert r.extras["device"] == torch.cuda.get_device_name(cuda)
    cpu = get_engine("learned").run(scn, params=params, device="cpu")
    assert r.extras["learned"]["params_fingerprint"] == params.fingerprint
    np.testing.assert_allclose(list(r.fcts.values()), list(cpu.fcts.values()), rtol=1e-5)


def test_flash_operator_bit_equal_to_the_kernels_at_granite_training_shape(cuda):
    """K4 through its operator (``repro_torch::flash_attention``, its
    autograd and the backward operator) gives the bits of the kernels
    called directly (``_forward`` with lse, ``flash_attention_backward``),
    at granite's training shape in bf16, from strided ``[B, S, H, D]``
    views as the model hands them over."""
    g = torch.Generator(device="cuda").manual_seed(3)
    mk = lambda H: torch.randn(4, 2048, H, 64, device=cuda, generator=g,  # noqa: E731
                               dtype=torch.bfloat16).transpose(1, 2)
    q, k, v = mk(32), mk(8), mk(8)
    do = torch.randn(4, 32, 2048, 64, device=cuda, generator=g, dtype=torch.bfloat16)
    o_ref, lse = flash_forward(q, k, v, True, None, 64 ** -0.5, True)
    grads_ref = flash_attention_backward(q, k, v, o_ref, do, lse, causal=True)
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    fwd, bwd = flash_attention.launches, flash_attention_backward.launches
    o = flash_attention(qq, kk, vv, causal=True)
    grads = torch.autograd.grad(o, (qq, kk, vv), do)
    torch.cuda.synchronize()
    assert (flash_attention.launches - fwd, flash_attention_backward.launches - bwd) == (1, 1)
    assert torch.equal(o, o_ref)
    for got, want in zip(grads, grads_ref):
        assert torch.equal(got, want)


def test_one_rank_dtensor_step_equals_plain_step(cuda, tmp_path):
    """Reduced granite (remat on, float32) on a 1-rank NCCL group, its
    parameters DTensors on a (1, 1) mesh with the activation constraint
    installed: one ``make_train_step`` step's loss and gradient norm within
    1e-6 of the plain step on the card, and its parameters within 1e-6
    norm-wise.  In a child process, so this one keeps no process group."""
    import json
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    out = tmp_path / "step.json"
    proc = subprocess.run([sys.executable, "-c", _ONE_RANK_STEP, str(out)], cwd=root,
                          env=dict(os.environ, PYTHONPATH=str(root / "src")),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads(out.read_text())
    for key in ("loss", "grad_norm"):
        plain, sharded = res[key]
        assert sharded == pytest.approx(plain, rel=1e-6), (key, res)
    assert res["param_normwise"] <= 1e-6, res
    assert res["launches"] == [[4, 2], [4, 2]], res       # 2 layers, remat: 4 forward, 2 backward


_ONE_RANK_STEP = """
import dataclasses, json, socket, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs.registry import ARCHS
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_backward
from repro_torch.models.api import build_model
from repro_torch.models.crosscheck import tame
from repro_torch.models.params import leaves, map_tree
from repro_torch.parallel import act_sharding
from repro_torch.parallel import sharding as S
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import TrainConfig, make_train_step
torch.backends.cuda.matmul.allow_tf32 = False
cfg = dataclasses.replace(ARCHS["granite-3-2b"].reduced(), remat=True)
m = build_model(cfg)
start = tame(m.init(0))
batch = {k: torch.from_numpy(v).to("cuda", torch.long) for k, v in TokenPipeline(
    vocab=cfg.vocab, seq_len=64, global_batch=4, seed=0).next_batch().items()}
tcfg = TrainConfig(steps=1, opt=O.AdamWConfig(lr=1e-3, warmup=1, total_steps=10))
step = make_train_step(m, tcfg)
res, launches = {}, []
plain = map_tree(torch.clone, start)
flash_attention.launches = flash_attention_backward.launches = 0
plain, _, _, loss1, gn1 = step(plain, O.init_state(plain, tcfg.opt), None, batch)
launches.append([flash_attention.launches, flash_attention_backward.launches])
with socket.socket() as s:
    s.bind(("localhost", 0)); port = s.getsockname()[1]
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
try:
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    rules = S.rules_for(cfg, mesh, "train")
    dp = S.distribute(map_tree(torch.clone, start), m.param_axes(), rules, mesh)
    db = S.distribute(batch, S.batch_axes(batch), rules, mesh)
    spec = S.resolve(("act_batch", "act_seq", None), (4, 64, cfg.d_model),
                     {**rules, "act_seq": "model"}, mesh)
    act_sharding.install(mesh, S.placements(spec, mesh))
    flash_attention.launches = flash_attention_backward.launches = 0
    with implicit_replication():
        dp, _, _, loss2, gn2 = step(dp, O.init_state(dp, tcfg.opt), None, db)
        loss2 = float(loss2.full_tensor()) if hasattr(loss2, "full_tensor") else float(loss2)
    launches.append([flash_attention.launches, flash_attention_backward.launches])
    err = max(float((a.full_tensor() - b).norm() / b.norm().clamp_min(1e-30))
              for a, b in zip(leaves(dp), leaves(plain)))
finally:
    act_sharding.clear()
    dist.destroy_process_group()
json.dump({"loss": [float(loss1), loss2], "grad_norm": [float(gn1), float(gn2)],
           "param_normwise": err, "launches": launches}, open(sys.argv[1], "w"))
"""
