"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions; the fluid engine and the serving path through them
against their CPU runs.

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
from repro_torch.kernels.flash_attention import attention_plain, flash_attention
from repro_torch.kernels.maxmin import (maxmin, maxmin_plain, maxmin_rates_arrays,
                                        maxmin_rates_torch)
from repro_torch.kernels.maxmin.ops import plan
from repro_torch.kernels.steady_scan import steady_scan, steady_scan_plain
from repro_torch.launch import serve
from repro_torch.models.api import build_model
from repro_torch.net.fluid import fluid_run

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
    n_phases = sum(1 for ph in scn.build_phases() if ph.flows)
    cca_step.launches = fluid_scan.launches = steady_scan.launches = 0
    card = run(scn, backend="fluid")                 # the card is the default
    # one scan per phase, its steady detector fused into it
    assert (fluid_scan.launches, steady_scan.launches) == (n_phases, 0)
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
    engine on the card, one fluid_scan per phase (one per wave)."""
    topo = TopologySpec("roft", {"n_servers": 8, "gpus_per_server": 4, "leaf_radix": 8,
                                 "n_spines": 2})
    flows = [FlowSpec(w * 32 + r * 8 + s, s * 4 + r, ((s + 1) % 8) * 4 + r, size=6e6,
                      start=w * 0.02, tag=f"ring{w}")
             for w in range(2) for r in range(4) for s in range(8)]
    scn = Scenario("ring", topo, flows=flows)
    n_phases = sum(1 for ph in scn.build_phases() if ph.flows)
    fluid_scan.launches = 0
    cmp = compare(scn, backends=("packet", "fluid"))
    assert fluid_scan.launches == n_phases == 2
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
])
def test_flash_attention_kernel_bf16(cuda, B, Hq, Hk, S, D, causal, window):
    """The tensor-core kernel at every float32 case's shape and mask, the
    reference's bf16 case and granite-3-2b's prefill shape, at the bf16 bar."""
    q, k, v = _flash_inputs(B, Hq, Hk, S, D, cuda, torch.bfloat16)
    launches = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(),
                               attention_plain(q, k, v, causal=causal, window=window).float(),
                               rtol=2e-2, atol=2e-2)


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
    params = _to(cpu_params, cuda)
    prompt = torch.tensor(RNG.integers(0, m.cfg.vocab, (2, 40)))
    launches = flash_attention.launches
    logits, cache = m.prefill(params, {"tokens": prompt.to(cuda)})
    assert flash_attention.launches == launches + m.cfg.n_layers
    want, want_cache = m.prefill(cpu_params, {"tokens": prompt})
    for a, b in [(logits, want), *((cache["stage0"]["b0"][n], want_cache["stage0"]["b0"][n])
                                   for n in "kv")]:
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), err
    res = serve.generate(m, params, prompt.to(cuda), 5)
    assert res.kernel_launches == {"prefill": m.cfg.n_layers, "decode": 0}
    assert res.all_finite
    cpu_res = serve.generate(m, cpu_params, prompt, 5)
    assert torch.equal(res.tokens.cpu(), cpu_res.tokens)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}
