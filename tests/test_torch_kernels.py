"""The port's kernel modules against the JAX package's oracles.

On the CPU the wrappers run their plain PyTorch versions, which are held
to the reference oracles (``repro.kernels.*.ref``) at the shapes and
tolerances of ``tests/test_kernels.py``.  The hand-written CUDA kernels are
held to the plain versions by the ``gpu``-marked tests in
``tests/test_torch_gpu.py``, which import no JAX so that they run on a
machine with the card, and skip where there is none."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.steady import fluctuation, fluctuation_batch
from repro.kernels.cca_step.ref import cca_step_ref
from repro.kernels.steady_scan.ref import steady_scan_ref
from repro_torch.kernels.cca_step import cca_step, cca_step_plain, fluid_scan, fluid_scan_plain
from repro_torch.kernels.steady_scan import steady_scan, steady_scan_plain

RNG = np.random.default_rng(11)


def _cca_inputs(F, L, batch=()):
    """The reference test's state distribution, as float32 numpy."""
    M = (RNG.random((*batch, F, L)) < 0.3).astype(np.float32)
    M[..., 0] = 1.0
    f = lambda lo, hi, n: RNG.uniform(lo, hi, (*batch, n)).astype(np.float32)
    return dict(
        R=f(1e8, 1e10, F), W=f(1e4, 1e6, F), alpha=f(0, 1, F),
        delivered=f(0, 1e6, F), size=f(5e5, 2e6, F),
        line=np.full((*batch, F), 12.5e9, np.float32), rtt0=f(5e-6, 2e-5, F),
        M=M, q=f(0, 2e5, L), bw=np.full((*batch, L), 12.5e9, np.float32))


def _torch(a, device="cpu", dtype=torch.float32):
    return {k: torch.tensor(v, dtype=dtype, device=device) for k, v in a.items()}


# --------------------------------------------------------------------- #
# cca_step
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("F,L", [(1, 1), (7, 5), (128, 128), (129, 130),
                                 (256, 64), (300, 384)])
def test_cca_step_plain_matches_ref(F, L):
    a = _cca_inputs(F, L)
    launches = cca_step.launches
    out = cca_step(**_torch(a), dt=1e-5)
    ref = cca_step_ref(**{k: jnp.asarray(v) for k, v in a.items()}, dt=1e-5)
    assert cca_step.launches == launches        # CPU tensors: no kernel launch
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=1e-3)


def test_cca_step_batch_is_independent_partitions():
    a = _cca_inputs(40, 24, batch=(3,))
    out = cca_step(**_torch(a), dt=1e-5)
    for b in range(3):
        ref = cca_step_ref(**{k: jnp.asarray(v[b]) for k, v in a.items()}, dt=1e-5)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o[b].numpy(), np.asarray(r), rtol=1e-5, atol=1e-3)


def test_cca_step_conservation_property():
    """Link arrivals equal the incidence-weighted sum of rates; delivered is
    monotone and size-capped; rates stay under line rate."""
    for _ in range(10):
        F, L = int(RNG.integers(1, 200)), int(RNG.integers(1, 150))
        a = _cca_inputs(F, L)
        a["delivered"] = np.minimum(a["delivered"], a["size"])
        R2, W2, a2, d2, arr = cca_step(**_torch(a), dt=2e-5)
        np.testing.assert_allclose(arr.numpy(), R2.numpy() @ a["M"], rtol=1e-4, atol=1.0)
        assert (d2.numpy() >= a["delivered"] - 1e-3).all()
        assert (d2.numpy() <= a["size"] + 1e-3).all()
        assert (R2.numpy() <= a["line"] * (1 + 1e-6)).all()


def test_cca_step_windows_grow_when_uncongested():
    a = _cca_inputs(64, 16)
    a["q"] = np.zeros(16, np.float32)
    a["alpha"] = np.zeros(64, np.float32)
    a["W"] = np.minimum(a["W"], a["line"] * a["rtt0"]).astype(np.float32)
    _, W2, *_ = cca_step(**_torch(a), dt=1e-5)
    assert (W2.numpy() >= a["W"] - 1e-6).all()


def test_cca_step_bf16_inputs_are_upcast():
    a = _cca_inputs(64, 32)
    bf = _torch(a, dtype=torch.bfloat16)
    out = cca_step(**bf, dt=1e-5)
    ref = cca_step_ref(**{k: jnp.asarray(v.float().numpy()) for k, v in bf.items()},
                       dt=1e-5)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-2, atol=2e2)


def test_cca_step_refuses_bad_inputs():
    a = _torch(_cca_inputs(8, 4))
    with pytest.raises(ValueError, match="q must have shape"):
        cca_step(**{**a, "q": a["q"][:3]}, dt=1e-5)
    with pytest.raises(TypeError, match="floating-point"):
        cca_step(**{**a, "M": a["M"].to(torch.int32)}, dt=1e-5)
    with pytest.raises(ValueError, match="M must be"):
        cca_step(**{**a, "M": a["M"][0]}, dt=1e-5)


# --------------------------------------------------------------------- #
# fluid_scan (the scan of cca_step, with the queue update)
# --------------------------------------------------------------------- #
def _scan_args(a):
    """fluid_scan's positional inputs from a cca_step input dict."""
    t = _torch(a)
    return [t[k] for k in ("M", "line", "rtt0", "size", "bw", "W", "alpha", "delivered", "q")]


@pytest.mark.parametrize("batch", [(), (3,)])
def test_fluid_scan_one_step_is_cca_step_plain_and_queue_update(batch):
    a = _cca_inputs(50, 20, batch)
    t = _torch(a)
    out = fluid_scan(*_scan_args(a), dt=1e-5, steps=1)
    R2, W2, a2, d2, arr = cca_step_plain(**t, dt=1e-5)
    q2 = (t["q"] + (arr - t["bw"]) * 1e-5).clamp(0.0, 64 * 64_000.0)
    for k, want in (("rates", R2), ("W", W2), ("alpha", a2), ("delivered", d2),
                    ("arrivals", arr), ("queues", q2)):
        assert torch.equal(out[k], want), k
    assert torch.equal(out["rate_hist"], R2.unsqueeze(-2))
    assert torch.equal(out["queue_hist"], q2.unsqueeze(-2))


def test_fluid_scan_wrapper_on_cpu_is_the_plain_scan():
    a = _cca_inputs(30, 12, (2,))
    launches = fluid_scan.launches
    out = fluid_scan(*_scan_args(a), dt=1e-5, steps=40, history=False)
    want = fluid_scan_plain(*_scan_args(a), dt=1e-5, steps=40)
    assert fluid_scan.launches == launches              # CPU tensors: no kernel launch
    assert out["rate_hist"] is None and out["queue_hist"] is None
    for k in ("rates", "W", "alpha", "delivered", "queues", "arrivals"):
        assert torch.equal(out[k], want[k]), k
    assert torch.equal(want["rate_hist"][:, -1], want["rates"])


def test_fluid_scan_zero_steps_returns_the_initial_state():
    a = _cca_inputs(9, 4)
    t = _torch(a)
    out = fluid_scan(*_scan_args(a), dt=1e-5, steps=0)
    for k, want in (("rates", t["line"]), ("W", t["W"]), ("alpha", t["alpha"]),
                    ("delivered", t["delivered"]), ("queues", t["q"]),
                    ("arrivals", torch.zeros(4))):
        assert torch.equal(out[k], want), k
    assert out["rate_hist"].shape == (0, 9) and out["queue_hist"].shape == (0, 4)


@pytest.mark.parametrize("bad", [0.5, 2.0, -1.0, float("nan")])
def test_kernel_wrappers_refuse_a_non_binary_incidence(bad):
    a = _cca_inputs(8, 4)
    a["M"][3, 2] = bad
    with pytest.raises(ValueError, match="0/1 incidence"):
        fluid_scan(*_scan_args(a), dt=1e-5, steps=5)
    with pytest.raises(ValueError, match="0/1 incidence"):
        cca_step(**_torch(a), dt=1e-5)


def test_fluid_scan_refuses_bad_inputs():
    args = _scan_args(_cca_inputs(8, 4))
    with pytest.raises(ValueError, match="q must have shape"):
        fluid_scan(*args[:8], args[8][:3], dt=1e-5, steps=5)
    with pytest.raises(ValueError, match="W must have shape"):
        fluid_scan(*args[:5], args[5][:7], *args[6:], dt=1e-5, steps=5)
    with pytest.raises(TypeError, match="floating-point"):
        fluid_scan(args[0].to(torch.int32), *args[1:], dt=1e-5, steps=5)
    with pytest.raises(ValueError, match="M must be"):
        fluid_scan(args[0][0], *args[1:], dt=1e-5, steps=5)
    with pytest.raises(ValueError, match="steps must be"):
        fluid_scan(*args, dt=1e-5, steps=-1)


@pytest.mark.parametrize("batch,steps,window,atol", [((), 60, 20, 0.0), ((3,), 60, 7, 0.0),
                                                     ((), 1, 1, 0.0), ((2,), 40, 40, 1e9)])
def test_fluid_scan_window_is_steady_scan_plain_over_its_history(batch, steps, window, atol):
    """The fused detector's plain form: ``win_mean``/``win_fluct`` are
    ``steady_scan_plain`` over the scan's own rate history, with or without
    the history returned (atol 1e9 puts some flows in the dead band)."""
    args = _scan_args(_cca_inputs(24, 10, batch))
    out = fluid_scan(*args, dt=1e-5, steps=steps, window=window, atol=atol)
    fl, mn = steady_scan_plain(out["rate_hist"].transpose(-1, -2), window, atol)
    assert out["win_mean"].shape == (*batch, 24)
    assert torch.equal(out["win_mean"], mn) and torch.equal(out["win_fluct"], fl)
    bare = fluid_scan(*args, dt=1e-5, steps=steps, window=window, atol=atol, history=False)
    assert bare["rate_hist"] is None and bare["queue_hist"] is None
    for k in ("win_mean", "win_fluct", "rates", "queues"):
        assert torch.equal(bare[k], out[k]), k
    plain = fluid_scan(*args, dt=1e-5, steps=steps)
    assert "win_mean" not in plain and torch.equal(plain["rate_hist"], out["rate_hist"])


@pytest.mark.parametrize("steps,window", [(10, 0), (10, 11), (0, 1), (5, -2)])
def test_fluid_scan_refuses_a_window_outside_the_steps(steps, window):
    args = _scan_args(_cca_inputs(8, 4))
    with pytest.raises(ValueError, match="window must be in"):
        fluid_scan(*args, dt=1e-5, steps=steps, window=window)
    with pytest.raises(ValueError, match="window must be in"):
        fluid_scan_plain(*args, dt=1e-5, steps=steps, window=window)


# --------------------------------------------------------------------- #
# steady_scan
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("F,H,w", [(1, 8, 8), (64, 32, 16), (128, 128, 128),
                                   (131, 64, 33), (500, 16, 7)])
def test_steady_scan_plain_matches_ref(F, H, w):
    hist = RNG.uniform(1e8, 1e10, (F, H)).astype(np.float32)
    launches = steady_scan.launches
    fl, mn = steady_scan(torch.from_numpy(hist), w)
    fr, mr = steady_scan_ref(jnp.asarray(hist), w)
    assert steady_scan.launches == launches
    np.testing.assert_allclose(fl.numpy(), np.asarray(fr), rtol=1e-4)
    np.testing.assert_allclose(mn.numpy(), np.asarray(mr), rtol=1e-5)


def test_steady_scan_reads_time_major_and_batched_views():
    """The fluid engine scans the transpose of its [steps, F] history and
    of the batched [B, steps, F] one, without a copy."""
    hist = RNG.uniform(1e8, 1e10, (3, 200, 50)).astype(np.float32)
    ht = torch.from_numpy(hist)
    fl, mn = steady_scan(ht.transpose(1, 2), 20)
    for b in range(3):
        fr, mr = steady_scan_ref(jnp.asarray(hist[b].T), 20)
        np.testing.assert_allclose(fl[b].numpy(), np.asarray(fr), rtol=1e-4)
        np.testing.assert_allclose(mn[b].numpy(), np.asarray(mr), rtol=1e-5)
    fl1, mn1 = steady_scan(ht[1].T, 20)
    np.testing.assert_array_equal(mn1.numpy(), mn[1].numpy())


def test_steady_scan_equals_fluid_reference_numpy_window():
    """``fluid_converged_rates`` in the reference takes rates/fluct with
    numpy over the trailing window (1e-9 clamp, inf for a zero row); the
    port takes them from steady_scan (1e-30 clamp, 0 for a zero row).  The
    clamps differ only for a mean below 1e-9 and the zero-row rule only for
    an all-zero row, neither of which positive fluid rates produce: on
    them the two agree."""
    hist = RNG.uniform(1e3, 1e10, (200, 77)).astype(np.float32)
    w = 20
    mean = hist[-w:].mean(0)
    fluct = np.where(mean > 0, (hist[-w:].max(0) - hist[-w:].min(0))
                     / np.maximum(mean, 1e-9), np.inf)
    fl, mn = steady_scan(torch.from_numpy(hist).T, w)
    np.testing.assert_allclose(mn.numpy(), mean, rtol=1e-6)
    np.testing.assert_allclose(fl.numpy(), fluct, rtol=1e-5)


def test_steady_scan_atol_dead_band_matches_ref_and_scalar_detector():
    atol = 2000.0
    hist = np.zeros((130, 32), np.float32)       # crosses a 128-series block
    hist[1] = 1500.0                             # pinned inside the band
    hist[2] = RNG.uniform(1e8, 1e10, 32)         # live row
    fl, _ = steady_scan(torch.from_numpy(hist), 32, atol=atol)
    fl_r, _ = steady_scan_ref(jnp.asarray(hist), 32, atol=atol)
    np.testing.assert_allclose(fl.numpy(), np.asarray(fl_r), rtol=1e-4)
    np.testing.assert_allclose(fl.numpy(), fluctuation_batch(hist, atol), rtol=1e-4)
    for i in (0, 1, 2):
        assert float(fl[i]) == pytest.approx(fluctuation(list(hist[i]), atol), rel=1e-4)
    assert float(fl[0]) == 0.0 and float(fl[1]) == 0.0
    fl0, _ = steady_scan(torch.from_numpy(hist), 32)
    assert float(fl0[0]) == 0.0
    assert float(fl0[1]) == pytest.approx(fluctuation(list(hist[1])))


def test_steady_scan_refuses_bad_window():
    with pytest.raises(ValueError, match="window"):
        steady_scan(torch.ones(4, 8), 9)
    with pytest.raises(ValueError, match="window"):
        steady_scan(torch.ones(4, 8), 0)
