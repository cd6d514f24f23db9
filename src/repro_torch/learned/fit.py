"""Training loop for the learned engine: full-batch Adam, early stop on
held-out error, deterministic under a fixed seed.

The port of ``repro.learned.fit``, which the port may not import.  The
datasets here are small (a sweep's worth of per-flow rows — hundreds to
tens of thousands), so full-batch gradients are both cheapest and exactly
reproducible: no shuffling order to pin down.  Each Adam step takes its
gradients through ``torch.autograd`` on the device (the CUDA card unless
``device="cpu"``) and applies the update by hand, in the reference's order
and float32 rounding of ``t`` and ``b ** t`` (``torch.optim.Adam`` rounds
differently); the weights that minimized held-out MSE are the ones
returned.

    ds = build_dataset(source)
    params = fit(ds, seed=0)
    model.save(params, "artifacts/learned_params.json")
"""
from __future__ import annotations

import numpy as np

from repro_torch.learned import model as M
from repro_torch.learned.dataset import Dataset


def standardize_moments(X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-column mean / clamped std of the training block."""
    mu = X.mean(axis=0)
    sigma = np.maximum(X.std(axis=0), 1e-8)
    return mu, sigma


def fit(dataset: Dataset, *, seed: int = 0, hidden: tuple[int, ...] = (64, 64),
        steps: int = 1500, lr: float = 3e-3, eval_every: int = 25,
        patience: int = 300, device=None) -> M.LearnedParams:
    """Fit an MLP to ``dataset`` and return sealed :class:`LearnedParams`.

    Early stopping watches held-out MSE every ``eval_every`` steps and
    keeps the best weights; with no held-out rows (``heldout_frac=0`` or a
    tiny store) it watches training MSE instead.  ``steps`` bounds the
    loop either way, so a fixed-seed fit always does the same work.  The
    initial weights come from :func:`model.init` (on the CPU, then moved
    to ``device``).
    """
    import torch

    from repro_torch.device import device_name, resolve_device
    dev = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    tr = ~dataset.heldout
    if not tr.any():
        raise ValueError("dataset has no training rows (everything held "
                         "out) — lower heldout_frac")
    mu, sigma = standardize_moments(dataset.X[tr])
    Xtr = tensor((dataset.X[tr] - mu) / sigma)
    ytr = tensor(dataset.y[tr])
    have_heldout = bool(dataset.heldout.any())
    if have_heldout:
        Xhe = tensor((dataset.X[dataset.heldout] - mu) / sigma)
        yhe = tensor(dataset.y[dataset.heldout])

    weights = [(tensor(w).requires_grad_(), tensor(b).requires_grad_())
               for w, b in M.init(seed, dataset.X.shape[1], hidden)]
    params = [p for wb in weights for p in wb]
    m_state = [torch.zeros_like(p) for p in params]
    v_state = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    f32 = np.float32

    def step(t: int) -> None:
        grads = torch.autograd.grad(M.loss(weights, Xtr, ytr), params)
        # the reference's step computes t and b ** t in float32
        c1 = float(f32(1) - f32(b1) ** f32(t))
        c2 = float(f32(1) - f32(b2) ** f32(t))
        with torch.no_grad():
            for p, g, mm, vv in zip(params, grads, m_state, v_state):
                mm.copy_(b1 * mm + (1 - b1) * g)
                vv.copy_(b2 * vv + (1 - b2) * g * g)
                mhat = mm / c1
                vhat = vv / c2
                p.copy_(p - lr * mhat / (torch.sqrt(vhat) + eps))

    def eval_mse(ws, x, y) -> float:
        with torch.no_grad():
            return float(M.loss(ws, x, y))

    def snapshot():
        return [(w.detach().cpu().numpy().copy(), b.detach().cpu().numpy().copy())
                for w, b in weights]

    best_err = np.inf
    best_weights = snapshot()
    best_step = 0
    steps_run = 0
    for t in range(1, steps + 1):
        step(t)
        steps_run = t
        if t % eval_every == 0 or t == steps:
            err = eval_mse(weights, Xhe, yhe) if have_heldout \
                else eval_mse(weights, Xtr, ytr)
            if err < best_err:
                best_err = err
                best_weights = snapshot()
                best_step = t
            elif t - best_step >= patience:
                break

    n_num = dataset.n_numeric
    train_mse = eval_mse([(tensor(w), tensor(b)) for w, b in best_weights], Xtr, ytr)
    meta = {
        "arch": {"hidden": list(hidden), "activation": "tanh"},
        "target": "log_slowdown_vs_maxmin",
        "feature_names": dataset.feature_names,
        "n_numeric": n_num,
        "cca_vocab": list(dataset.cca_vocab),
        "topo_vocab": list(dataset.topo_vocab),
        "mu": [float(v) for v in mu],
        "sigma": [float(v) for v in sigma],
        # training envelope over the raw numeric block — the engine's
        # out-of-distribution guard
        "envelope_lo": [float(v) for v in dataset.X[tr][:, :n_num].min(0)],
        "envelope_hi": [float(v) for v in dataset.X[tr][:, :n_num].max(0)],
        "train": {
            "seed": seed, "lr": lr, "steps": steps_run,
            # a fit on the card is not the CPU's (summation order), so the
            # params file names the device that fitted it
            "device": device_name(dev),
            "best_step": best_step,
            "records": dataset.n_records,
            "heldout_records": dataset.n_heldout_records,
            "flows": int(tr.sum()),
            "heldout_flows": int(dataset.heldout.sum()),
            "train_mse": train_mse,
            "heldout_mse": float(best_err) if have_heldout else None,
        },
    }
    return M.make_params(best_weights, meta)


def fct_error(params: M.LearnedParams, X: np.ndarray, y: np.ndarray,
              device=None) -> np.ndarray:
    """Per-row relative FCT error of the model on encoded rows: the
    slowdown targets make ``|exp(pred - y) - 1|`` exactly
    ``|fct_pred - fct| / fct``."""
    pred = M.predict(params, X, device=device)
    return np.abs(np.exp(pred - np.asarray(y)) - 1.0)


def heldout_fct_error(params: M.LearnedParams, dataset: Dataset,
                      device=None) -> float:
    """Mean relative FCT error on the held-out rows (nan if none) — the
    accuracy number the smoke runs and tests gate on."""
    if not dataset.heldout.any():
        return float("nan")
    return float(fct_error(params, dataset.X[dataset.heldout],
                           dataset.y[dataset.heldout], device=device).mean())
