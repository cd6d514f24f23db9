"""Training loop: microbatch gradient accumulation, optional gradient
compression (error-feedback), step-atomic checkpoints, failure injection /
elastic restart, straggler tracking.

A port of ``repro.train.train_loop`` in PyTorch.  :func:`train` runs on
the CUDA card unless the caller passes ``device="cpu"``, and raises when it
wants the card and there is none.  A step is the reference's
``make_train_step``: the loss and its gradient (autograd, the attention's
backward through the flash-attention kernel's), accumulated in float32
over microbatches when there are several, then compression, then AdamW.
Parameters and optimizer state are updated in place.  Resume restores the
latest checkpoint and the pipeline's position exactly as the reference
does, including its one-batch shift: a checkpoint taken after step s
records the pipeline at batch s + 1, and the resumed loop starts at step s
again, so it runs ``steps - s`` steps from batch s + 1 on.
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable

import torch

from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import device_name, resolve_device
from repro_torch.models.api import Model
from repro_torch.models.params import leaves, map_tree
from repro_torch.parallel.compression import (CompressionConfig, compress_decompress,
                                              init_residuals)
from repro_torch.train import checkpoint as C
from repro_torch.train import optimizer as O
from repro_torch.train.fault import FailureInjector, FaultManager


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    microbatches: int = 1
    log_every: int = 10
    opt: O.AdamWConfig = dataclasses.field(default_factory=O.AdamWConfig)
    compression: CompressionConfig = dataclasses.field(
        default_factory=CompressionConfig)
    ckpt_dir: str = ""
    ckpt_every: int = 50


def value_and_grad(model: Model, params, batch):
    """(loss, gradients): the gradient of ``model.loss`` with respect to
    every parameter leaf, a tree like ``params`` in the parameters' dtype.
    It differentiates detached views of the leaves, so the caller's tensors
    never come to require grad."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    views = iter(flat)
    loss = model.loss(map_tree(lambda _: next(views), params), batch)
    grads = iter(torch.autograd.grad(loss, flat))
    return loss.detach(), map_tree(lambda _: next(grads), params)


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    comp = tcfg.compression

    def step(params, opt_state, residuals, batch):
        mb = tcfg.microbatches
        if mb == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            batches = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
                       for k, v in batch.items()}
            grads = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
            for i in range(mb):
                l_i, g_i = value_and_grad(model, params, {k: v[i] for k, v in batches.items()})
                loss = loss + l_i
                for acc, g in zip(leaves(grads), leaves(g_i)):
                    acc.add_(g)
                del g_i
            loss = loss / mb
            grads = map_tree(lambda g: g / mb, grads)
        grads, residuals = compress_decompress(grads, residuals, comp)
        params, opt_state, metrics = O.update(params, grads, opt_state, tcfg.opt)
        return params, opt_state, residuals, loss, metrics["grad_norm"]

    return step


def _to_device(batch: dict, dev: torch.device) -> dict:
    """The pipeline's numpy batch on ``dev``; token ids as int64."""
    return {k: torch.from_numpy(v).to(dev, torch.long if v.dtype.kind in "iu" else None)
            for k, v in batch.items()}


def train(model: Model, pipeline: TokenPipeline, tcfg: TrainConfig,
          params=None, injector: FailureInjector | None = None,
          extra_batch: dict | None = None, device=None) -> dict:
    """Returns {'losses': [...], 'params': ..., 'opt_state': ...,
    'resumed_from': step|None, 'stragglers': [...]} as the reference does,
    and the port's 'grad_norms', 'step_seconds' (host wall of each step,
    ending in the loss's read-back) and 'device'.  ``params`` (default:
    ``model.init(0, device)``) must lie on the device."""
    dev = resolve_device(device)
    fm = FaultManager(tcfg.ckpt_dir, tcfg.ckpt_every) if tcfg.ckpt_dir else None
    start_step = 0
    opt_state = None
    if params is None:
        params = model.init(0, dev)
    elif any(p.device.type != dev.type for p in leaves(params)):
        raise ValueError(f"params do not all lie on {dev}")
    if fm is not None and fm.resume_info() is not None:
        tmpl = {"params": params, "opt": O.init_state(params, tcfg.opt)}
        state, manifest = C.restore(tcfg.ckpt_dir, template=tmpl)
        params, opt_state = state["params"], state["opt"]
        start_step = manifest["step"]
        pipeline.restore({"step": manifest["extra"]["data_step"],
                          "seed": pipeline.seed})
    if opt_state is None:
        opt_state = O.init_state(params, tcfg.opt)
    residuals = init_residuals(params) if tcfg.compression.kind != "none" else None
    step_fn = make_train_step(model, tcfg)

    losses, grad_norms, step_seconds = [], [], []
    for step in range(start_step, tcfg.steps):
        t0 = time.perf_counter()
        if fm:
            fm.step_started()
        batch = _to_device(pipeline.next_batch(), dev)
        if extra_batch:
            batch.update(extra_batch)
        if injector is not None:
            injector.maybe_fail(step)
        params, opt_state, residuals, loss, gnorm = step_fn(
            params, opt_state, residuals, batch)
        losses.append(float(loss))
        grad_norms.append(float(gnorm))
        step_seconds.append(time.perf_counter() - t0)
        if fm:
            fm.step_finished(step)
            fm.maybe_save(step, params, opt_state,
                          {"data_step": pipeline.step})
        if step % tcfg.log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} gnorm {grad_norms[-1]:.3f}")
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "resumed_from": start_step or None,
            "stragglers": fm.straggler_steps if fm else [],
            "grad_norms": grad_norms, "step_seconds": step_seconds,
            "device": device_name(dev)}
