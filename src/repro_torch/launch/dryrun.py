"""Multi-pod dry-run: trace every (architecture × input shape) cell on the
production meshes and record memory, collectives and the roofline terms,
with nothing allocated and nothing run.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k --mesh single --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --device cpu

A port of ``repro.launch.dryrun``.  Where the reference lowers and compiles
a cell on 512 placeholder host devices, this traces it once on a process
group of backend ``"fake"`` (world size 256 or 512, this process rank 0):
parameters, optimizer state, batch and cache are fake tensors
(``FakeTensorMode``) made into DTensors by the sharding rules, and the step
(the train step's ``value_and_grad`` of ``Model.loss`` and AdamW's
``update``; the prefill; or the decode step) runs once on them under
``CommDebugMode``, a :class:`~repro_torch.launch.roofline.CollectiveRecorder`
and a ``MemTracker`` of this device's bytes.  The fake group's
collectives move nothing.  K4 takes part through its fake implementation
and its DTensor sharding rule.

The record keeps the reference's keys, except ``temp_gb_per_device`` (the
peak of live fake bytes on one device during the trace beyond the
arguments; the reference's ``xla_temp_gb_per_device``), ``fits_80gb_hbm``
(``fits_16gb_hbm``) and ``collectives_traced`` (``collectives_hlo_evidence``:
per-device output bytes and counts of the traced collectives, per kind);
``compile_s`` is the trace's seconds.  The analytic fields come from
:mod:`repro_torch.launch.analytic`, the roofline's from
:mod:`repro_torch.launch.roofline` (H100 constants).  A failing cell is a
``status: "error"`` record with its reason.

``--device`` (default ``cuda``) is where the fake tensors claim to live;
without a card it raises :class:`~repro_torch.device.NoCardError`, as every
entry point does.  Records go to ``artifacts/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import signal
import time
import traceback

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import cells, get
from repro_torch.device import resolve_device
from repro_torch.launch import analytic as AN
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import build_model
from repro_torch.models.params import Struct, leaves, map_tree
from repro_torch.parallel import act_sharding
from repro_torch.parallel.sharding import (batch_axes, distribute, mesh_shape, placements,
                                          resolve, rules_for)
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import value_and_grad

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
MESH_WORLD = {"single": 256, "multi": 512}
# a cell's trace, at most: a trace past it is an error record, not a hung sweep
# (the slowest cell, jamba-v0.1-52b train_4k on (2, 16, 16), traces in ~560 s
# on an 8-core CPU host)
BUDGET_S = 900.0


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of backend ``"fake"`` with ``world_size``
    ranks, this process rank 0; destroyed on exit (one default group a
    process)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _bookkeeping_unfaked():
    """Two pieces of DTensor's bookkeeping set the ambient ``FakeTensorMode``
    aside while this is entered: the output metadata it derives by running
    each op at whole (global) shapes, so that those placeholders take a
    fake mode of their own, which :func:`_device_mem_tracker` does not
    count; and ``_StridedShard``'s sizes, which it reads back from index
    tensors of its own (integers in, integers out).  A torch without one of
    them raises: the record's live bytes would not be one device's."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _sharding_prop, placement_types
    targets = [(_sharding_prop.ShardingPropagator, "_propagate_tensor_meta_non_cached"),
               (placement_types._StridedShard, "local_shard_size_and_offset")]
    saved = []
    for owner, name in targets:
        orig = getattr(owner, name)

        def unfaked(*args, _orig=orig, **kwargs):
            with unset_fake_temporarily():
                return _orig(*args, **kwargs)
        saved.append((owner, name, orig))
        setattr(owner, name, unfaked)
    try:
        yield
    finally:
        for owner, name, orig in saved:
            setattr(owner, name, orig)


def _device_mem_tracker():
    """A ``MemTracker`` that counts only the ops run under the fake mode it
    was entered in: the local ops on this device's shards, and not the
    ops DTensor runs at whole shapes under a fake mode of its own to derive
    output metadata (:func:`_bookkeeping_unfaked`), which are no device's
    bytes.  Newer torch's ``MemTracker`` filters these itself; this makes
    every torch count the same."""
    from torch._guards import active_fake_mode
    from torch.distributed._tools.mem_tracker import MemTracker

    class _DeviceMemTracker(MemTracker):
        def __enter__(self):
            self._entry_fake_mode = active_fake_mode()
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if active_fake_mode() is not self._entry_fake_mode:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return _DeviceMemTracker()


def build_step(model, cfg, kind: str):
    """The step of the cell's kind, on (DTensor) trees."""
    ocfg = O.AdamWConfig(state_dtype=O.STATE_DTYPES[cfg.opt_dtype])

    if kind == "train":
        def train_step(params, opt_state, batch):
            loss, grads = value_and_grad(model, params, batch)
            params2, opt2, metrics = O.update(params, grads, opt_state, ocfg)
            return params2, opt2, loss, metrics["grad_norm"]
        return train_step

    if kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch)
        return prefill_step

    def serve_step(params, cache, tokens, pos):
        with torch.no_grad():
            return model.decode_step(params, cache, tokens, pos)
    return serve_step


@dataclasses.dataclass
class Lowered:
    """A cell ready to trace: its step and the step's arguments, DTensors
    of fake tensors on ``mesh``."""
    cfg: object
    model: object
    mesh: object
    cell: object
    step: object
    args: tuple
    chips: int
    fake_mode: object


def _fake(structs, device):
    return map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype, device=device), structs)


def lower_cell(arch: str, shape_name, multi_pod: bool, extra_rules: dict | None = None,
               cfg_override=None, device: str = "cuda", mesh=None) -> Lowered:
    """The cell's fake, distributed arguments and its step, on ``mesh`` (by
    default the production mesh over the current fake group).
    ``shape_name`` names a cell of ``SHAPES``, or is a ``ShapeCell``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = resolve_device(device)
    cfg = cfg_override if cfg_override is not None else get(arch)
    cell = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    model = build_model(cfg)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev.type)
    chips = mesh.size()
    rules = rules_for(cfg, mesh, cell.kind, cell.seq_len, cell.global_batch,
                      n_params=model.n_params)
    if extra_rules:
        rules.update(extra_rules)

    if cell.kind in ("train", "prefill"):
        spec = resolve(("act_batch", "act_seq", None),
                       (cell.global_batch, cell.seq_len, cfg.d_model),
                       {**rules, "act_seq": "model"}, mesh)
        act_sharding.install(mesh, placements(spec, mesh))
    else:
        act_sharding.clear()

    mode = FakeTensorMode()
    inputs = model.input_specs(cell)
    axes = model.param_axes()
    with mode, _bookkeeping_unfaked():
        params = distribute(_fake(model.param_structs(), dev), axes, rules, mesh)
        if cell.kind == "train":
            state = O.STATE_DTYPES[cfg.opt_dtype]
            moments = lambda: distribute(  # noqa: E731
                _fake(map_tree(lambda s: Struct(s.shape, state), model.param_structs()), dev),
                axes, rules, mesh)
            opt = {"m": moments(), "v": moments(),
                   "step": torch.zeros((), dtype=torch.int32, device=dev)}
            batch = distribute(_fake(inputs, dev), batch_axes(inputs), rules, mesh)
            args = (params, opt, batch)
        elif cell.kind == "prefill":
            args = (params, distribute(_fake(inputs, dev), batch_axes(inputs), rules, mesh))
        else:
            cache = distribute(_fake(inputs["cache"], dev), model.cache_axes(), rules, mesh)
            tok = {"tokens": inputs["tokens"]}
            tokens = distribute(_fake(tok, dev), batch_axes(tok), rules, mesh)["tokens"]
            args = (params, cache, tokens, cell.seq_len - 1)
    return Lowered(cfg, model, mesh, cell, build_step(model, cfg, cell.kind), args, chips, mode)


def _local_tensors(args) -> list:
    """Every tensor of the step's arguments as this rank holds it."""
    tensors = [t for a in args for t in (leaves(a) if isinstance(a, dict) else [a])
               if isinstance(t, torch.Tensor)]
    return [t.to_local() if isinstance(t, DTensor) else t for t in tensors]


def trace(low: Lowered) -> dict:
    """Run the step once on the fake arguments; the trace's seconds, the
    collectives (``CommDebugMode``'s counts; per-kind bytes and counts of
    :func:`~repro_torch.launch.roofline.traced_collective_bytes`) and the
    peak live bytes on this device (:func:`_device_mem_tracker`, the
    arguments included)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    local = _local_tensors(low.args)
    t0 = time.time()
    with low.fake_mode, _bookkeeping_unfaked(), implicit_replication():
        mt = _device_mem_tracker()
        mt.track_external(*local)
        with CommDebugMode() as cdm, mt:
            _, nbytes, counts = RL.traced_collective_bytes(low.step, *low.args)
    peak = max((snap.get("Total", 0) for snap in mt.get_tracker_snapshot("peak").values()),
               default=0)
    return {"trace_s": time.time() - t0,
            "argument_bytes": float(sum(t.numel() * t.element_size() for t in local)),
            "peak_bytes": float(peak),
            "comm_counts": {str(k): v for k, v in cdm.get_comm_counts().items()},
            "bytes": nbytes, "counts": counts}


def analyse(low: Lowered) -> dict:
    """Trace the cell and make its record."""
    cfg, model, cell, chips = low.cfg, low.model, low.cell, low.chips
    tr = trace(low)
    mesh_sh = mesh_shape(low.mesh)
    dp = mesh_sh.get("data", 1) * mesh_sh.get("pod", 1)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    n_active = _active_params(cfg, model)
    mflops = RL.model_flops(model.n_params, n_active, tokens, cell.kind)
    fl = AN.cell_flops(cfg, cell)
    memm = AN.cell_memory(cfg, cell, model.n_params, chips, dp)
    coll = AN.cell_collectives(cfg, cell, model.n_params, mesh_sh)
    terms = RL.roofline(fl["total"], memm.traffic_bytes, coll["total"], chips)
    naive_mem_s = (memm.traffic_bytes + memm.naive_attn_extra) / (chips * RL.HBM_BW)
    return {
        "arch": cfg.name, "shape": cell.name, "mesh": tuple(mesh_sh.values()),
        "chips": chips, "compile_s": round(tr["trace_s"], 1),
        "params_b": model.n_params / 1e9,
        "argument_gb_per_device": tr["argument_bytes"] / 1e9,
        "temp_gb_per_device": max(tr["peak_bytes"] - tr["argument_bytes"], 0.0) / 1e9,
        "est_peak_gb_per_device": memm.peak_bytes_per_device / 1e9,
        "fits_80gb_hbm": bool(memm.peak_bytes_per_device < 80e9),
        "hlo_flops": fl["total"], "model_flops": mflops,
        "useful_flops_ratio": mflops / fl["total"] if fl["total"] else 0.0,
        "hbm_bytes": memm.traffic_bytes,
        "naive_attn_memory_s": naive_mem_s,
        "collective_bytes_per_chip": coll["total"],
        "collectives_analytic": coll,
        "collectives_traced": {"bytes": tr["bytes"], "counts": tr["counts"]},
        "comm_counts": tr["comm_counts"],
        **terms,
    }


def _active_params(cfg, model) -> float:
    n = model.n_params
    if not cfg.moe_experts:
        return n
    # subtract inactive expert weights
    f = cfg.moe_d_ff or cfg.d_ff
    n_moe_layers = 0
    for st in cfg.stages():
        for b in st.blocks:
            if b.ffn == "moe":
                n_moe_layers += st.repeat
    per_expert = 3 * cfg.d_model * f
    total_expert = n_moe_layers * cfg.moe_experts * per_expert
    active_expert = n_moe_layers * max(cfg.moe_top_k, 1) * per_expert
    return n - total_expert + active_expert


@contextlib.contextmanager
def _budget(seconds: float):
    """Raise :class:`TimeoutError` in this (main) thread after ``seconds``."""
    def expire(signum, frame):
        raise TimeoutError(f"the trace exceeded its budget of {seconds:g} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def run_cell(arch: str, shape_name: str, mesh_kind: str, outdir: pathlib.Path,
             device: str = "cuda", mesh=None, cfg_override=None) -> dict:
    """Trace one cell (on ``mesh``, else the production mesh of
    ``mesh_kind`` over the current fake group) and write its record; a
    cached record is returned as it is.  A trace still running after
    :data:`BUDGET_S` seconds is an error record."""
    tag = f"{arch}__{shape_name}__{mesh_kind}"
    out_path = outdir / f"{tag}.json"
    if out_path.exists():
        print(f"[skip cached] {tag}")
        return json.loads(out_path.read_text())
    print(f"[trace] {tag}", flush=True)
    t0 = time.time()
    try:
        with _budget(BUDGET_S):
            rec = analyse(lower_cell(arch, shape_name, mesh_kind == "multi", device=device,
                                     mesh=mesh, cfg_override=cfg_override))
        rec["status"] = "ok"
    except Exception as e:  # a failing cell is recorded, with its reason, not skipped
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "status": "error", "error": f"{type(e).__name__}: {e}"[:2000],
               "trace": traceback.format_exc()[-2000:]}
    finally:
        act_sharding.clear()
    rec["device"] = str(resolve_device(device))
    rec["wall_s"] = round(time.time() - t0, 1)
    outdir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1, default=str))
    status = rec["status"]
    extra = "" if status != "ok" else (
        f" dom={rec['dominant']} frac={rec['roofline_fraction']:.2f}"
        f" peak={rec['est_peak_gb_per_device']:.1f}GB")
    print(f"[{status}] {tag} ({rec['wall_s']}s){extra}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(ART))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    resolve_device(args.device)
    outdir = pathlib.Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        todo = [(a, s) for (a, s, skip) in cells() if skip is None]
        if args.arch:
            todo = [t for t in todo if t[0] == args.arch]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]
    recs = []
    for mesh_kind in meshes:
        with fake_world(MESH_WORLD[mesh_kind]):
            for arch, shape in todo:
                recs.append(run_cell(arch, shape, mesh_kind, outdir, device=args.device))
    return recs


if __name__ == "__main__":
    main()
