"""Sharded checkpointing with elastic re-mesh on restore.

Save layout: one ``.npz`` per host-shard plus a JSON manifest
(step-atomic: written to a tmp dir, renamed).  Each leaf is saved as the
*global* array split along its first axis into ``n_shards`` pieces (whole
in shard 0 when that axis does not divide); restore re-assembles it.

A port of ``repro.train.checkpoint``, file for file: the leaf names are JAX
``keystr`` paths of ``{"params": ..., "opt": ...}`` (``['params']['embed']``,
``['opt']['step']``) in sorted-key order, and the arrays are the same
bytes, so a checkpoint written by either package restores in the port.
bfloat16 leaves are stored as the reference stores them, raw two-byte
``'<V2'`` records (numpy has no bfloat16), and the port restores them by
reinterpreting the bits as ``torch.bfloat16``.  The reference's own
``restore`` cannot cast those records back (``astype(bfloat16)`` raises),
for its checkpoints as for the port's; float32 checkpoints restore in both.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import zipfile

import numpy as np
import torch

BF16_DESCR = "<V2"      # the .npy header's dtype of a bfloat16 leaf, as JAX's arrays write it


def _leaf_paths(tree, prefix: str = ""):
    """(keystr path, leaf) pairs in sorted-key order, as
    ``jax.tree_util.tree_flatten_with_path`` gives a nested dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf's host array as the reference writes it: bfloat16 as raw
    two-byte records, anything else as its numpy dtype."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def _savez(path: pathlib.Path, arrays: dict) -> None:
    """``np.savez``'s archive (stored ``<name>.npy`` members), with a
    bfloat16 leaf's header naming ``'<V2'`` as the reference's does (numpy
    would write a plain two-byte record as ``'|V2'``)."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, arr in arrays.items():
            arr = np.array(arr, order="C")       # (ascontiguousarray makes a 0-d array 1-d)
            header = np.lib.format.header_data_from_array_1_0(arr)
            if arr.dtype.kind == "V":
                header["descr"] = BF16_DESCR
            with zf.open(f"{name}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(f, header)
                f.write(arr.tobytes())


def _from_numpy(arr: np.ndarray, dtype: torch.dtype | None = None, device=None) -> torch.Tensor:
    """A stored array as a tensor: two-byte records as bfloat16 bits, then
    ``dtype`` (the template leaf's) and ``device``."""
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"cannot read a {arr.dtype} record as bfloat16")
        t = torch.from_numpy(np.array(arr, order="C").view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C"))
    return t.to(device=device, dtype=dtype or t.dtype)


def save(ckpt_dir: str | os.PathLike, step: int, params, opt_state=None,
         extra: dict | None = None, n_shards: int = 1) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    tmp = ckpt_dir / f".tmp_step{step}"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    state = {"params": params}
    if opt_state is not None:
        state["opt"] = opt_state
    names, leaves = zip(*list(_leaf_paths(state)))
    arrays = [_to_numpy(leaf) for leaf in leaves]
    for shard in range(n_shards):
        arrs = {}
        for name, arr in zip(names, arrays):
            if arr.ndim == 0 or arr.shape[0] % n_shards != 0:
                if shard == 0:
                    arrs[name] = arr
            else:
                k = arr.shape[0] // n_shards
                arrs[name] = arr[shard * k:(shard + 1) * k]
        _savez(tmp / f"shard_{shard:04d}.npz", arrs)
    manifest = {
        "step": step, "n_shards": n_shards, "names": list(names),
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():              # overwrite (restart re-saves its resume step)
        shutil.rmtree(final)
    os.replace(tmp, final)          # atomic publish
    return final


def latest_step(ckpt_dir: str | os.PathLike) -> int | None:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")]
    return max(steps) if steps else None


def restore(ckpt_dir: str | os.PathLike, step: int | None = None, template=None):
    """Re-assemble the global state.  Without ``template``: ``({name: numpy
    array}, manifest)``.  With ``template`` (a nested dict of tensors shaped
    like ``{"params": ..., "opt": ...}``): the same tree of tensors, each
    in its template leaf's dtype and on its device."""
    d = pathlib.Path(ckpt_dir)
    step = step if step is not None else latest_step(d)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {d}")
    final = d / f"step_{step:08d}"
    manifest = json.loads((final / "manifest.json").read_text())
    parts: dict[str, list[np.ndarray]] = {}
    for shard in range(manifest["n_shards"]):
        with np.load(final / f"shard_{shard:04d}.npz") as z:
            for name in z.files:
                parts.setdefault(name, []).append(z[name])
    flat = {name: pieces[0] if len(pieces) == 1 else np.concatenate(pieces, 0)
            for name, pieces in parts.items()}
    if template is None:
        return flat, manifest

    def build(node, prefix=""):
        if isinstance(node, dict):
            return {k: build(node[k], f"{prefix}[{k!r}]") for k in sorted(node)}
        return _from_numpy(flat[prefix], node.dtype, node.device)
    return build(template), manifest
