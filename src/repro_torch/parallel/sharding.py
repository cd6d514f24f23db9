"""Logical-axis sharding rules (MaxText-style) over ``torch.distributed``.

Every parameter/cache dimension carries a logical name; a per-(arch × mesh ×
shape) rules table maps names → mesh axes.  ``resolve`` validates
divisibility and mesh-axis reuse per tensor, dropping infeasible mappings to
replication — so one rules table covers every architecture without
special-casing (xlstm's 4 heads simply stay unsharded on a 16-wide model
axis, etc.).

A port of ``repro.parallel.sharding``.  ``rules_for`` and ``resolve`` take a
mesh as its ``{name: size}`` (or a ``DeviceMesh``, read the same way), so
they need no process group.  ``resolve`` returns the reference's
``PartitionSpec`` as a tuple: per tensor dim ``None``, one mesh axis name,
or a tuple of names, trailing ``None``s dropped.  :func:`placements` turns
that spec into DTensor placements (one per mesh dim), :func:`distribute`
turns a tree of tensors (real or fake) into DTensors.
"""
from __future__ import annotations

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.models.params import map_tree

# default logical -> mesh mapping; tuples = sharded over several axes
DEFAULT_RULES: dict[str | None, tuple[str, ...] | str | None] = {
    "embed": ("pod", "data"),     # ZeRO-3-style: params fully sharded over DP
    "mlp": "model",
    "expert_mlp": None,           # expert inner dim (used when experts shard)
    "heads": "model",
    "kv": "model",
    "head": None,
    "vocab": "model",
    "expert": "model",
    "layers": None,
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "cache_seq": None,
    None: None,
}


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of such a dict, in the
    mesh's axis order."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def rules_for(cfg, mesh, shape_kind: str, seq_len: int = 0,
              global_batch: int = 0, n_params: float = 0.0) -> dict:
    """Per-arch/per-cell adaptation of the default rules."""
    shape = mesh_shape(mesh)
    rules = dict(DEFAULT_RULES)
    model_size = shape.get("model", 1)
    if cfg.moe_experts and cfg.moe_experts % model_size != 0:
        # experts unshardable (mixtral: 8 experts, 16-wide model axis):
        # shard each expert's hidden dim instead
        rules["expert"] = None
        rules["expert_mlp"] = "model"
    if shape_kind == "decode":
        # Serving is weight-stationary: small models replicate over DP with
        # TP-resident weights; beyond-HBM giants keep weights fully sharded
        # and replicate the batch instead (experts over every mesh axis).
        tp_resident_gb = (n_params * 2 / model_size) / 1e9
        if n_params and tp_resident_gb <= 8.0:
            rules["embed"] = None
            rules["expert"] = rules["expert"] if cfg.moe_experts else None
        elif n_params:
            rules["act_batch"] = None          # batch replicated; weights stay
            if cfg.moe_experts:
                rules["expert"] = ("pod", "data", "model")
        dp = shape.get("pod", 1) * shape.get("data", 1)
        if global_batch % dp != 0:
            # long_500k: batch 1 — shard the KV/cache sequence instead
            # (sequence-parallel decode)
            rules["act_batch"] = None
            rules["cache_seq"] = "data"
        if cfg.n_kv % model_size != 0:
            rules["kv"] = None
            if rules["cache_seq"] is None:
                rules["cache_seq"] = "model"
    return rules


def resolve(axes: tuple, shape: tuple, rules: dict, mesh) -> tuple:
    """Map logical axes -> PartitionSpec entries, enforcing divisibility and
    one-use-per-mesh-axis within the tensor."""
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, axes):
        mapping = rules.get(name, None)
        if mapping is None:
            out.append(None)
            continue
        axes_tuple = (mapping,) if isinstance(mapping, str) else tuple(mapping)
        picked = []
        size = 1
        for ax in axes_tuple:
            if ax in sizes and ax not in used and dim % (size * sizes[ax]) == 0:
                picked.append(ax)
                size *= sizes[ax]
        if picked:
            used.update(picked)
            out.append(tuple(picked) if len(picked) > 1 else picked[0])
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of a :func:`resolve` spec.
    Where several mesh axes shard one tensor dim (``("pod", "data")``) they
    shard it in the spec's order, as GSPMD does; DTensor shards a dim over
    mesh dims in mesh order, so the spec must name them in that order.  A
    mesh dim of size 1 is ``Replicate()``: it holds the whole tensor either
    way, and a replicated dim is one DTensor may flatten and view freely."""
    sizes = mesh_shape(mesh)
    names = list(sizes)
    out: list = [Replicate()] * len(names)
    for tdim, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(ax) for ax in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: {group} is not in the mesh's order {names}")
        for i in idx:
            if sizes[names[i]] > 1:       # a mesh dim of size 1 shards nothing: replicate
                out[i] = Shard(tdim)
    return tuple(out)


def spec_of(places, mesh) -> tuple:
    """The :func:`resolve` spec of DTensor placements (the inverse of
    :func:`placements`)."""
    names = list(mesh_shape(mesh))
    per_dim: dict[int, list[str]] = {}
    for name, p in zip(names, places):
        if p.is_shard():
            per_dim.setdefault(p.dim, []).append(name)
    out = [None] * (max(per_dim) + 1 if per_dim else 0)
    for d, group in per_dim.items():
        out[d] = group[0] if len(group) == 1 else tuple(group)
    return tuple(out)


def batch_axes(struct_tree):
    """Inputs: the leading (batch) dim is ``act_batch``; scalars replicate."""
    return map_tree(lambda s: ("act_batch",) + (None,) * (len(s.shape) - 1)
                    if len(s.shape) else (), struct_tree)


def _zip_map(fn, axes_tree, tree):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, axes_tree[k], tree[k]) for k in sorted(tree)}
    return fn(tuple(axes_tree), tree)


def tree_shardings(axes_tree, struct_tree, rules: dict, mesh):
    """DTensor placements for a tree of structs (or tensors) given its
    logical axes tree."""
    return _zip_map(lambda axes, s: placements(resolve(axes, tuple(s.shape), rules, mesh), mesh),
                    axes_tree, struct_tree)


def batch_shardings(batch_structs, rules: dict, mesh):
    """Inputs: shard the leading (batch) dim; scalars replicate."""
    return tree_shardings(batch_axes(batch_structs), batch_structs, rules, mesh)


def distribute(tree, axes_tree, rules: dict, mesh):
    """Every tensor of ``tree`` (real or fake, the same whole tensor on
    every rank) as a DTensor on the ``DeviceMesh`` ``mesh``, placed by the
    rules; each rank keeps its own shard, with no communication."""

    def one(axes, t):
        spec = resolve(axes, tuple(t.shape), rules, mesh)
        return distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=None)
    return _zip_map(one, axes_tree, tree)
