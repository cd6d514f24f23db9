"""The port's sharding rules and the ``Model`` methods the dry-run needs,
against the JAX package on the same configs: ``rules_for`` and ``resolve``
for every parameter, cache and input leaf of every (architecture × shape)
cell on the single, multi and (4, 2) debug meshes; ``tree_shardings`` and
``batch_shardings`` placement for placement; ``param_axes``,
``param_structs``, ``cache_axes``, ``cache_structs`` and ``input_specs``
leaf for leaf (key paths, shapes, dtypes); ``placements`` round-tripped.
Mirrors ``tests/test_runtime.py::test_resolve_divisibility_and_reuse`` and
``::test_rules_for_moe_fallback``.  Every comparison is exact.  No process
group is needed: the rules take a mesh as its ``{name: size}``."""
import jax
import jax.numpy as jnp
import jax.sharding as js
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.registry import cells as jax_cells
from repro.models.api import build_model as jax_build_model
from repro.parallel import sharding as JS
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, cells
from repro_torch.models.api import build_model
from repro_torch.parallel import sharding as S

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16},
          "debug": {"data": 4, "model": 2}}
CELLS = cells()


def _jax_mesh(shape: dict):
    """The reference's mesh over one device repeated (``_fake_mesh`` of
    ``tests/test_runtime.py``): only its ``shape`` is read."""
    n = int(np.prod(list(shape.values())))
    return js.Mesh(np.array([jax.devices()[0]] * n).reshape(*shape.values()), tuple(shape))


def _flat(tree, prefix=()):
    """``{key path: leaf}`` of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _jax_spec(ps) -> tuple:
    return tuple(ps)


def test_cells_match_the_reference():
    assert CELLS == jax_cells()


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch,shape,skip", CELLS, ids=[f"{a}-{s}" for a, s, _ in CELLS])
def test_rules_and_resolve_match_reference(arch, shape, skip, mesh_kind):
    """``rules_for`` equal; then ``resolve`` (and ``tree_shardings`` /
    ``batch_shardings`` read back through ``spec_of``) equal for every
    parameter, input and, in a decode cell, cache leaf; skipped cells
    included."""
    mshape = MESHES[mesh_kind]
    jmesh = _jax_mesh(mshape)
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    cell, jcell = SHAPES[shape], JSHAPES[shape]
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    assert model.n_params == jmodel.n_params
    rules = S.rules_for(cfg, mshape, cell.kind, cell.seq_len, cell.global_batch,
                        n_params=model.n_params)
    jrules = JS.rules_for(jcfg, jmesh, jcell.kind, jcell.seq_len, jcell.global_batch,
                          n_params=jmodel.n_params)
    assert rules == jrules

    trees = {"params": (model.param_axes(), model.param_structs(),
                        jmodel.param_axes(), jmodel.param_structs())}
    inputs, jinputs = model.input_specs(cell), jmodel.input_specs(jcell)
    if cell.kind == "decode":
        trees["cache"] = (model.cache_axes(), inputs["cache"],
                          jmodel.cache_axes(), jinputs["cache"])
        inputs = {"tokens": inputs["tokens"]}
        jinputs = {"tokens": jinputs["tokens"]}
    trees["inputs"] = (S.batch_axes(inputs), inputs, None, jinputs)
    for name, (axes, structs, jaxes, jstructs) in trees.items():
        got = _flat(S.tree_shardings(axes, structs, rules, mshape)) if name != "inputs" \
            else _flat(S.batch_shardings(structs, rules, mshape))
        fa, fs, fj = _flat(axes), _flat(structs), _flat(jstructs)
        fja = _flat(jaxes) if jaxes is not None else None
        assert set(got) == set(fs) == set(fj), name
        for path, struct in fs.items():
            if fja is not None:
                assert tuple(fa[path]) == tuple(fja[path]), (name, path)
                want = JS.resolve(tuple(fja[path]), fj[path].shape, jrules, jmesh)
            else:
                ndim = len(fj[path].shape)
                want = js.PartitionSpec() if ndim == 0 else JS.resolve(
                    ("act_batch",) + (None,) * (ndim - 1), fj[path].shape, jrules, jmesh)
            spec = S.resolve(tuple(fa[path]), struct.shape, rules, mshape)
            assert spec == _jax_spec(want), (name, path, spec, want)
            assert S.spec_of(got[path], mshape) == spec, (name, path)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_methods_match_reference(arch, shape):
    """``param_axes``, ``param_structs``, ``cache_axes``, ``cache_structs``
    and ``input_specs`` leaf for leaf: key paths, axes, shapes, dtypes."""
    model, jmodel = build_model(ARCHS[arch]), jax_build_model(JAX_ARCHS[arch])
    cell = SHAPES[shape]

    def same_structs(a, b):
        fa, fb = _flat(a), _flat(b)
        assert set(fa) == set(fb)
        for k in fa:
            assert tuple(fa[k].shape) == tuple(fb[k].shape), k
            assert _dtype_name(fa[k].dtype) == _dtype_name(jnp.dtype(fb[k].dtype)), k

    def same_axes(a, b):
        fa, fb = _flat(a), _flat(b)
        assert set(fa) == set(fb)
        assert all(tuple(fa[k]) == tuple(fb[k]) for k in fa)

    same_axes(model.param_axes(), jmodel.param_axes())
    same_structs(model.param_structs(), jmodel.param_structs())
    same_axes(model.cache_axes(), jmodel.cache_axes())
    B, S_ = cell.global_batch, cell.seq_len
    same_structs(model.cache_structs(B, S_), jmodel.cache_structs(B, S_))
    same_structs(model.input_specs(shape), jmodel.input_specs(shape))
    same_structs(model.input_specs(cell), jmodel.input_specs(JSHAPES[shape]))
    # the cache axes name every cache leaf, with its rank
    fa, fs = _flat(model.cache_axes()), _flat(model.cache_structs(2, 8))
    assert set(fa) == set(fs) and all(len(fa[k]) == len(fs[k].shape) for k in fa)


def test_resolve_divisibility_and_reuse():
    """``tests/test_runtime.py::test_resolve_divisibility_and_reuse``."""
    mesh = {"data": 4, "model": 2}
    rules = dict(S.DEFAULT_RULES)
    # embed 8 divisible by data=4 -> sharded; heads 3 not divisible by 2 -> None
    assert S.resolve(("embed", "heads"), (8, 3), rules, mesh) == ("data",)
    # one mesh axis cannot be used twice in a tensor
    assert S.resolve(("mlp", "heads"), (8, 8), rules, mesh) == ("model",)
    assert S.DEFAULT_RULES == JS.DEFAULT_RULES


def test_rules_for_moe_fallback():
    """``tests/test_runtime.py::test_rules_for_moe_fallback``."""
    mesh = {"data": 2, "model": 16}
    rules = S.rules_for(ARCHS["mixtral-8x22b"], mesh, "train")
    assert rules["expert"] is None          # 8 experts % 16 != 0
    assert rules["expert_mlp"] == "model"   # shard expert hidden instead
    rules2 = S.rules_for(ARCHS["deepseek-v3-671b"], mesh, "train")
    assert rules2["expert"] == "model"      # 256 % 16 == 0


ROUND_TRIPS = [
    ({"pod": 2, "data": 16, "model": 16}, (("pod", "data"), "model"),
     (Shard(0), Shard(0), Shard(1))),
    ({"pod": 2, "data": 16, "model": 16}, (None, ("pod", "data", "model")),
     (Shard(1), Shard(1), Shard(1))),
    ({"pod": 2, "data": 16, "model": 16}, ("model", None, ("pod", "data")),
     (Shard(2), Shard(2), Shard(0))),
    ({"data": 4, "model": 2}, (None, None, "data"), (Shard(2), Replicate())),
    ({"data": 4, "model": 2}, (), (Replicate(), Replicate())),
]


@pytest.mark.parametrize("mesh,spec,want", ROUND_TRIPS)
def test_placements_round_trip(mesh, spec, want):
    """Several mesh axes on one tensor dim shard it in the spec's order (the
    mesh's order); ``spec_of`` inverts ``placements``."""
    got = S.placements(spec, mesh)
    assert got == want
    assert S.spec_of(got, mesh) == spec


def test_placements_refuse_an_order_dtensor_cannot_hold():
    with pytest.raises(ValueError, match="order"):
        S.placements((("data", "pod"),), {"pod": 2, "data": 16, "model": 16})


def test_struct_allocates_nothing_and_reads_like_a_shape_dtype_struct():
    s = build_model(ARCHS["granite-3-2b"]).param_structs()["embed"]
    assert s.shape == (49155, 2048) and s.dtype == torch.bfloat16 and s.ndim == 2
    assert not isinstance(s, torch.Tensor)
