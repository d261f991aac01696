"""The port's sharding rules (``repro_torch/dist/sharding.py``) and mesh
helpers (``launch/mesh.py``) held against the reference's on the CPU.

The rules read only a ``{axis: size}`` mapping, so the reference's run on a
device-free ``jax.sharding.AbstractMesh``: the port's logical-axes trees
equal ``repro.models.lm.param_axes`` / ``cache_axes`` / ``paged_cache_axes``
leaf by leaf for every registered architecture, and ``spec_for``,
``zero_spec`` and ``batch_spec`` equal the reference's on six mesh shapes
over every parameter and cache leaf (shapes from ``lm.param_shapes`` and
the cache initialisers on the meta device).  The cases of
``tests/test_sharding_specs.py`` are mirrored.  What a mesh does with the
specs (local shards, collectives, served streams) is
``tests/test_torch_mesh.py``.
"""

from __future__ import annotations

import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.dist import sharding as ref
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.convert import flatten_with_paths
from repro_torch.dist import sharding as S
from repro_torch.launch import mesh as M
from repro_torch.models import lm as tlm
from repro_torch.models.layers import Axes

ARCHS = tconfigs.list_configs()
MESHES = {"1x1": ((1, 1), ("data", "model")), "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")), "1x8": ((1, 8), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "pod2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
BATCH, MAX_SEQ = 4, 64
POOL_BLOCKS = (16, 17)                # divisible by the data axes, and not


def _names(tree) -> dict:
    return {k: tuple(v.names) for k, v in flatten_with_paths(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_trees_equal_the_references(arch):
    jmodel, tmodel = jconfigs.get_config(arch).model, tconfigs.get_config(arch).model
    assert _names(tlm.param_axes(tmodel)) == _names(jlm.param_axes(jmodel))
    assert _names(tlm.cache_axes(tmodel)) == _names(jlm.cache_axes(jmodel))
    if tlm.model_supports_paging(tmodel):
        assert _names(tlm.paged_cache_axes(tmodel)) == _names(jlm.paged_cache_axes(jmodel))
    for part in ("params", "caches"):             # axes and shapes line up leaf by leaf
        axes, shapes = _leaves(tmodel, part)
        assert all(len(axes[k]) == len(shapes[k]) for k in axes) and axes.keys() == shapes.keys()


def _leaves(tmodel, part: str, n_blocks: int = POOL_BLOCKS[0]):
    """``({path: axis names}, {path: shape})`` of one tree of the model."""
    if part == "params":
        return (_names(tlm.param_axes(tmodel)),
                {k: s.shape for k, s in flatten_with_paths(tlm.param_shapes(tmodel)).items()})
    if part == "caches":
        trees = (tlm.cache_axes(tmodel),
                 tlm.init_caches(tmodel, BATCH, MAX_SEQ, torch.float32, "meta"))
    else:
        trees = (tlm.paged_cache_axes(tmodel),
                 tlm.init_paged_caches(tmodel, n_blocks, 8, torch.float32, "meta"))
    return _names(trees[0]), {k: tuple(v.shape) for k, v in flatten_with_paths(trees[1]).items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_references_on_every_leaf(arch, mesh):
    shape, names = MESHES[mesh]
    amesh = AbstractMesh(shape, names)
    port_mesh = dict(zip(names, shape))
    tmodel = tconfigs.get_config(arch).model
    trees = [_leaves(tmodel, "params"), _leaves(tmodel, "caches")]
    if tlm.model_supports_paging(tmodel):
        trees += [_leaves(tmodel, "paged", n) for n in POOL_BLOCKS]
    n = 0
    for axes, shapes in trees:
        for key, ax in axes.items():
            want = ref.spec_for(JL.Axes(ax), shapes[key], amesh)
            got = S.spec_for(Axes(ax), shapes[key], port_mesh)
            assert got == tuple(want), (key, got, want)
            assert S.zero_spec(got, shapes[key], port_mesh) == \
                tuple(ref.zero_spec(want, shapes[key], amesh)), key
            n += 1
    assert n > 10
    for batch in range(1, 9):
        assert S.batch_spec(port_mesh, batch) == tuple(ref.batch_spec(amesh, batch))


def test_tree_specs_follow_spec_for():
    tmodel = tconfigs.get_reduced("kanformer-100m").model
    mesh = {"data": 2, "model": 2}
    axes, shapes = tlm.param_axes(tmodel), tlm.tree_of_shapes(tlm.param_shapes(tmodel))
    specs = S.tree_specs(axes, shapes, mesh)
    assert specs["embed"]["table"] == ("model", None)
    assert specs["final_ln"]["scale"] == ("model",)
    assert specs["unit"][0]["attn"]["wq"] == (None, None, "model", None)
    assert specs["unit"][0]["kan"]["c1"] == (None, None, None, "model")
    zero = S.tree_zero_specs(axes, shapes, mesh)
    assert zero["unit"][0]["kan"]["c1"] == ("data", None, None, "model")


# ---------------------------------------------------------------------------
# the reference's edge cases (tests/test_sharding_specs.py), mirrored
# ---------------------------------------------------------------------------

MESH = {"data": 2, "model": 4}
POD_MESH = {"pod": 2, "data": 2, "model": 2}
KV = ("batch", "seq_cache", "kv_heads", "head_dim")
POOL = ("kv_blocks", None, "kv_heads", "head_dim")

SPEC_CASES = [
    # nothing divides the model axis: it is not placed; data still lands
    (("embed", "ffn"), (5, 7), MESH, (None, None)),
    (("batch", "ffn"), (6, 7), MESH, ("data", None)),
    # ffn outranks heads, but falls through when it does not divide
    (("ffn", "heads"), (6, 8), MESH, (None, "model")),
    # B=1 decode: seq_cache takes the data axis; with a batch that divides, it does not
    (KV, (1, 64, 4, 16), MESH, (None, "data", "model", None)),
    (KV, (8, 64, 4, 16), MESH, ("data", None, "model", None)),
    # paged pools: kv_blocks takes data; an odd pool replicates; pod+data together
    (POOL, (16, 8, 4, 16), MESH, ("data", None, "model", None)),
    (POOL, (17, 8, 4, 16), MESH, (None, None, "model", None)),
    (POOL, (16, 8, 4, 16), POD_MESH, (("pod", "data"), None, "model", None)),
]


@pytest.mark.parametrize("names,shape,mesh,want", SPEC_CASES)
def test_spec_for_reference_cases(names, shape, mesh, want):
    assert S.spec_for(Axes(names), shape, mesh) == want


ZERO_CASES = [
    (("data", "model"), (8, 8), ("data", "model")),     # fully sharded: identity
    (("data", None), (8, 8), ("data", None)),           # data already used
    ((None, "model"), (7, 8), (None, "model")),         # 7 % 2 != 0
    ((None, "model"), (8, 8), ("data", "model")),
]


@pytest.mark.parametrize("base,shape,want", ZERO_CASES)
def test_zero_spec_reference_cases(base, shape, want):
    assert S.zero_spec(base, shape, MESH) == want


@pytest.mark.parametrize("mesh,batch,want", [(MESH, 1, (None,)), (MESH, 8, ("data",)),
                                             (POD_MESH, 4, (("pod", "data"),)),
                                             (POD_MESH, 2, ("data",))])
def test_batch_spec_reference_cases(mesh, batch, want):
    assert S.batch_spec(mesh, batch) == want


def test_spec_for_rejects_mismatched_axes():
    with pytest.raises(ValueError, match="do not match"):
        S.spec_for(Axes(("embed",)), (4, 4), MESH)


# ---------------------------------------------------------------------------
# launch/mesh.py
# ---------------------------------------------------------------------------


def test_parse_mesh_shape_and_its_errors():
    assert M.parse_mesh_shape("2x4") == (2, 4)
    assert M.parse_mesh_shape("1X1") == (1, 1)
    for bad, msg in (("2x", "integers"), ("8", "DxM"), ("2x2x2", "DxM"), ("ax2", "integers")):
        with pytest.raises(ValueError, match=msg):
            M.parse_mesh_shape(bad)
    with pytest.raises(ValueError, match="positive"):
        M.make_host_mesh((0, 1))
    with pytest.raises(ValueError, match="host mesh 2x2 needs 4 ranks"):
        M.make_host_mesh((2, 2))          # no process group in this process
    assert M.devices_missing((2, 2), "cpu") is None
    assert M.backend("cpu") == "gloo" and M.backend("cuda", share_card=True) == "gloo"
    assert M.backend("cuda") == "nccl"
