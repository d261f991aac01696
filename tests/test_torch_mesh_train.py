"""Training on a mesh on the CPU (``train/step.py``'s ``shard``,
``optim/adamw.py``'s ZeRO slices, ``checkpoint/store.py`` from a mesh,
``launch/elastic.py``, ``launch/train.py`` in a process group).

One spawned 2x2 ``(data, model)`` gloo group (``tests/torch_mesh_train_cells.py``,
which imports no JAX) trains reduced kanformer-100m, reduced qwen1.5-0.5b
and an MQA kanformer whose one KV head and 509-token vocabulary the model
axis cannot split, at fp64 and fp32, and the ranks share the unmeshed
references.  The reference's mesh code cannot be the oracle on this jax
(ROADMAP queue 3), so the mesh is held to the port's ``shard=None`` step,
which ``tests/test_torch_train.py`` holds to the reference's.

* At fp64 the losses and the stitched gradients agree within 1e-10 (of
  the loss, of each leaf's max|g|), and the parameters and moments after 3
  AdamW steps within 1e-10: the gradients round to the same fp32 values,
  the norm's squares are summed in fp64 (``adamw.global_norm``), and the
  optimizer's fp32 arithmetic then gives the same bits.
* At fp32 a data split is a split into microbatches, which moves a sum by
  an fp32 rounding: the losses within ``LOSS_RTOL`` and the gradients within
  ``GRAD_REL`` of each leaf's max|g|, as the pipeline's tests
  (``tests/test_torch_pipeline.py``); Adam normalises each element's step,
  so an element whose gradient is near zero moves by a different fraction
  of lr, and the parameters are held to ``STEP_ATOL`` x lr, as
  ``tests/test_torch_train.py`` holds the port to the reference.
* Each fp64 case again with the int8 wire format, and with
  ``master_weights``, ``accum_steps=2`` and the bf16 wire format together;
  at fp32 kanformer's.
* ZeRO: ``m``, ``v`` and ``master`` have ``tree_zero_specs``' local shapes;
  the sharded update is bit-equal to the unsharded one for the same
  gradients; the optimizer bytes per rank.
* A checkpoint written on 2x2 restores bit-equal in the port and in the
  JAX package, and ``restore_elastic`` continues it unmeshed, on 1x1 and on
  1x2 equal to the straight run; a JAX-written checkpoint restores onto the
  2x2 mesh.
* ``launch.train.run`` in the group trains on ``(1, 4)``, rank 0 alone
  prints, a failure planted on every rank is retried together, and a
  SIGTERM to one rank stops every rank at the same step.
* In process: a one-rank group's step is bit-identical to ``shard=None``
  (kanformer, reduced olmoe and reduced deepseek-v2-lite); the launcher
  trains olmoe in the group; the refused families raise ``ValueError``
  naming item 9.4.2, and the launcher exits with rc=2 on them.

The four MoE models of the serving battery (``tests/torch_mesh_cells.py``:
experts on the model axis with tokens dropping at capacity 1.25, each
expert's ffn on it, GQA with a shared expert, the einsum dispatch) take
every case above; the routing of each microbatch is the global
microbatch's, its auxiliaries the whole batch's, and the router's gradient
sums its rows in fp64 (``models/moe.py``), so fp64 holds to 1e-10 there
too.  Reduced olmoe's checkpoint continues on 1x1 as kanformer's.

Reduced deepseek-v2-lite (MLA: heads on model, the latent projection and
its norm gathered whole; its MoE and dense prologue as above) takes every
case too, and the serving battery's three other MLA placements (a latent
split inside its rope block, 3 heads whole on every rank, a 23-column
latent) the fp64 gradient case.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_train_cells as cells
from repro.checkpoint import store as jstore
from repro.optim import adamw as jadam
from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.convert import flatten_with_paths, params_from_jax
from repro_torch.dist.sharding import ShardingCtx, tree_specs, tree_zero_specs
from repro_torch.launch import elastic
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launcher
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import step as TS
from test_torch_train import numpy_params

SHAPE = (2, 2)
MESH = {"data": 2, "model": 2}
FP64_TOL = 1e-10
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP_ATOL = 1e-1                    # times lr (tests/test_torch_train.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The in-process steps are many small torch ops; one thread keeps them
    from contending for the cores with the other test workers and the
    spawned ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A checkpoint of reduced qwen1.5-0.5b that the JAX package wrote."""
    path = str(tmp_path_factory.mktemp("jax_ckpt"))
    tree = jax.tree.map(jnp.asarray, numpy_params(cells.QWEN, 11))
    jstore.save(path, 3, (tree, jadam.init_state(tree)))
    return path


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_ckpt"))


@pytest.fixture(scope="module")
def ranks(ckpt_dir, jax_ckpt):
    return M.run_ranks(cells.run_battery, SHAPE, "cpu", args=(ckpt_dir, jax_ckpt))


def _specs(key: str, zero: bool = False) -> dict:
    """``{path: (whole shape, spec)}`` of a model's parameters (or of their
    ZeRO state) on the 2x2 mesh."""
    cfg = cells.ALL_MODELS[key]
    leaves = lm.param_shapes(cfg)
    rule = tree_zero_specs if zero else tree_specs
    specs = rule(lm.param_axes(cfg), lm.tree_of_shapes(leaves), MESH)
    placed = store.spec_paths(leaves, specs)
    return {k: (v.shape, placed[k]) for k, v in flatten_with_paths(leaves).items()}


def _stitch(key: str, trees: list, coords: list, zero: bool = False) -> dict:
    """Each rank's blocks written where its coordinates place them -> the
    whole leaves; ranks that hold the same block hold the same bits."""
    out = {}
    flats = [flatten_with_paths(t) for t in trees]
    for path, (shape, spec) in _specs(key, zero).items():
        whole = torch.full(shape, float("nan"), dtype=flats[0][path].dtype)
        seen = {}
        for coord, flat in zip(coords, flats):
            view, where = whole, []
            for i, axis in enumerate(spec):
                if axis is not None:
                    n = flat[path].shape[i]
                    c = coord[("data", "model").index(axis)]
                    view, where = view.narrow(i, c * n, n), where + [(i, c)]
            block = seen.setdefault(tuple(where), flat[path])
            assert torch.equal(block, flat[path]), (path, coord)
            view.copy_(flat[path])
        assert not torch.isnan(whole).any(), path
        out[path] = whole
    return out


def _ref(ranks, kind: str, case: tuple):
    (found,) = [r[kind][case] for r in ranks if case in r[kind]]
    return found


def _coords(ranks) -> list:
    return [r["coord"] for r in ranks]


def _max_err(got: dict, want: dict, rel: bool = False) -> float:
    errs = []
    for k, w in flatten_with_paths(want).items():
        e = float((got[k].double() - w.double()).abs().max())
        errs.append(e / max(float(w.abs().max()), 1e-30) if rel else e)
    return max(errs)


@pytest.mark.parametrize("key,dtype", cells.GRAD_CASES)
def test_losses_and_stitched_gradients(ranks, key, dtype):
    ref = _ref(ranks, "ref_grads", (key, dtype))
    got = [r["grads"][key, dtype] for r in ranks]
    loss_tol, grad_rel = (FP64_TOL, FP64_TOL) if dtype == "fp64" else (LOSS_RTOL, GRAD_REL)
    for g in got:
        assert g["ntokens"] == ref["ntokens"] == 44.0          # the whole batch's labels
        np.testing.assert_allclose(g["loss"], ref["loss"], rtol=loss_tol)
    grads = _stitch(key, [g["grads"] for g in got], _coords(ranks))
    assert _max_err(grads, ref["grads"], rel=True) <= grad_rel


@pytest.mark.parametrize("key,dtype,variant", cells.TRAIN_CASES)
def test_three_adamw_steps_match_the_unmeshed_step(ranks, key, dtype, variant):
    ref = _ref(ranks, "ref_train", (key, dtype, variant))
    got = [r["train"][key, dtype, variant] for r in ranks]
    params = _stitch(key, [g["params"] for g in got], _coords(ranks))
    for g in got:
        assert g["losses"] == got[0]["losses"]
    if dtype == "fp64":
        np.testing.assert_allclose(got[0]["losses"], ref["losses"], rtol=FP64_TOL)
        assert _max_err(params, ref["params"]) <= FP64_TOL
        for name in ("m", "v") + (("master",) if variant == cells.MASTER else ()):
            state = _stitch(key, [g["state"][name] for g in got], _coords(ranks), zero=True)
            assert _max_err(state, ref["state"][name]) <= FP64_TOL, name
    else:
        np.testing.assert_allclose(got[0]["losses"], ref["losses"], rtol=LOSS_RTOL)
        assert _max_err(params, ref["params"]) <= STEP_ATOL * cells.LR


@pytest.mark.parametrize("key", sorted(cells.MODELS))
def test_zero_state_has_the_local_shapes_of_tree_zero_specs(ranks, key):
    specs = _specs(key, zero=True)
    split = 0
    for r in ranks:
        state = r["train"][key, "fp64", cells.MASTER]["state"]
        for name in ("m", "v", "master"):
            for path, leaf in flatten_with_paths(state[name]).items():
                shape, spec = specs[path]
                want = tuple(n // MESH[a] if a else n for n, a in zip(shape, spec))
                assert tuple(leaf.shape) == want, (name, path)
                split += "data" in spec
        assert state["step"].shape == () and int(state["step"]) == cells.STEPS
    assert split > 0
    if key == "mqa":
        # the table (509, 64) takes model on embed and no dim that data
        # divides: zero_spec falls back to the parameter's spec
        assert specs["['embed']/['table']"][1] == (None, "model")


def test_zero_state_is_split_not_copied(ranks):
    """Where ZeRO splits a leaf over data, the two data ranks' blocks hold
    its model-local elements once; each rank holds about a quarter of the
    whole fp32 ``m``, ``v`` and ``master``."""
    for key in cells.MODELS:
        whole = sum(math_prod(shape) for shape, _ in _specs(key).values()) * 4 * 3
        local = sum(math_prod(tuple(n // MESH[a] if a else n for n, a in zip(shape, spec)))
                    for shape, spec in _specs(key, zero=True).values()) * 4 * 3
        for r in ranks:
            assert r["zero_bytes"][key] == local
        assert local < 0.3 * whole, (key, local, whole)


def math_prod(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


@pytest.mark.parametrize("master", [False, True])
def test_zero_update_is_bit_equal_to_the_unsharded_update(ranks, master):
    for r in ranks:
        got, want = (flatten_with_paths(r["zero"][master][k]) for k in ("got", "want"))
        assert got.keys() == want.keys() and len(got) > 20
        for k in got:
            assert torch.equal(got[k], want[k]), (r["coord"], k)


def test_checkpoint_from_2x2_restores_whole_in_the_port_and_in_jax(ranks, ckpt_dir):
    key, _ = cells.CKPT_KEY
    at = [r["train"][cells.CKPT_KEY + ("plain",)]["at_ckpt"] for r in ranks]
    params = _stitch(key, [a[0] for a in at], _coords(ranks))
    moments = {n: _stitch(key, [a[1][n] for a in at], _coords(ranks), zero=True)
               for n in ("m", "v")}
    got, _, mf = elastic.restore_elastic(ckpt_dir, cells.CKPT_AT, cells.KAN, None,
                                         torch.float64, device="cpu")
    assert mf["step"] == cells.CKPT_AT and mf["done"]
    with np.load(os.path.join(ckpt_dir, f"step_{cells.CKPT_AT:08d}", "arrays.npz")) as data:
        keys = set(data.files)
    like = jax.tree.map(lambda a: np.zeros(a.shape, np.float64), numpy_params(cells.KAN, 0))
    (jparams, jstate), _ = jstore.restore(ckpt_dir, cells.CKPT_AT,
                                          (like, {"m": like, "v": like,
                                                  "step": np.zeros((), np.int32)}))
    jflat = flatten_with_paths(jax.tree.map(np.asarray, jparams))
    for k, v in flatten_with_paths(got).items():
        assert v.numpy().tobytes() == params[k].numpy().tobytes() == jflat[k].tobytes(), k
        assert "[0]/" + k in keys
    state = store.restore(ckpt_dir, cells.CKPT_AT, (got, adamw.init_state(got)),
                          device="cpu")[0][1]
    for n in ("m", "v"):
        for k, v in flatten_with_paths(state[n]).items():
            assert torch.equal(v, moments[n][k]), (n, k)
    assert int(state["step"]) == cells.CKPT_AT


def test_checkpoint_from_2x2_continues_unmeshed_on_1x1_and_on_1x2(ranks, ckpt_dir, tmp_path):
    key, dtype = cells.CKPT_KEY
    straight = [r["train"][key, dtype, "plain"] for r in ranks]
    want = _stitch(key, [s["params"] for s in straight], _coords(ranks))
    unmeshed = cells.continue_case(ckpt_dir)
    assert unmeshed["step"] == cells.CKPT_AT
    np.testing.assert_allclose(unmeshed["losses"], straight[0]["losses"][cells.CKPT_AT:],
                               rtol=FP64_TOL)
    assert _max_err(want, unmeshed["params"]) <= FP64_TOL
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        one = cells.continue_case(ckpt_dir, ShardingCtx(M.make_host_mesh((1, 1))))
    finally:
        dist.destroy_process_group()
    assert one["losses"] == unmeshed["losses"]
    for k, v in flatten_with_paths(unmeshed["params"]).items():
        assert torch.equal(flatten_with_paths(one["params"])[k], v), k
    # 1x2: each rank restored the model slices of its coordinate
    specs = {k: tuple(a if a == "model" else None for a in spec)
             for k, (_, spec) in _specs(key).items()}
    whole = flatten_with_paths(unmeshed["restored"])
    for r in ranks:
        t = r["one_by_two"]
        assert t["coord"][0] == 0 and t["losses"] == ranks[0]["one_by_two"]["losses"]
        for k, v in flatten_with_paths(t["restored"]).items():
            n = v.shape[specs[k].index("model")] if "model" in specs[k] else None
            block = whole[k] if n is None else whole[k].narrow(
                specs[k].index("model"), t["coord"][1] * n, n)
            assert torch.equal(v, block), k
    np.testing.assert_allclose(ranks[0]["one_by_two"]["losses"], unmeshed["losses"],
                               rtol=FP64_TOL)
    pair = [r for r in ranks if r["coord"][0] == 0]
    got = _stitch(key, [r["one_by_two"]["params"] for r in pair] * 2,
                  [(0, r["one_by_two"]["coord"][1]) for r in pair]
                  + [(1, r["one_by_two"]["coord"][1]) for r in pair])
    assert _max_err(got, unmeshed["params"]) <= FP64_TOL


def test_moe_checkpoint_from_2x2_continues_unmeshed_and_on_1x1(ranks, ckpt_dir, tmp_path):
    """Reduced olmoe's fp64 run saved on 2x2 (expert leaves split over model,
    their moments ZeRO-split over data) continues through ``restore_elastic``
    unmeshed and on a 1x1 mesh equal to the straight 2x2 run."""
    key, dtype = cells.MOE_CKPT_KEY
    path = cells.ckpt_path(ckpt_dir, cells.MOE_CKPT_KEY)
    straight = [r["train"][key, dtype, "plain"] for r in ranks]
    want = _stitch(key, [s["params"] for s in straight], _coords(ranks))
    unmeshed = cells.continue_case(path, case=cells.MOE_CKPT_KEY)
    assert unmeshed["step"] == cells.CKPT_AT and len(unmeshed["losses"]) == 2
    np.testing.assert_allclose(unmeshed["losses"], straight[0]["losses"][cells.CKPT_AT:],
                               rtol=FP64_TOL)
    assert _max_err(want, unmeshed["params"]) <= FP64_TOL
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        one = cells.continue_case(path, ShardingCtx(M.make_host_mesh((1, 1))),
                                  case=cells.MOE_CKPT_KEY)
    finally:
        dist.destroy_process_group()
    assert one["losses"] == unmeshed["losses"]
    for k, v in flatten_with_paths(unmeshed["params"]).items():
        assert torch.equal(flatten_with_paths(one["params"])[k], v), k


def test_a_jax_checkpoint_restores_onto_the_2x2_mesh(ranks, jax_ckpt):
    whole = params_from_jax(numpy_params(cells.QWEN, 11), device="cpu")
    params, state, mf = elastic.restore_elastic(jax_ckpt, 3, cells.QWEN, None, torch.float32,
                                                device="cpu")
    assert mf["step"] == 3 and int(state["step"]) == 0
    for k, v in flatten_with_paths(whole).items():
        assert torch.equal(flatten_with_paths(params)[k], v), k
    got = _stitch("qwen", [r["jax_restore"] for r in ranks], _coords(ranks))
    for k, v in flatten_with_paths(whole).items():
        assert torch.equal(got[k], v), k


def test_the_launcher_trains_on_1_by_world_and_agrees_retries_and_stops(ranks, ckpt_dir):
    outs = [r["launcher"] for r in ranks]
    first = outs[0]
    assert first["mesh"] == {"data": 1, "model": 4}
    # the planted failure on every rank at call 2 (step 1) is retried together, and
    # rank 1's SIGTERM during step 2 stops every rank after it
    assert all(o["steps"] == 3 and o["losses"] == first["losses"] for o in outs)
    assert "[retry] step 1 attempt 1: planted one-off failure" in first["stdout"]
    assert "[done] steps=3" in first["stdout"]
    assert all(o["stdout"] == "" for o in outs[1:])
    assert store.all_steps(os.path.join(ckpt_dir, "launcher")) == [2, 3]
    alone = launcher.run(cells.LAUNCH)
    np.testing.assert_allclose(first["losses"], alone["losses"][:3], rtol=LOSS_RTOL)


def test_one_rank_mesh_step_is_bit_identical_and_refusals_exit_2(tmp_path, capsys):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        shard = ShardingCtx(M.make_host_mesh((1, 1)))
        for variant in ("plain", cells.MASTER):
            want = cells.train_case("kan", "fp32", variant, steps=2)
            got = cells.train_case("kan", "fp32", variant, shard, steps=2)
            assert got["losses"] == want["losses"]
            for a, b in ((got["params"], want["params"]), (got["state"], want["state"])):
                fa, fb = flatten_with_paths(a), flatten_with_paths(b)
                assert fa.keys() == fb.keys()
                assert all(torch.equal(fa[k], fb[k]) for k in fa), variant
        for key in ("moe", "mla"):
            want = cells.train_case(key, "fp32", "plain", steps=2)
            got = cells.train_case(key, "fp32", "plain", shard, steps=2)
            assert got["losses"] == want["losses"]
            fa, fb = (flatten_with_paths(t) for t in ((got["params"], got["state"]),
                                                       (want["params"], want["state"])))
            assert all(torch.equal(fa[k], fb[k]) for k in fb), key
        # MoE and MLA train in the group (item 9.4.2 steps 2 and 3); recurrent
        # models stay refused
        rc = launcher.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                            "--steps", "2", "--batch", "4", "--seq", "8"])
        assert rc == 0 and "[done] steps=2" in capsys.readouterr().out
        rc = launcher.main(["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu"])
        assert rc == 2 and "item 9.4.2" in capsys.readouterr().err
    finally:
        dist.destroy_process_group()


ACCEPTED = ("olmoe-1b-7b", "deepseek-v2-lite")


@pytest.mark.parametrize("arch,why", [
    ("olmoe-1b-7b", "MoE experts"), ("deepseek-v2-lite", "MLA"),
    ("zamba2-1.2b", "recurrent"), ("xlstm-1.3b", "recurrent"),
    ("gemma3-12b", "windowed"), ("paligemma-3b", "inputs"), ("musicgen-large", "inputs"),
])
def test_the_mesh_refuses_to_train_other_families(arch, why):
    cfg = configs.get_reduced(arch).model
    shard = ShardingCtx(object())
    opt = adamw.AdamWConfig()
    if arch in ACCEPTED:              # MoE experts and MLA train on a mesh (item 9.4.2)
        assert lm.mesh_refusal(cfg) is None
        assert callable(TS.make_train_step(cfg, opt, shard=shard))
        return
    with pytest.raises(ValueError, match=f"{why}.*item 9.4.2"):
        TS.make_train_step(cfg, opt, shard=shard)
    with pytest.raises(ValueError, match="item 9.4.2"):
        lm.forward({}, cfg, {}, shard=shard)
