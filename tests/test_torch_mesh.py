"""Mesh serving on the CPU (``ServeConfig.mesh``, ``launch/mesh.py``,
``dist/sharding.py``): the reference battery (``tests/test_mesh_serving.py``)
on the port.

One spawned 2x2 ``(data, model)`` gloo group serves the battery's eight
continuous cells and its static sampled run on reduced kanformer-100m and
reduced qwen1.5-0.5b with an int8 KV cache (parameters from the JAX
package's init, ``convert.params_from_jax``), an MQA kanformer whose
one KV head the model axis cannot split, and four MoE models (reduced
olmoe-1b-7b, 8 experts on the model axis at capacity 1.25; 5 experts, whose
ffn takes it; GQA with a shared expert; the einsum dispatch) dense, paged,
on a data-split pool and in static buckets, and four MLA models (reduced
deepseek-v2-lite, heads and latent columns split, its rope block whole on
one rank; a latent split inside its rope block; 3 heads, whole on every
rank; a 23-column latent, whole on every rank) dense greedy, deepseek also
sampled and in static buckets.  Every rank's tokens equal the
port's ``mesh=None`` run in rank 0's process, which ``tests/test_torch_mla.py``
holds to the JAX package.  An fp64 MLA prefill and decode: the latent
columns stitched by the reference's spec within 1e-12 of the unmeshed
cache, the logits within 1e-10, and each decode step's collectives (a
wrapper around ``torch.distributed``'s) the split read's small ones.  The MoE routes the global
batch: a fp64 prefill's routing integers and drop fractions on each rank
equal the unmeshed whole batch's at its rows.  The distribution proofs
read the shards' shapes: ``wq`` heads / 2, dense ``k`` batch / 2 and KV
heads / 2, pool blocks / 2 (an odd pool whole), the int8 ``k_scale`` on
``model``; each leaf's local shards, stitched across ranks, give the
converted tree back.  A one-rank group in this process is bit-identical to
``mesh=None``.  The CLI serves ``--mesh 2x2 --device cpu`` (deepseek on
``1x2``) and refuses what it cannot run with rc=2.
"""

from __future__ import annotations

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_cells as cells
from repro.models import lm as jlm
from repro_torch.convert import params_from_jax
from repro_torch.dist.sharding import ShardingCtx, tree_specs
from repro_torch.launch import mesh as M
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import lm

SHAPE = (2, 2)


@pytest.fixture(scope="module")
def params():
    return {key: params_from_jax(jax.device_get(jlm.init_params(jax.random.PRNGKey(0),
                                                                _jax_model(key))),
                                 device="cpu")
            for key in ("kan", "q8")}


def _jax_model(key: str):
    from repro import configs as jconfigs
    from repro.configs.common import enable_kv_quant

    if key == "kan":
        return jconfigs.get_reduced("kanformer-100m").model
    return enable_kv_quant(jconfigs.get_reduced("qwen1.5-0.5b")).model


@pytest.fixture(scope="module")
def ranks(params):
    return M.run_ranks(cells.run_battery, SHAPE, "cpu", args=(params,))


TAGS = sorted(cells.CELLS) + ["static_sampled", cells.STATIC_MOE[0], cells.STATIC_MLA[0]]


@pytest.mark.parametrize("tag", TAGS)
def test_every_rank_serves_the_unmeshed_streams(ranks, tag):
    ref = ranks[0]["ref"][tag]
    assert len(ref) == 5
    for r in ranks:
        assert all(np.array_equal(a, b) for a, b in zip(ref, r["mesh"][tag])), (tag, r["coord"])
        if tag in cells.CELLS:
            assert r["stats"][tag] == {"data": 2, "model": 2}


def test_moe_routes_the_global_batch_on_every_rank(ranks):
    """The fp64 prefill's rows split over data: each rank's routing
    integers are the unmeshed whole batch's at its rows (``cap`` of the 36
    global rows, queue positions after the lower data rank's), tokens drop,
    and every rank reads the whole batch's drop fraction."""
    ref = cells.routes()
    S = cells.ROUTE_ROWS * cells.ROUTE_LEN
    n = S // 2
    assert len(ref["routes"]) == cells.OLMOE.n_repeats
    assert all(d > 0 for d in ref["drops"])               # capacity 1.25 binds
    for r in ranks:
        got, rows = r["routes"], slice(r["coord"][0] * n, (r["coord"][0] + 1) * n)
        assert got["drops"] == ref["drops"]
        for (te, pos, keep, cap), (rte, rpos, rkeep, rcap) in zip(got["routes"], ref["routes"]):
            assert cap == rcap < S
            assert te.shape[0] == n
            assert torch.equal(te, rte[rows]) and torch.equal(pos, rpos[rows])
            assert torch.equal(keep, rkeep[rows])
        torch.testing.assert_close(got["logits"], ref["logits"], rtol=1e-10, atol=1e-10)


def test_moe_drop_fraction_is_equal_on_every_rank(ranks):
    """The static engine's buckets split over data: every MoE call on every
    rank reads the drop fraction of the unmeshed call."""
    want = ranks[0]["moe_static_ref_drops"]
    assert len(want) == 2 * cells.OLMOE.n_repeats * 8        # two buckets, 8 passes each
    for r in ranks:
        assert r["moe_static_drops"] == want, r["coord"]


def test_mla_drop_fraction_is_equal_on_every_rank(ranks):
    """deepseek's static buckets split over data: its MoE reads the
    unmeshed drop fraction on every rank."""
    want = ranks[0]["mla_static_ref_drops"]
    assert len(want) == 2 * cells.MLA.n_repeats * 8
    for r in ranks:
        assert r["mla_static_drops"] == want, r["coord"]


def _latent_spec(key: str, lead: tuple) -> tuple:
    """The reference's spec of an MLA cache leaf on the 2x2 mesh."""
    from jax.sharding import AbstractMesh

    from repro.dist import sharding as jsharding
    from repro.models import layers as JL

    a = cells.MLA_MODELS[key].unit[0].attn
    names = lead + ("batch", "seq_cache", "kv_lora")
    shape = (cells.MLA_MODELS[key].n_repeats,) * len(lead) + (
        cells.MLA_ROWS, cells.MLA_SEQ, a.kv_lora_rank + a.qk_rope_dim)
    return tuple(jsharding.spec_for(JL.Axes(names), shape, AbstractMesh(SHAPE, ("data", "model"))))


@pytest.mark.parametrize("key", sorted(cells.MLA_MODELS))
def test_mla_latent_and_logits_match_the_unmeshed_run(ranks, key):
    """The fp64 prefill and 3 decode steps (per-row positions, one row past
    the cache): each rank's latent columns, stitched across ranks by the
    reference's spec, within 1e-12 of the unmeshed cache after the prefill
    and after the steps, and every rank's decode logits within 1e-10."""
    ref = cells.mla_decode(None, key)
    cols, heads = cells.MLA_PLACEMENT[key]
    for stage in ("prefill", "caches"):
        for part, lead in (("prologue", ()), ("unit", ("layers",))):
            spec = _latent_spec(key, lead)
            assert spec[-3:] == ("data", None, "model" if cols else None), spec
            want = ref[stage][part][0]["ckv"]
            got = _stitch(want, spec, [(r["coord"], r["mla"][key][stage][part][0]["ckv"])
                                       for r in ranks])
            torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
            for r in ranks:
                assert r["mla"][key][stage][part][0]["ckv"].shape[-1] == (
                    cols or want.shape[-1])
    for r in ranks:
        for got, want in zip(r["mla"][key]["logits"], ref["logits"]):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("key", ["mla", "mla_rope"])
def test_mla_decode_gathers_no_cache_leaf(ranks, key):
    """With the heads and the latent split, each ``mla_decode_step`` call
    makes the collectives of the split read and no other: the new latent
    row, ``kv_norm`` (gathered whole), ``Σc²``, ``u``, the partial scores,
    ``p·norm(c)`` and the output's ``reduce_from``, each smaller than the
    rank's cache leaf of that layer."""
    cfg = cells.MLA_MODELS[key]
    a = cfg.unit[0].attn
    B, S, H, rr = cells.MLA_ROWS // 2, cells.MLA_SEQ, a.n_heads, a.kv_lora_rank + a.qk_rope_dim
    want = sorted([B * rr, a.kv_lora_rank, B * S, B * H * rr, B * H * S, B * H * a.kv_lora_rank,
                   B * cfg.d_model])
    for r in ranks:
        calls = r["mla"][key]["collectives"]
        assert len(calls) == cells.MLA_STEPS * (len(cfg.prologue) + cfg.n_repeats)
        for c in calls:
            assert sorted(c["sizes"]) == want, (r["coord"], c)
            assert max(c["sizes"]) < c["cache"] == B * S * rr // 2


def test_mla_shards_have_the_reference_placement(ranks):
    """Reduced deepseek on 2x2: heads / 2 in wq, w_uk, w_uv and wo, the
    latent's columns / 2 in w_dkv, kv_norm and the cache, batch / 2 in the
    cache, experts / 2, the dense prologue's ffn / 2."""
    cfg = cells.MLA
    a, L = cfg.unit[0].attn, cfg.n_repeats
    d, H, hd, r_, rope = cfg.d_model, a.n_heads, a.head_dim, a.kv_lora_rank, a.qk_rope_dim
    want = {"wq": (L, d, H // 2, hd + rope), "w_dkv": (L, d, (r_ + rope) // 2),
            "w_uk": (L, r_, H // 2, hd), "w_uv": (L, r_, H // 2, hd), "wo": (L, H // 2, hd, d),
            "kv_norm": (L, r_ // 2), "ckv": (L, 2, 48, (r_ + rope) // 2),
            "prologue_ckv": (2, 48, (r_ + rope) // 2),
            "experts_wi": (L, cfg.unit[0].moe.n_experts // 2, d, cfg.unit[0].moe.d_ff),
            "prologue_wi": (d, cfg.prologue[0].d_ff // 2)}
    for r in ranks:
        assert r["mla_shapes"] == want, r["coord"]


def test_moe_experts_are_split_over_the_model_axis(ranks):
    L, m = cells.OLMOE.n_repeats, cells.OLMOE.unit[0].moe
    E, d, f = m.n_experts, m.d_model, m.d_ff
    for r in ranks:
        s = r["moe_shapes"]
        # expert parallelism: each rank holds E / 2 experts and the router's columns
        assert s["moe"]["wi"] == s["moe"]["wg"] == (L, E // 2, d, f)
        assert s["moe"]["wo"] == (L, E // 2, f, d) and s["moe"]["router"] == (L, d, E // 2)
        # 5 experts: each expert's ffn splits, the router's embed rows
        assert s["moe5"]["wi"] == (L, 5, d, f // 2) and s["moe5"]["wo"] == (L, 5, f // 2, d)
        assert s["moe5"]["router"] == (L, d // 2, 5)
        assert s["moe_sh"]["shared_wi"] == s["moe_sh"]["shared_wg"] == (L, d, f // 2)
        assert s["moe_sh"]["shared_wo"] == (L, f // 2, d)


def test_shards_are_distributed_not_replicated(ranks):
    kan, q8 = cells.KAN, cells.Q8
    L, H, KV, hd = kan.n_repeats, kan.unit[0].attn.n_heads, kan.unit[0].attn.n_kv_heads, \
        kan.unit[0].attn.head_dim
    for r in ranks:
        s = r["shapes"]
        assert s["wq"] == (L, kan.d_model, H // 2, hd)
        assert s["dense_k"] == (L, 4 // 2, 48, KV // 2, hd)          # batch and KV heads
        assert s["pool_k"] == (L, 16 // 2, 8, KV // 2, hd)           # blocks and KV heads
        assert s["odd_pool_k"] == (L, 17, 8, KV // 2, hd)            # 17 blocks stay whole
        assert s["q8_k_scale"] == (q8.n_repeats, 8, 8, q8.unit[0].attn.n_kv_heads // 2)
    assert sorted(r["coord"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def _stitch(full: torch.Tensor, spec: tuple, blocks: list) -> torch.Tensor:
    """Each rank's block written where its coordinates place it."""
    out = torch.full_like(full, float("nan"))
    for coord, local in blocks:
        view = out
        for i, axis in enumerate(spec):
            if axis is not None:
                n = local.shape[i]
                view = view.narrow(i, coord[("data", "model").index(axis)] * n, n)
        view.copy_(local)
    return out


@pytest.mark.parametrize("key", ["kan", "q8"])
def test_local_shards_stitch_back_to_the_converted_tree(ranks, params, key):
    model = {"kan": cells.KAN, "q8": cells.Q8}[key]
    specs = tree_specs(lm.param_axes(model), lm.tree_of_shapes(lm.param_shapes(model)),
                       {"data": 2, "model": 2})
    n_split = 0

    def check(full, spec, *locals_):
        nonlocal n_split
        n_split += any(a is not None for a in spec)
        stitched = _stitch(full, spec, [(r["coord"], loc) for r, loc in zip(ranks, locals_)])
        assert torch.equal(stitched, full), spec

    def walk(full, spec, *locals_):
        if isinstance(full, dict):
            for k in full:
                walk(full[k], spec[k], *(loc[k] for loc in locals_))
        elif isinstance(full, list):
            for i in range(len(full)):
                walk(full[i], spec[i], *(loc[i] for loc in locals_))
        else:
            check(full, spec, *locals_)

    walk(params[key], specs, *(r["local"][key] for r in ranks))
    assert n_split > 5


def test_block_copies_cross_the_data_split_pool(ranks):
    """``lm.copy_paged_blocks`` on a pool the data axis splits: each copy's
    source owner contributes it, its destination owner writes it."""
    want = cells.copied_pool()
    got = _stitch(want, (None, "data", None, "model", None),
                  [(r["coord"], r["copied_pool"]) for r in ranks])
    assert torch.equal(got, want)
    assert torch.equal(want[:, 10], want[:, 1]) and torch.equal(want[:, 2], want[:, 9])


def test_one_rank_mesh_is_bit_identical_to_no_mesh(params, tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = M.make_host_mesh((1, 1))
        ctx = ShardingCtx(mesh)
        assert ctx.n_devices == 1 and ctx.shape == {"data": 1, "model": 1}
        names, shape = ("batch", "seq_cache", "kv_heads", "head_dim"), (4, 32, 4, 16)
        assert ctx.spec(names, shape) == ("data", None, "model", None)   # named, size 1
        assert ctx.local_shape(names, shape) == shape
        assert ctx.model_split(names, shape) is None
        assert ctx.for_rows(4).row_range() is None and ctx.for_pool(16).block_range() is None
        assert ctx.cache_shardings(cells.Q8, 4, 48)["unit"][0]["k_scale"] == \
            (None, "data", None, "model")
        assert ctx.paged_cache_shardings(cells.Q8, 16, 8)["unit"][0]["k"] == \
            (None, "data", None, "model", None)
        assert ctx.param_shardings(cells.KAN)["embed"]["table"] == ("model", None)
        params = dict(params, mla=lm.init_params(cells.MLA, seed=0, device="cpu"))
        for tag in ("dense_greedy", "paged_noprefix_sampled", "mla_dense_greedy"):
            key, kw = cells.CELLS[tag]
            ref, _ = cells.serve(params, key, None, kw)
            got, eng = cells.serve(params, key, mesh, kw)
            assert all(np.array_equal(a, b) for a, b in zip(ref, got)), tag
            assert eng.last_serve_stats["mesh_shape"] == {"data": 1, "model": 1}
        toks = torch.as_tensor(np.stack([r[:9] for r in cells.requests()]))
        want, _ = lm.prefill(params["kan"], cells.KAN, toks, 16)
        got, _ = lm.prefill(params["kan"], cells.KAN, toks, 16, shard=ctx)
        assert torch.equal(want, got)
        # MLA: the latent, the decode logits and the written cache bit-equal
        want, got = cells.mla_decode(None, "mla"), cells.mla_decode(mesh, "mla")
        assert all(torch.equal(a, b) for a, b in zip(want["logits"], got["logits"]))
        assert torch.equal(want["caches"]["unit"][0]["ckv"], got["caches"]["unit"][0]["ckv"])
        assert all(c["sizes"] == [] for c in got["collectives"])      # none on 1x1
    finally:
        dist.destroy_process_group()


def test_mesh_refuses_what_it_does_not_serve():
    from repro_torch import configs

    with pytest.raises(ValueError, match="item 9.4"):
        _mesh_engine(configs.get_reduced("zamba2-1.2b").model)
    # MoE experts (item 9.4.2 step 2) and MLA (step 3) take the mesh
    for arch in ("olmoe-1b-7b", "deepseek-v2-lite"):
        assert lm.mesh_refusal(configs.get_reduced(arch).model) is None
        assert lm.mesh_refusal(configs.get_config(arch).model) is None
    for arch, why in (("zamba2-1.2b", "recurrent"), ("xlstm-1.3b", "recurrent"),
                      ("gemma3-12b", "windowed"), ("paligemma-3b", "inputs"),
                      ("musicgen-large", "inputs")):
        msg = lm.mesh_refusal(configs.get_reduced(arch).model)
        assert why in msg and "item 9.4.2" in msg, arch
    assert lm.mesh_refusal(cells.Q8) is None and lm.mesh_refusal(cells.KAN) is None


def _mesh_engine(model):
    from repro_torch.serve.engine import Engine, ServeConfig

    return Engine({}, model, ServeConfig(mesh=object()), device="cpu")


def test_cli_mesh_2x2_on_the_cpu():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                        "kanformer-100m", "--device", "cpu", "--mesh", "2x2", "--engine",
                        "continuous", "--paged", "--requests", "4", "--max-new", "6"],
                       capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[serve] mesh={'data': 2, 'model': 2} over 4 ranks (gloo on cpu)" in r.stdout
    assert r.stdout.count("[serve:continuous] 4 requests") == 1          # rank 0 alone


def test_cli_mesh_serves_deepseek_on_1x2():
    """MLA on a mesh through the CLI: reduced deepseek-v2-lite's heads and
    latent columns over a model axis of 2."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                        "deepseek-v2-lite", "--device", "cpu", "--mesh", "1x2", "--requests", "4",
                        "--max-new", "6"],
                       capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "[serve] mesh={'data': 1, 'model': 2} over 2 ranks (gloo on cpu)" in r.stdout
    assert r.stdout.count("[serve:static] 4 requests") == 1


@pytest.mark.parametrize("argv,msg", [
    (["--mesh", "2x"], "--mesh expects integers DxM"),
    (["--mesh", "0x2"], "mesh shape must be positive"),
    (["--mesh", "2x2", "--device", "cuda"], "mesh 2x2 on cuda"),
    (["--mesh", "1x2", "--device", "cpu", "--spec-k", "2", "--engine", "continuous"],
     "--spec-k on a mesh"),
    (["--mesh", "2x2", "--device", "cpu", "--share-card"], "--share-card"),
])
def test_cli_refuses_a_mesh_it_cannot_build(argv, msg, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc = serve_main(["--arch", "kanformer-100m", *argv])
    assert rc == 2 and msg in capsys.readouterr().err


def test_a_cuda_mesh_larger_than_the_cards_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    why = M.devices_missing((2, 2), "cuda")
    assert "needs 4 CUDA devices, one per rank, and 1 is present" in why
    assert M.devices_missing((2, 2), "cuda", share_card=True) is None
    with pytest.raises(ValueError, match="needs 4 CUDA devices"):
        M.run_ranks(cells.run_battery, (2, 2), "cuda")
