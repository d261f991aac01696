"""The mesh battery every rank of a spawned mesh runs for
``tests/test_torch_mesh.py`` (a module the spawned ranks import, so it
imports no JAX): the reference battery's cells
(``tests/test_mesh_serving.py``) on the port, each served with the mesh and,
on rank 0, without it, plus what the distribution proofs read."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs import kanformer_100m
from repro_torch.configs.common import enable_kv_quant
from repro_torch.dist.sharding import ShardingCtx
from repro_torch.models import lm
from repro_torch.models import moe as MOE_LIB
from repro_torch.serve.engine import Engine, ServeConfig

KAN = configs.get_reduced("kanformer-100m").model
Q8 = enable_kv_quant(configs.get_reduced("qwen1.5-0.5b")).model
# heads split over a model axis of 2, the one KV head not: each rank pairs
# its query heads with the whole KV head
MQA = kanformer_100m.build(n_layers=2, d_model=64, n_heads=4, n_kv=1, kan_ff=96,
                           vocab=512).model
# reduced olmoe-1b-7b: 8 experts on a model axis of 2 (expert parallelism),
# capacity factor 1.25 (tokens drop); and three test-built variants: 5
# experts, which the model axis does not divide (each expert's ffn takes it);
# GQA (2 KV heads) with one shared expert; the einsum dispatch
OLMOE = configs.get_reduced("olmoe-1b-7b").model


def moe_variant(name: str, n_kv: int | None = None, **moe) -> lm.ModelConfig:
    blk = OLMOE.unit[0]
    attn = blk.attn if n_kv is None else dataclasses.replace(blk.attn, n_kv_heads=n_kv)
    blk = dataclasses.replace(blk, attn=attn, moe=dataclasses.replace(blk.moe, **moe))
    return dataclasses.replace(OLMOE, name=name, unit=(blk,))


MOE_MODELS = {"moe": OLMOE, "moe5": moe_variant("olmoe-e5", n_experts=5),
              "moe_sh": moe_variant("olmoe-gqa-shared", n_kv=2, n_shared=1),
              "moe_es": moe_variant("olmoe-einsum", dispatch="einsum")}
# reduced deepseek-v2-lite (MLA, kv_lora 16 + rope 8, 4 heads) and three
# test-built variants, one per placement of the reference's specs on a model
# axis of 2: "mla" heads and latent columns split, rank 1 holding latent
# 12..15 and the whole rope block; "mla_rope" (kv_lora 6, rope 10) the
# columns split inside the rope block, so its rotary pairs lie on two
# ranks; "mla_h3" 3 heads, whole on every rank (wq, w_uk, w_uv, wo gathered)
# beside split columns; "mla_c23" (kv_lora 15, rope 8) heads split and a
# latent of 23 columns whole on every rank
MLA = configs.get_reduced("deepseek-v2-lite").model


def mla_variant(name: str, **attn) -> lm.ModelConfig:
    def swap(blk):
        return dataclasses.replace(blk, attn=dataclasses.replace(blk.attn, **attn))

    return dataclasses.replace(MLA, name=name, prologue=tuple(map(swap, MLA.prologue)),
                               unit=tuple(map(swap, MLA.unit)))


MLA_MODELS = {"mla": MLA, "mla_rope": mla_variant("deepseek-rope-split", kv_lora_rank=6,
                                                  qk_rope_dim=10),
              "mla_h3": mla_variant("deepseek-h3", n_heads=3, n_kv_heads=3),
              "mla_c23": mla_variant("deepseek-c23", kv_lora_rank=15)}
# the latent columns (first, count) each model rank holds, by the reference's
# spec_for, and whether the heads are split
MLA_PLACEMENT = {"mla": (12, True), "mla_rope": (8, True), "mla_h3": (12, False),
                 "mla_c23": (None, True)}
MODELS = {"kan": KAN, "q8": Q8, "mqa": MQA, **MOE_MODELS, **MLA_MODELS}
PAGED = {"paged": True, "block_size": 8}
CELLS = {
    "dense_greedy": ("kan", {}),
    "dense_sampled": ("kan", {"temperature": 0.7}),
    "paged_prefix_greedy": ("kan", {**PAGED, "prefix_caching": True}),
    "paged_noprefix_sampled": ("kan", {**PAGED, "prefix_caching": False, "temperature": 0.7}),
    "paged_step_read": ("kan", {**PAGED, "paged_read": "step"}),
    "paged_data_sharded_pool": ("kan", {**PAGED, "pool_blocks": 14}),
    "dense_int8": ("q8", {}),
    "paged_int8": ("q8", PAGED),
    "mqa_dense": ("mqa", {}),
    "mqa_paged_step": ("mqa", {**PAGED, "paged_read": "step"}),
    "moe_dense_greedy": ("moe", {}),
    "moe_paged_step_sampled": ("moe", {**PAGED, "paged_read": "step", "temperature": 0.7}),
    "moe_paged_data_sharded_pool": ("moe", {**PAGED, "pool_blocks": 14}),
    "moe5_dense": ("moe5", {}),
    "moe5_paged_shadow": ("moe5", PAGED),
    "moe_shared_dense": ("moe_sh", {}),
    "moe_shared_paged_step": ("moe_sh", {**PAGED, "paged_read": "step"}),
    "moe_einsum_dense": ("moe_es", {}),
    "mla_dense_greedy": ("mla", {}),
    "mla_dense_sampled": ("mla", {"temperature": 0.7}),
    "mla_rope_dense": ("mla_rope", {}),
    "mla_h3_dense": ("mla_h3", {}),
    "mla_c23_dense": ("mla_c23", {}),
}
# the static engine's buckets: batch 4 splits over the data axis, so the MoE
# routes each rank's rows as one global batch
STATIC_MOE = ("moe_static_greedy", "moe", 4)
STATIC_MLA = ("mla_static_greedy", "mla", 4)
# the MLA proofs: a fp64 prefill of MLA_ROWS prompts of MLA_LEN tokens (rows
# split over data), then MLA_STEPS decode steps at per-row positions
MLA_ROWS, MLA_LEN, MLA_STEPS, MLA_SEQ = 4, 7, 3, 16
# the routing proof: a fp64 prefill of ROUTE_ROWS prompts of ROUTE_LEN tokens
# (rows split over data; 36 routed rows, cap 11 of 9 per expert on average)
ROUTE_ROWS, ROUTE_LEN = 4, 9


def requests() -> list[np.ndarray]:
    rs = np.random.RandomState(0)
    shared = rs.randint(0, 512, 8).astype(np.int32)   # prefix-cache fodder
    return [np.concatenate([shared, rs.randint(0, 512, rs.randint(3, 10)).astype(np.int32)])
            for _ in range(5)]


def serve(params, key, mesh, kw, device="cpu", static=False):
    eng = Engine(params[key], MODELS[key],
                 ServeConfig(max_seq=48, max_new_tokens=8, mesh=mesh, **kw), device=device)
    reqs = requests()
    if static:
        return eng.serve_requests(reqs, batch_size=4), eng
    return eng.serve_continuous(reqs, slots=2, chunk_steps=4), eng


def run_battery(mesh, device, params: dict) -> dict:
    """One rank's share: every cell with the mesh (and, on rank 0, without
    it), the static sampled run, this rank's parameter shards and the
    shapes of its cache shards."""
    torch.set_num_threads(1)
    params = dict(params, mqa=lm.init_params(MQA, seed=0, device="cpu"),
                  **{k: lm.init_params(m, seed=0, device="cpu")
                     for k, m in {**MOE_MODELS, **MLA_MODELS}.items()})
    first = dist.get_rank() == 0
    out = {"mesh": {}, "ref": {}, "stats": {}}
    for tag, (key, kw) in CELLS.items():
        out["mesh"][tag], eng = serve(params, key, mesh, kw, device)
        out["stats"][tag] = eng.last_serve_stats["mesh_shape"]
        if first:
            out["ref"][tag], _ = serve(params, key, None, kw, device)
    static = {"temperature": 0.5}
    out["mesh"]["static_sampled"], engm = serve(params, "kan", mesh, static, device, True)
    if first:
        out["ref"]["static_sampled"], _ = serve(params, "kan", None, static, device, True)
    tag, key, batch = STATIC_MOE
    out["mesh"][tag], eng = serve_static(params, key, mesh, batch, device)
    out["moe_static_drops"] = eng.drops
    if first:
        out["ref"][tag], eng = serve_static(params, key, None, batch, device)
        out["moe_static_ref_drops"] = eng.drops
    tag, key, batch = STATIC_MLA
    out["mesh"][tag], eng = serve_static(params, key, mesh, batch, device)
    out["mla_static_drops"] = eng.drops
    if first:
        out["ref"][tag], eng = serve_static(params, key, None, batch, device)
        out["mla_static_ref_drops"] = eng.drops
    out["mla"] = {key: mla_decode(mesh, key) for key in MLA_MODELS}
    out["mla_shapes"] = mla_shapes(mesh, params["mla"])
    out["routes"] = routes(mesh)
    out["moe_shapes"] = {}
    for key, model in MOE_MODELS.items():
        local = ShardingCtx(mesh).place_params(model, params[key])["unit"][0]["moe"]
        out["moe_shapes"][key] = {n: tuple(w.shape) for n, w in local.items()}
    engq = Engine(params["q8"], Q8, ServeConfig(max_seq=48, max_new_tokens=8, mesh=mesh),
                  device=device)
    out["local"] = {"kan": engm.params, "q8": engq.params}
    out["shapes"] = {
        "wq": tuple(engm.params["unit"][0]["attn"]["wq"].shape),
        "dense_k": tuple(engm._make_dense_caches(4)["unit"][0]["k"].shape),
        "pool_k": tuple(engm._make_paged_caches(16, 8)["unit"][0]["k"].shape),
        "odd_pool_k": tuple(engm._make_paged_caches(17, 8)["unit"][0]["k"].shape),
        "q8_k_scale": tuple(engq._make_paged_caches(16, 8)["unit"][0]["k_scale"].shape),
    }
    out["coord"] = tuple(mesh.get_coordinate())
    out["copied_pool"] = copied_pool(ShardingCtx(mesh).for_pool(16))
    return out


COPIES = ([1, 9, 4], [10, 2, 15])     # across the two halves of a 16-block pool


def copied_pool(shard=None) -> torch.Tensor:
    """A 16-block pool of known values (this rank's shard on a mesh) after
    ``lm.copy_paged_blocks(*COPIES)``: its stacked ``k`` leaf."""
    pools = lm.init_paged_caches(KAN, 16, 8, torch.float32, "cpu", shard)
    k = pools["unit"][0]["k"]                        # (layers, blocks, 8, kv, hd)
    a = KAN.unit[0].attn
    full = torch.arange(KAN.n_repeats * 16 * 8 * a.n_kv_heads * a.head_dim,
                        dtype=torch.float32).reshape(KAN.n_repeats, 16, 8, a.n_kv_heads, -1)
    first, n = (0, 16) if shard is None or shard.block_range() is None else shard.block_range()
    kv0 = 0 if shard is None else shard.coord("model") * k.shape[3]
    k.copy_(full[:, first:first + n, :, kv0:kv0 + k.shape[3]])
    lm.copy_paged_blocks(pools, *COPIES, shard=shard)
    return k


@contextlib.contextmanager
def recorded_routes():
    """Every ``moe.route`` call's integers ``(top_e, pos, keep, cap)`` and
    every ``moe_forward`` call's ``moe_drop_frac`` while active."""
    real_route, real_forward = MOE_LIB.route, MOE_LIB.moe_forward
    got = {"routes": [], "drops": []}

    def route(*args, **kw):
        r = real_route(*args, **kw)
        got["routes"].append(tuple(t.clone() if torch.is_tensor(t) else t for t in r[3:]))
        return r

    def forward(*args, **kw):
        y, aux = real_forward(*args, **kw)
        got["drops"].append(float(aux["moe_drop_frac"]))
        return y, aux

    MOE_LIB.route, MOE_LIB.moe_forward = route, forward
    try:
        yield got
    finally:
        MOE_LIB.route, MOE_LIB.moe_forward = real_route, real_forward


def route_prompts() -> torch.Tensor:
    rs = np.random.RandomState(1)
    return torch.as_tensor(rs.randint(0, OLMOE.vocab, (ROUTE_ROWS, ROUTE_LEN)))


def routes(mesh=None) -> dict:
    """The routing proof's fp64 prefill of reduced olmoe (on a mesh this
    rank's rows, split over data) -> each layer's routing integers and drop
    fraction, and the logits."""
    params = lm.init_params(OLMOE, seed=0, device="cpu", dtype=torch.float64)
    shard = None
    if mesh is not None:
        shard = ShardingCtx(mesh)
        params = shard.place_params(OLMOE, params)
    with recorded_routes() as got:
        logits, _ = lm.prefill(params, OLMOE, route_prompts(), 16, torch.float64, shard)
    return {**got, "logits": logits}


def serve_static(params, key, mesh, batch, device="cpu"):
    """``serve_requests`` greedy in buckets of ``batch`` -> ``(streams,
    engine)``, the engine's ``drops`` every MoE call's drop fraction."""
    eng = Engine(params[key], MODELS[key], ServeConfig(max_seq=48, max_new_tokens=8, mesh=mesh),
                 device=device)
    with recorded_routes() as got:
        outs = eng.serve_requests(requests(), batch_size=batch)
    eng.drops = got["drops"]
    return outs, eng


def mla_prompts(vocab: int) -> torch.Tensor:
    rs = np.random.RandomState(2)
    return torch.as_tensor(rs.randint(0, vocab, (MLA_ROWS, MLA_LEN)))


@contextlib.contextmanager
def recorded_collectives():
    """The element count of every collective (``all_reduce``/``broadcast``)
    made inside ``attention.mla_decode_step``, one list per call, beside
    that call's cache leaf (its element count) while active."""
    from repro_torch.models import attention as A

    real_step, real_ar, real_bc = A.mla_decode_step, dist.all_reduce, dist.broadcast
    got, inside = [], []

    def collective(real):
        def wrapped(t, *args, **kw):
            if inside:
                got[-1]["sizes"].append(t.numel())
            return real(t, *args, **kw)
        return wrapped

    def step(params, cfg, x, cache_ckv, pos, shard=None):
        got.append({"cache": cache_ckv.numel(), "sizes": []})
        inside.append(True)
        try:
            return real_step(params, cfg, x, cache_ckv, pos, shard)
        finally:
            inside.pop()

    A.mla_decode_step = step
    dist.all_reduce, dist.broadcast = collective(real_ar), collective(real_bc)
    try:
        yield got
    finally:
        A.mla_decode_step, dist.all_reduce, dist.broadcast = real_step, real_ar, real_bc


def mla_decode(mesh, key: str) -> dict:
    """The MLA proof's fp64 prefill of :func:`mla_prompts` and
    ``MLA_STEPS`` decode steps at per-row positions (on a mesh this rank's
    rows and latent columns) -> the caches after the prefill and after the
    steps, the decode logits, and the collectives of each
    ``mla_decode_step`` call."""
    cfg = MLA_MODELS[key]
    params = lm.init_params(cfg, seed=0, device="cpu", dtype=torch.float64)
    shard = None
    if mesh is not None:
        shard = ShardingCtx(mesh)
        params = shard.place_params(cfg, params)
    toks = mla_prompts(cfg.vocab)
    _, caches = lm.prefill(params, cfg, toks, MLA_SEQ, torch.float64, shard)
    out = {"logits": [], "prefill": {part: [{n: t.clone() for n, t in c.items()} for c in cs]
                                     for part, cs in caches.items()}}
    pos = torch.tensor([MLA_LEN - 1, MLA_LEN, MLA_LEN + 1, MLA_SEQ + 2])   # the last row past S
    dshard = None if shard is None else shard.for_rows(MLA_ROWS)
    rs = np.random.RandomState(3)
    with recorded_collectives() as got:
        for _ in range(MLA_STEPS):
            tok = torch.as_tensor(rs.randint(0, cfg.vocab, (MLA_ROWS, 1)))
            logits, caches = lm.decode_step(params, cfg, tok, caches, pos, torch.float64, None,
                                            dshard)
            out["logits"].append(logits)
            pos = pos + 1
    out["caches"] = caches
    out["collectives"] = got
    return out


def mla_shapes(mesh, params) -> dict:
    """This rank's MLA shards of reduced deepseek: the unit's attention
    leaves and the dense cache's latent of a batch of 4."""
    local = ShardingCtx(mesh).place_params(MLA, params)
    attn = {n: tuple(w.shape) for n, w in local["unit"][0]["attn"].items()}
    caches = lm.init_caches(MLA, 4, 48, torch.float32, "cpu", ShardingCtx(mesh))
    return {**attn, "ckv": tuple(caches["unit"][0]["ckv"].shape),
            "prologue_ckv": tuple(caches["prologue"][0]["ckv"].shape),
            "experts_wi": tuple(local["unit"][0]["moe"]["wi"].shape),
            "prologue_wi": tuple(local["prologue"][0]["mlp"]["wi"].shape)}
