"""The training battery every rank of a spawned mesh runs for
``tests/test_torch_mesh_train.py`` (a module the spawned ranks import, so
it imports no JAX): the port's train step on a 2x2 ``(data, model)`` mesh,
each case's unmeshed counterpart computed by one of the ranks after the
mesh cases (so the four ranks share that work), and what the ZeRO,
checkpoint and launcher proofs read."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import signal

import torch
import torch.distributed as dist

import torch_mesh_cells as serving
from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.convert import flatten_with_paths, tree_map
from repro_torch.data import pipeline as dp
from repro_torch.dist.sharding import ShardingCtx
from repro_torch.launch import elastic
from repro_torch.launch import train as launcher
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import step as TS

KAN = configs.get_reduced("kanformer-100m").model
QWEN = configs.get_reduced("qwen1.5-0.5b").model
# the serving battery's MQA model (its heads split over a model axis of 2,
# its one KV head not) with a vocabulary the model axis does not divide:
# the tied table then splits on embed and is gathered whole
MQA = dataclasses.replace(serving.MQA, vocab=509)
# the serving battery's four MoE models: experts on model (capacity 1.25,
# tokens drop), experts' ffn on model, GQA with a shared expert, einsum
# and reduced deepseek-v2-lite (MLA, heads and latent columns on model,
# beside its MoE and dense prologue); the serving battery's other three MLA
# placements take the fp64 gradient case only (GRAD_CASES)
MODELS = {"kan": KAN, "qwen": QWEN, "mqa": MQA, **serving.MOE_MODELS, "mla": serving.MLA}
MLA_VARIANTS = {k: m for k, m in serving.MLA_MODELS.items() if k != "mla"}
ALL_MODELS = {**MODELS, **MLA_VARIANTS}
DTYPES = {"fp64": torch.float64, "fp32": torch.float32}
GRAD_CASES = [(k, d) for k in MODELS for d in DTYPES] + [(k, "fp64") for k in MLA_VARIANTS]
# master weights, accumulation and the bf16 wire format share a run: each
# changes another part of the step, and fewer runs keep the group's time low
VARIANTS = {"plain": {}, "int8": {"grad_compression": "int8"},
            "master_accum2_bf16": {"master_weights": True, "accum_steps": 2,
                                   "grad_compression": "bf16"}}
MASTER = "master_accum2_bf16"
# every variant at fp64, where the mesh must give the unmeshed bits; at fp32
# (the same code, a looser bound) plain for every model, the variants for
# kanformer
TRAIN_CASES = ([(k, "fp64", v) for k in MODELS for v in VARIANTS]
               + [(k, "fp32", "plain") for k in MODELS]
               + [("kan", "fp32", v) for v in VARIANTS if v != "plain"])
B, T, STEPS, LR = 8, 8, 3, 2e-3
# the checkpoint cases: a fp64 run saved at step CKPT_AT and continued to STEPS + 2
CKPT_AT = STEPS
CKPT_KEY = ("kan", "fp64")
MOE_CKPT_KEY = ("moe", "fp64")
CKPT_KEYS = (CKPT_KEY, MOE_CKPT_KEY)
LAUNCH = ["--arch", "kanformer-100m", "--reduced", "--device", "cpu", "--steps", "6",
          "--batch", "4", "--seq", "8", "--ckpt-every", "2", "--log-every", "1", "--lr", "2e-3"]
FAIL_CALL, STOP_CALL, STOP_RANK = 2, 4, 1     # the launcher's planted failure and stop


def params_of(key: str, dtype) -> dict:
    return lm.init_params(ALL_MODELS[key], seed=0, device="cpu", dtype=dtype)


def batch_of(key: str, step: int) -> dict:
    """``lm_batch``'s rows, row ``b``'s last ``b % 4`` labels masked as well,
    so the rows carry different label counts."""
    batch = dp.lm_batch(dp.LMDataConfig(vocab=ALL_MODELS[key].vocab, seq_len=T, global_batch=B,
                                        seed=0), step)
    labels = batch["labels"].clone()
    for b in range(B):
        if b % 4:
            labels[b, T - 1 - b % 4:] = -100
    return {"tokens": batch["tokens"], "labels": labels}


def grads_case(key: str, dtype: str, shard=None) -> dict:
    """One loss and gradient: on a mesh this rank's model-local gradient,
    summed over ``data``, and the whole batch's loss."""
    cfg = ALL_MODELS[key]
    params = params_of(key, DTYPES[dtype])
    batch = batch_of(key, 0)
    if shard is not None:
        params = shard.place_params(cfg, params)
        batch = TS.data_rows(shard, batch, 0, B)
    loss, metrics, grads = TS.loss_and_grads(params, cfg, batch, DTYPES[dtype], shard)
    if shard is not None:
        shard.sum_over(list(flatten_with_paths(grads).values()), "data")
    return {"loss": float(loss), "ntokens": float(metrics["ntokens"]), "grads": grads}


def train_case(key: str, dtype: str, variant: str, shard=None, steps: int = STEPS,
               ckpt: str | None = None) -> dict:
    """``steps`` AdamW steps of ``make_train_step`` from seed 0 -> the
    losses, the parameters and the state (this rank's shards on a mesh);
    with ``ckpt`` the state is saved at :data:`CKPT_AT`."""
    cfg, kw = MODELS[key], dict(VARIANTS[variant])
    master = kw.pop("master_weights", False)
    opt = adamw.AdamWConfig(lr=LR, warmup_steps=1, total_steps=steps, master_weights=master)
    params = params_of(key, DTYPES[dtype])
    if shard is not None:
        params = shard.place_params(cfg, params)
    state = adamw.init_state(params, master, shard=None if shard is None else shard.for_model(cfg))
    step = TS.make_train_step(cfg, opt, compute_dtype=DTYPES[dtype], shard=shard, **kw)
    out = {"losses": []}
    for i in range(steps):
        params, state, m = step(params, state, batch_of(key, i))
        out["losses"].append(float(m["loss"]))
        if ckpt and i + 1 == CKPT_AT:
            store.save(ckpt, CKPT_AT, (params, state), shard=shard,
                       specs=shard.state_specs(cfg, state))
            out["at_ckpt"] = tree_map(torch.clone, (params, state))
    return {**out, "params": params, "state": state}


def ckpt_path(ckpt_dir: str, key: tuple) -> str:
    """Where the checkpoint case ``key`` saves (kanformer's in ``ckpt_dir``
    itself)."""
    return ckpt_dir if key == CKPT_KEY else os.path.join(ckpt_dir, key[0])


def continue_case(ckpt: str, shard=None, device="cpu", case: tuple = CKPT_KEY) -> dict:
    """The checkpoint case's run restored at :data:`CKPT_AT` through
    ``restore_elastic`` and taken to ``STEPS + 2``."""
    key, dtype = case
    cfg = MODELS[key]
    params, state, mf = elastic.restore_elastic(ckpt, CKPT_AT, cfg, shard, DTYPES[dtype],
                                                device=device)
    restored = tree_map(torch.clone, params)
    opt = adamw.AdamWConfig(lr=LR, warmup_steps=1, total_steps=STEPS + 2)
    step = TS.make_train_step(cfg, opt, compute_dtype=DTYPES[dtype], shard=shard)
    losses = []
    for i in range(mf["step"], STEPS + 2):
        params, state, m = step(params, state, batch_of(key, i))
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": params, "state": state, "restored": restored,
            "step": mf["step"]}


def zero_update(shard) -> dict:
    """The same gradients, made on every rank from one seed, applied with
    a clip that does not bind, ZeRO-sharded and unsharded -> this rank's
    updated model-local parameters and ZeRO state both ways (the unsharded
    ones sliced), with and without master weights."""
    ctx = shard.for_model(KAN)
    out = {}
    for master in (False, True):
        opt = adamw.AdamWConfig(lr=LR, warmup_steps=1, grad_clip=1e9, master_weights=master)
        whole = params_of("kan", torch.float32)
        grads = lm.init_params(KAN, seed=3, device="cpu")
        want, ref_state, _ = adamw.apply_updates(whole, grads, adamw.init_state(whole, master),
                                                 opt)
        local = shard.place_params(KAN, params_of("kan", torch.float32))
        state = adamw.init_state(local, master, shard=ctx)
        got, state, _ = adamw.apply_updates(local, shard.place_params(KAN, grads), state, opt,
                                            shard=ctx)
        out[master] = {"got": (got, state),
                       "want": (shard.place_params(KAN, want),
                                shard.place_opt_state(KAN, ref_state))}
    return out


def launcher_case(ckpt_dir: str) -> dict:
    """``launch.train.run`` in the group (its ``(1, world)`` mesh) with a
    one-off failure planted at the same call on every rank and SIGTERM
    sent to one rank a step later -> this rank's output, steps and losses."""
    orig = launcher.train_step_lib.make_train_step

    def planted(*args, **kw):
        inner, calls = orig(*args, **kw), {"n": 0}

        def step(params, state, batch):
            calls["n"] += 1
            if calls["n"] == FAIL_CALL:
                raise RuntimeError("planted one-off failure")
            if calls["n"] == STOP_CALL and dist.get_rank() == STOP_RANK:
                os.kill(os.getpid(), signal.SIGTERM)
            return inner(params, state, batch)

        return step

    launcher.train_step_lib.make_train_step = planted
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            out = launcher.run(LAUNCH + ["--ckpt-dir", ckpt_dir])
    finally:
        launcher.train_step_lib.make_train_step = orig
    return {"stdout": text.getvalue(), "steps": out["steps"], "losses": out["losses"],
            "mesh": dict(ShardingCtx(_world_mesh()).shape)}


def _world_mesh():
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh((1, dist.get_world_size()))


def one_by_two(ckpt: str) -> dict:
    """The checkpoint case continued on a 1x2 mesh: ranks {0, 1} and {2, 3}
    each form one (``(pair, data, model)`` = ``(2, 1, 2)``)."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=("pair", "data", "model"))
    sub = mesh["data", "model"]
    out = continue_case(ckpt, ShardingCtx(sub))
    out["coord"] = tuple(int(c) for c in sub.get_coordinate())
    return out


def run_battery(mesh, device, ckpt_dir: str, jax_ckpt: str) -> dict:
    """One rank's share: every mesh case, then its quarter of the unmeshed
    references."""
    torch.set_num_threads(1)
    rank = dist.get_rank()
    shard = ShardingCtx(mesh)
    out = {"coord": tuple(int(c) for c in mesh.get_coordinate()), "grads": {}, "train": {},
           "ref_grads": {}, "ref_train": {}}
    cases = GRAD_CASES
    for key, dtype in cases:
        out["grads"][key, dtype] = grads_case(key, dtype, shard)
    for key, dtype, variant in TRAIN_CASES:
        ck = ckpt_path(ckpt_dir, (key, dtype)) if (key, dtype) in CKPT_KEYS and \
            variant == "plain" else None
        out["train"][key, dtype, variant] = train_case(
            key, dtype, variant, shard, steps=STEPS + 2 if ck else STEPS, ckpt=ck)
    out["zero"] = zero_update(shard)
    out["zero_bytes"] = {k: sum(t.numel() * t.element_size() for s in ("m", "v", "master")
                                for t in flatten_with_paths(
                                    out["train"][k, "fp64", MASTER]["state"][s]).values())
                         for k in MODELS}
    out["jax_restore"] = elastic.restore_elastic(jax_ckpt, 3, QWEN, shard, torch.float32,
                                                 device="cpu")[0]
    out["one_by_two"] = one_by_two(ckpt_dir)
    out["launcher"] = launcher_case(os.path.join(ckpt_dir, "launcher"))
    jobs = [("grads", c) for c in cases] + [("train", c) for c in TRAIN_CASES]
    for i, (kind, case) in enumerate(jobs):
        if i % dist.get_world_size() != rank:
            continue
        if kind == "grads":
            out["ref_grads"][case] = grads_case(*case)
        else:
            ck = case[:2] in CKPT_KEYS and case[2] == "plain"
            out["ref_train"][case] = train_case(*case, steps=STEPS + 2 if ck else STEPS)
    return out
