"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The counterpart of ``repro/launch/train.py`` (``--device``, ``cuda`` unless
``cpu`` is given).  Alone it trains on one device.  In a process group
(under ``torchrun``, which it joins, or inside ``launch.mesh.run_ranks``)
it trains on the reference's default mesh, ``(1, world size)``: the
parameters placed by the logical-axis rules, AdamW's ``m``/``v`` ZeRO
slices, the step's collectives on the mesh (``train/step.py``).  Rank 0
alone prints and writes the checkpoints (gathered whole); the stop flag
and the retry decision are agreed by every rank (``ShardingCtx.count``),
so every rank stops or retries at the same step; MoE models train with
their experts on the model axis (``models/moe.py``), MLA models
(deepseek-v2-lite) with their heads on it and the latent projection
gathered whole (``models/attention.py``); a family the mesh does not take
(recurrent, windowed, non-token) exits with rc=2 and ``lm.mesh_refusal``'s
reason.  A retry
recovers a failure that every rank meets before the step's first
collective; a rank that fails alone inside one leaves the others waiting
in it until ``launch.mesh.RANK_TIMEOUT``.

* parameters from the seed (``lm.init_params``), AdamW with a warmup of
  ``min(20, steps // 10 + 1)`` and a cosine decay over ``--steps``;
* checkpoints every ``--ckpt-every`` steps, written in the background and
  atomically (``checkpoint/store.py``), resume from the latest complete
  one, and a checkpoint-and-exit on SIGTERM or SIGINT;
* ``--max-retries`` bounded retries of a step that raises;
* a deterministic stream: the batch is a function of ``(seed, step)``
  (``data/pipeline.lm_batch``), so a restart neither skips nor replays.
  A model with non-token inputs gets ``numpy.random.RandomState(step)``
  normals for its frame embeddings (musicgen-large) or its patch prefix
  (paligemma-3b), as the reference's launcher draws them.

It prints the reference's lines: ``step N loss ... gnorm ... lr ... tok/s``
every ``--log-every`` steps and ``[done] steps=N loss a -> b``, the means of
the first and last 10 losses of this run.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, set_ieee_fp32
from repro_torch.checkpoint import store
from repro_torch.data import pipeline as dp
from repro_torch.dist.sharding import ShardingCtx
from repro_torch.launch import elastic
from repro_torch.launch import mesh as M
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train import step as train_step_lib

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_configs())
    ap.add_argument("--reduced", action="store_true", help="smoke-size config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compute-dtype", default="float32", choices=tuple(DTYPES))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def make_batch(model, data_cfg: dp.LMDataConfig, step: int, device) -> dict:
    """The batch of ``step``: ``lm_batch``'s tokens and labels, with the
    non-token inputs the reference's launcher draws for its input kind."""
    batch = dp.lm_batch(data_cfg, step, device=device)
    if model.input_kind == "tokens":
        return batch
    rs = np.random.RandomState(step)
    B, T = data_cfg.global_batch, data_cfg.seq_len
    if model.input_kind == "embeddings":
        emb = rs.normal(size=(B, T, model.d_model)).astype(np.float32)
        return {"embeddings": torch.from_numpy(emb).to(device), "labels": batch["labels"]}
    prefix = rs.normal(size=(B, model.n_prefix, model.d_model)).astype(np.float32)
    return {"prefix_embeddings": torch.from_numpy(prefix).to(device), **batch}


def _arch(args):
    return configs.get_reduced(args.arch) if args.reduced else configs.get_config(args.arch)


def _quiet(*_args, **_kw) -> None:
    pass


def run(argv=None) -> dict:
    """Train as :func:`main` does -> ``{"steps", "start_step", "losses",
    "step_s", "params", "opt_state"}``: the step reached, the step it
    resumed from, this run's losses, the host seconds of each step (each
    ends in a read of its loss), and the final state (this rank's shards
    on a mesh)."""
    args = build_parser().parse_args(argv)
    model = _arch(args).model
    device = torch.device(args.device)
    shard, world = None, 1
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        shard = ShardingCtx(M.make_host_mesh((1, world))).for_model(model)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    say = print if shard is None or dist.get_rank() == 0 else _quiet
    if device.type == "cuda":
        set_ieee_fp32()

    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=min(20, args.steps // 10 + 1))
    tstep = train_step_lib.make_train_step(model, opt_cfg, compute_dtype=DTYPES[args.compute_dtype],
                                           accum_steps=args.accum, shard=shard)
    params = lm.init_params(model, seed=args.seed, device=device)
    if shard is not None:
        params = shard.place_params(model, params)
    opt_state = adamw.init_state(params, shard=shard)

    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        specs = None if shard is None else shard.state_specs(model, opt_state)
        ckpt = store.AsyncCheckpointer(args.ckpt_dir, shard=shard, specs=specs)
        latest = store.latest_step(args.ckpt_dir)
        if latest is not None:
            if shard is None:
                (params, opt_state), mf = store.restore(args.ckpt_dir, latest,
                                                        (params, opt_state), device=device)
            else:
                params, opt_state, mf = elastic.restore_elastic(
                    args.ckpt_dir, latest, model, shard, torch.float32, device=device)
            start_step = mf["step"]
            say(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    stop = {"flag": False}

    def _on_signal(signum, frame):
        say(f"[signal] {signum}: checkpoint-and-exit requested")
        stop["flag"] = True

    def stopping() -> bool:
        return stop["flag"] if shard is None else shard.count(stop["flag"]) > 0

    before = {s: signal.signal(s, _on_signal) for s in (signal.SIGTERM, signal.SIGINT)}
    data_cfg = dp.LMDataConfig(vocab=model.vocab, seq_len=args.seq, global_batch=args.batch,
                               seed=args.seed)
    t_start = time.time()
    losses, step_s = [], []
    step_i = start_step
    halt = stopping()
    try:
        while step_i < args.steps and not halt:
            t0 = time.perf_counter()
            batch = make_batch(model, data_cfg, step_i, device)
            for attempt in range(args.max_retries + 1):
                err = None
                try:
                    params, opt_state, metrics = tstep(params, opt_state, batch)
                except Exception as e:  # bounded retry (transient failures)
                    err = e
                failed = int(err is not None) if shard is None else shard.count(err is not None)
                if not failed:
                    break
                if err is None:
                    raise RuntimeError(f"step {step_i}: {failed} of {world} ranks failed and "
                                       "this one stepped: a retry would part their states")
                if attempt == args.max_retries or failed != world:
                    raise err
                say(f"[retry] step {step_i} attempt {attempt + 1}: {err}")
            step_i += 1
            loss = float(metrics["loss"])  # kanlint: ignore[KL102] (each step's loss)
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
            if step_i % args.log_every == 0 or step_i == args.steps:
                dt = time.time() - t_start
                tok_s = step_i * args.batch * args.seq / max(dt, 1e-9)
                gnorm = float(metrics["grad_norm"])  # kanlint: ignore[KL102] (the log line)
                lr = float(metrics["lr"])  # kanlint: ignore[KL102] (the log line)
                say(f"step {step_i:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                    f"lr {lr:.2e} tok/s {tok_s:,.0f}")
            halt = stopping()
            if ckpt is not None and (step_i % args.ckpt_every == 0 or halt):
                ckpt.save_async(step_i, (params, opt_state), {"loss": loss})
        if ckpt is not None:
            ckpt.save_async(step_i, (params, opt_state), {"loss": losses[-1] if losses else None})
            ckpt.wait()
    finally:
        for s, handler in before.items():
            signal.signal(s, handler)
    first = (float(np.mean(losses[:10])) if len(losses) >= 10
             else (losses[0] if losses else float("nan")))
    last = float(np.mean(losses[-10:])) if losses else float("nan")
    say(f"[done] steps={step_i} loss {first:.4f} -> {last:.4f}")
    return {"steps": step_i, "start_step": start_step, "losses": losses, "step_s": step_s,
            "params": params, "opt_state": opt_state}


def main(argv=None) -> int:
    """Train; under ``torchrun`` join its group first (and leave it after).
    A model the mesh does not take exits with rc=2."""
    args = build_parser().parse_args(argv)
    joined = M.under_torchrun() and not dist.is_initialized()
    if joined:
        M.join_from_env(args.device)
    try:
        why = lm.mesh_refusal(_arch(args).model) if dist.is_initialized() else None
        if why:
            print(why, file=sys.stderr)
            return 2
        run(argv)
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
