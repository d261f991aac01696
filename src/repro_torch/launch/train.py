"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The counterpart of ``repro/launch/train.py`` on one device (``--device``,
``cuda`` unless ``cpu`` is given; no mesh):

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

from repro_torch import configs, set_ieee_fp32
from repro_torch.checkpoint import store
from repro_torch.data import pipeline as dp
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


def run(argv=None) -> dict:
    """Train as :func:`main` does -> ``{"steps", "start_step", "losses",
    "step_s", "params", "opt_state"}``: the step reached, the step it
    resumed from, this run's losses, the host seconds of each step (each
    ends in a read of its loss), and the final state."""
    args = build_parser().parse_args(argv)
    arch = configs.get_reduced(args.arch) if args.reduced else configs.get_config(args.arch)
    model = arch.model
    device = torch.device(args.device)
    if device.type == "cuda":
        set_ieee_fp32()

    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=min(20, args.steps // 10 + 1))
    tstep = train_step_lib.make_train_step(model, opt_cfg, compute_dtype=DTYPES[args.compute_dtype],
                                           accum_steps=args.accum)
    params = lm.init_params(model, seed=args.seed, device=device)
    opt_state = adamw.init_state(params)

    start_step = 0
    ckpt = store.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None:
        latest = store.latest_step(args.ckpt_dir)
        if latest is not None:
            (params, opt_state), mf = store.restore(args.ckpt_dir, latest, (params, opt_state),
                                                    device=device)
            start_step = mf["step"]
            print(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    stop = {"flag": False}

    def _on_signal(signum, frame):
        print(f"[signal] {signum}: checkpoint-and-exit requested")
        stop["flag"] = True

    before = {s: signal.signal(s, _on_signal) for s in (signal.SIGTERM, signal.SIGINT)}
    data_cfg = dp.LMDataConfig(vocab=model.vocab, seq_len=args.seq, global_batch=args.batch,
                               seed=args.seed)
    t_start = time.time()
    losses, step_s = [], []
    step_i = start_step
    try:
        while step_i < args.steps and not stop["flag"]:
            t0 = time.perf_counter()
            batch = make_batch(model, data_cfg, step_i, device)
            for attempt in range(args.max_retries + 1):
                try:
                    params, opt_state, metrics = tstep(params, opt_state, batch)
                    break
                except Exception as e:  # bounded retry (transient failures)
                    if attempt == args.max_retries:
                        raise
                    print(f"[retry] step {step_i} attempt {attempt + 1}: {e}")
            step_i += 1
            loss = float(metrics["loss"])  # kanlint: ignore[KL102] (each step's loss)
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
            if step_i % args.log_every == 0 or step_i == args.steps:
                dt = time.time() - t_start
                tok_s = step_i * args.batch * args.seq / max(dt, 1e-9)
                gnorm = float(metrics["grad_norm"])  # kanlint: ignore[KL102] (the log line)
                lr = float(metrics["lr"])  # kanlint: ignore[KL102] (the log line)
                print(f"step {step_i:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                      f"lr {lr:.2e} tok/s {tok_s:,.0f}")
            if ckpt is not None and (step_i % args.ckpt_every == 0 or stop["flag"]):
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
    print(f"[done] steps={step_i} loss {first:.4f} -> {last:.4f}")
    return {"steps": step_i, "start_step": start_step, "losses": losses, "step_s": step_s,
            "params": params, "opt_state": opt_state}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
