"""End-to-end LM training: kanformer (the paper's KAN layers as the FFN of a
decoder LM) on the synthetic LM stream, with checkpoints and a restart.
Counterpart of ``examples/lm_train.py``.

    PYTHONPATH=src python -m repro_torch.examples.lm_train [--steps 300] [--full] [--device cpu]

Trains through ``launch.train`` with the reference example's settings (batch
8, seq 64, lr 2e-3, a checkpoint every ``max(50, steps // 4)`` steps, the
reduced config unless ``--full``), then the restart drill: 20 more steps,
resumed from the latest checkpoint.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

from repro_torch.launch import train as T


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    ckpt = tempfile.mkdtemp(prefix="kanformer_ckpt_")
    flags = ["--batch", "8", "--seq", "64", "--lr", "2e-3", "--ckpt-dir", ckpt,
             "--ckpt-every", str(max(50, args.steps // 4)), "--log-every", "20",
             "--device", args.device] + ([] if args.full else ["--reduced"])
    try:
        rc = T.main(["--arch", "kanformer-100m", "--steps", str(args.steps)] + flags)
        print("\n[restart drill] resuming from latest checkpoint ...")
        rc2 = T.main(["--arch", "kanformer-100m", "--steps", str(args.steps + 20)] + flags)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return rc or rc2


if __name__ == "__main__":
    raise SystemExit(main())
