"""Serving launcher: ``python -m repro_torch.launch.serve --arch kanformer-100m``.

Takes the flags of ``repro/launch/serve.py``.  The static greedy engine
(``--engine static``, ``Engine.serve_requests``) is ported; the continuous
engine, ``--paged``, ``--spec-k > 0``, ``--mesh`` and ``--temperature > 0``
exit with rc=2 and say they are not ported yet.  Reduced shapes are the
default; ``--full`` selects the full config.  Runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch import configs
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, ServeConfig


def pick_config(arch: str, full: bool):
    return configs.get_config(arch) if full else configs.get_reduced(arch)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_configs())
    ap.add_argument("--full", action="store_true",
                    help="use the full config (default: reduced)")
    ap.add_argument("--engine", choices=("static", "continuous"), default="static")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4, help="static: bucket size")
    ap.add_argument("--chunk-steps", type=int, default=8)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--pool-blocks", type=int, default=None)
    ap.add_argument("--mesh", type=str, default=None, metavar="DxM")
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--draft-layers", type=int, default=1)
    ap.add_argument("--draft-quant", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _refusal(args) -> str | None:
    """Why these flags cannot be served (rc=2), or None."""
    if args.spec_k < 0:
        return f"--spec-k must be >= 0, got {args.spec_k}"
    if args.engine != "static":
        return "--engine continuous is not ported yet (ROADMAP queue 1, item 7)"
    if args.paged:
        return "--paged is not ported yet (ROADMAP queue 1, item 8)"
    if args.spec_k != 0:
        return "--spec-k is not ported yet (ROADMAP queue 1, item 9)"
    if args.mesh is not None:
        return "--mesh is not ported yet (ROADMAP queue 1, item 14)"
    if args.temperature > 0.0:
        return "--temperature > 0 is not ported yet (ROADMAP queue 1, item 11)"
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    why = _refusal(args)
    if why:
        print(f"[serve] {why}", file=sys.stderr)
        return 2
    model = pick_config(args.arch, args.full).model
    params = lm.init_params(model, seed=args.seed, device=args.device)
    max_seq = args.prompt_len + args.max_new + 8
    eng = Engine(params, model,
                 ServeConfig(max_seq=max_seq, max_new_tokens=args.max_new,
                             eos_id=args.eos_id),
                 device=args.device)
    rs = np.random.RandomState(args.seed)
    reqs = [rs.randint(0, model.vocab, rs.randint(4, args.prompt_len + 1)).astype(np.int32)
            for _ in range(args.requests)]
    t0 = time.time()
    outs = eng.serve_requests(reqs, batch_size=args.batch, seed=args.seed)
    dt = time.time() - t0
    total_new = sum(len(o) for o in outs)
    print(f"[serve:static] {len(reqs)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s) on {eng.device}")
    print("sample output ids:", outs[0][:10].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
