"""Batched serving demo: a small kanformer served through the port's engine.
Counterpart of ``examples/serve_kan.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_kan                      # static
    PYTHONPATH=src python -m repro_torch.examples.serve_kan --engine continuous  # slots
    PYTHONPATH=src python -m repro_torch.examples.serve_kan --engine continuous \\
        --shared-prefix                                   # paged + prefix hits
    PYTHONPATH=src python -m repro_torch.examples.serve_kan --engine continuous \\
        --spec-k 4 --draft-layers 1                       # speculative windows

``--engine static`` drains length-sorted fixed buckets; ``--engine
continuous`` recycles batch slots the moment a request finishes.
``--shared-prefix`` switches to the paged KV cache and a system-prompt-heavy
workload (every request shares a 32-token prefix, then 3-8 tokens of its
own), so the prefix cache prefills the shared blocks once and the demo
prints how many prefill tokens the pool saved.  ``--spec-k`` serves
speculative windows of a ``--draft-layers``-deep drafter.  ``--mesh`` is not
ported (rc=2).  Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch import configs
from repro_torch.core.kan_layer import resolve_inference_method
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("static", "continuous"), default="static")
    ap.add_argument("--chunk-steps", type=int, default=4)
    ap.add_argument("--shared-prefix", action="store_true",
                    help="paged-KV demo: one shared system prompt + unique "
                         "suffixes, exercising prefix-cache hits end to end")
    ap.add_argument("--mesh", type=str, default=None, metavar="DxM",
                    help="not ported yet")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: drafts per verify window (0 disables)")
    ap.add_argument("--draft-layers", type=int, default=1,
                    help="speculative: unit repeats kept in the drafter")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.shared_prefix and args.engine != "continuous":
        ap.error("--shared-prefix needs --engine continuous (paged KV)")
    if args.spec_k < 0:
        ap.error(f"--spec-k must be >= 0, got {args.spec_k}")
    if args.spec_k > 0 and args.engine != "continuous":
        ap.error("--spec-k needs --engine continuous")
    if args.mesh is not None:
        ap.error("--mesh is not ported yet (ROADMAP queue 1, item 9)")

    arch = configs.get_reduced("kanformer-100m")
    params = lm.init_params(arch.model, seed=0, device=args.device)
    eng = Engine(params, arch.model,
                 ServeConfig(max_seq=96, max_new_tokens=16, paged=args.shared_prefix,
                             block_size=8, spec_k=args.spec_k,
                             draft_layers=args.draft_layers),
                 device=args.device)
    rs = np.random.RandomState(0)
    if args.shared_prefix:
        # system-prompt-heavy workload: 32 shared tokens, 3-8 unique ones
        system = rs.randint(0, arch.model.vocab, 32).astype(np.int32)
        requests = [
            np.concatenate([system, rs.randint(0, arch.model.vocab,
                                               rs.randint(3, 9)).astype(np.int32)])
            for _ in range(12)
        ]
    else:
        requests = [rs.randint(0, arch.model.vocab, rs.randint(4, 24)).astype(np.int32)
                    for _ in range(12)]
    print(f"device={eng.device} engine={args.engine} "
          f"kan_method_prefill={resolve_inference_method(eng.device, rows=4 * 24)} "
          f"kan_method_decode={resolve_inference_method(eng.device, rows=4)}")
    t0 = time.time()
    if args.engine == "continuous":
        outs = eng.serve_continuous(requests, slots=4, chunk_steps=args.chunk_steps)
    else:
        outs = eng.serve_requests(requests, batch_size=4)
    dt = time.time() - t0
    n_tok = sum(len(o) for o in outs)
    print(f"served {len(requests)} requests / {n_tok} new tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s, {eng.device})")
    if args.engine == "continuous" and eng.last_serve_stats:
        s = eng.last_serve_stats
        print(f"mean_slot_utilization={s['mean_slot_utilization']:.3f}")
        if args.shared_prefix:
            p = s["paged"]
            total = p["prefill_tokens_computed"] + p["prefill_tokens_saved"]
            print(f"paged: prefix_hit_blocks={p['prefix_hit_blocks']} "
                  f"prefill_tokens_saved={p['prefill_tokens_saved']}/{total} "
                  f"blocks_watermark={p['blocks_in_use_watermark']}/{p['pool_blocks'] - 1}")
        if args.spec_k > 0:
            sp = s["spec"]
            print(f"speculative: k={sp['spec_k']} draft_layers={sp['draft_layers']} "
                  f"acceptance_rate={sp['acceptance_rate']:.3f} windows={sp['windows']}")
    for i, o in enumerate(outs[:3]):
        print(f"  req{i} prompt_len={len(requests[i])} -> {o[:8].tolist()}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
