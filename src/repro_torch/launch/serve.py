"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

``--arch`` takes the port's registry (``repro_torch.configs``):
kanformer-100m, qwen1.5-0.5b, qwen2.5-3b, qwen1.5-32b, gemma3-12b,
olmoe-1b-7b, deepseek-v2-lite, zamba2-1.2b, xlstm-1.3b; paligemma-3b and
musicgen-large exit with rc=2, since the engine serves token prompts only
(the reference's CLI dies on them with a ``KeyError``).  Takes
the flags of ``repro/launch/serve.py``.  ``--engine static`` drains
length-sorted fixed buckets (``Engine.serve_requests``); ``--engine
continuous`` runs the slot-recycling loop (``Engine.serve_continuous``,
``--batch`` slots, ``--chunk-steps`` per chunk) and reports its slot
utilization; ``--paged`` (continuous only) serves from the paged block pool
with prefix caching and preemption (``--block-size``, ``--pool-blocks``);
``--spec-k K`` (continuous only) serves speculative windows of a
``--draft-layers``-deep drafter (``--draft-quant``: int8 fake-quantised).
``--temperature T > 0`` samples in every engine mode, each request's key
chain keyed by ``--seed`` and its index, as the reference's CLI does.
``--mesh DxM`` serves on a ``(data, model)`` mesh of ``D * M`` ranks
(``launch/mesh.py``), one process each: spawned here, meeting at a
``FileStore`` in a temporary directory, or the processes of ``torchrun``
when its environment is set; only rank 0 prints.  ``--device cpu`` runs
the ranks over gloo; ``--device cuda`` gives each rank its own card and
NCCL, and exits with rc=2 when the mesh has more ranks than cards, unless
``--share-card`` asks for the one-card rehearsal (every rank on
``cuda:0``, collectives over gloo through the host).  A mesh serves the
token-input ``attn_kan``/``attn_mlp``/``attn_moe`` models (olmoe-1b-7b's
experts on the model axis; deepseek-v2-lite's MLA latent on it, its heads
too) without ``--spec-k``; recurrent, windowed and non-token models exit
with rc=2 (ROADMAP queue 1, item 9.4.2).  A windowed model
(gemma3), an MLA one (deepseek-v2-lite) or a recurrent one (zamba2-1.2b,
xlstm-1.3b) is refused as the reference refuses it: ``--spec-k`` with
rc=2, ``--paged`` by the ``NotImplementedError`` of its paged caches.  Reduced
shapes are the default; ``--full`` selects the full config.  Runs on
``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch import configs
from repro_torch.dist.sharding import mesh_shape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, ServeConfig, token_prompts_only


def pick_config(arch: str, full: bool):
    return configs.get_config(arch) if full else configs.get_reduced(arch)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_configs())
    ap.add_argument("--full", action="store_true",
                    help="use the full config (default: reduced)")
    ap.add_argument("--engine", choices=("static", "continuous"), default="static")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4,
                    help="static: bucket size; continuous: slot count")
    ap.add_argument("--chunk-steps", type=int, default=8,
                    help="continuous: decode steps per chunk")
    ap.add_argument("--paged", action="store_true",
                    help="continuous: paged KV cache (block pool + prefix caching "
                         "+ preemption)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="paged: tokens per KV block (must divide max_seq)")
    ap.add_argument("--pool-blocks", type=int, default=None,
                    help="paged: physical blocks incl. the sentinel "
                         "(default: dense-equivalent capacity)")
    ap.add_argument("--mesh", type=str, default=None, metavar="DxM",
                    help="serve on a (data, model) mesh of D*M ranks, e.g. 2x2")
    ap.add_argument("--share-card", action="store_true",
                    help="mesh on cuda: the one-card rehearsal, every rank on cuda:0 over "
                         "gloo (not a scale-out figure)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="continuous: speculative decoding, drafts per verify "
                         "window (0 disables)")
    ap.add_argument("--draft-layers", type=int, default=1,
                    help="speculative: leading unit repeats kept in the derived "
                         "drafter (1..n_repeats)")
    ap.add_argument("--draft-quant", action="store_true",
                    help="speculative: int8 fake-quantise the drafter's weights")
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _refusal(args, model) -> str | None:
    """Why these flags cannot be served (rc=2), or None."""
    if model.input_kind != "tokens":
        return token_prompts_only(model)
    if args.paged and args.engine != "continuous":
        return "--paged requires --engine continuous"
    if args.spec_k < 0:
        return f"--spec-k must be >= 0, got {args.spec_k}"
    if args.spec_k > 0 and args.engine != "continuous":
        return "--spec-k requires --engine continuous"
    if not (1 <= args.draft_layers <= model.n_repeats):
        return (f"--draft-layers must be in [1, {model.n_repeats}] for {args.arch}, "
                f"got {args.draft_layers}")
    if args.spec_k > 0 and not lm.model_supports_speculative(model):
        return (f"{args.arch} does not support speculative decoding "
                "(needs token-input full-attention GQA blocks)")
    if args.mesh is None:
        return "--share-card needs --mesh" if args.share_card else None
    try:
        shape = mesh_lib.parse_mesh_shape(args.mesh)
        missing = mesh_lib.devices_missing(shape, args.device, args.share_card)
    except ValueError as e:
        return str(e)
    if args.share_card and args.device != "cuda":
        return "--share-card rehearses a mesh on one CUDA card: it needs --device cuda"
    if args.spec_k > 0:
        return "--spec-k on a mesh is not ported yet (ROADMAP queue 1, item 9.4)"
    return lm.mesh_refusal(model) or missing


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    model = pick_config(args.arch, args.full).model
    why = _refusal(args, model)
    if why:
        print(f"[serve] {why}", file=sys.stderr)
        return 2
    if args.mesh is None:
        lines = serve(args)
    else:
        shape = mesh_lib.parse_mesh_shape(args.mesh)
        if mesh_lib.under_torchrun():
            import torch.distributed as dist

            try:
                mesh, dev = mesh_lib.init_from_env(shape, args.device, args.share_card)
            except ValueError as e:
                print(f"[serve] {e}", file=sys.stderr)
                return 2
            lines = serve(args, mesh, dev)
            if dist.get_rank() != 0:       # only rank 0 prints
                lines = []
            dist.destroy_process_group()
        else:
            lines = mesh_lib.run_ranks(_serve_rank, shape, args.device, args.share_card,
                                       args=(vars(args),))[0]
    for ln in lines:
        print(ln)
    return 0


def _serve_rank(mesh, device, arg_dict: dict) -> list[str]:
    return serve(argparse.Namespace(**arg_dict), mesh, device)


def serve(args, mesh=None, device=None) -> list[str]:
    """Serve the requests ``args`` describe -> the lines to print (on a
    mesh, this rank's; every rank serves the same requests)."""
    model = pick_config(args.arch, args.full).model
    device = args.device if device is None else device
    lines = []
    if mesh is not None:
        shape = mesh_shape(mesh)
        how = mesh_lib.backend(args.device, args.share_card)
        lines.append(f"[serve] mesh={shape} over {mesh.mesh.numel()} ranks ({how} on "
                     f"{args.device})")
        if args.share_card:
            lines.append(f"[serve] rehearsal: {mesh.mesh.numel()} ranks share cuda:0, every "
                         "collective staged through the host over gloo; not a scale-out "
                         "figure")
    params = lm.init_params(model, seed=args.seed, device=device)
    max_seq = args.prompt_len + args.max_new + 8
    if args.paged:                    # the paged pool addresses whole blocks
        max_seq = -(-max_seq // args.block_size) * args.block_size
    eng = Engine(params, model,
                 ServeConfig(max_seq=max_seq, max_new_tokens=args.max_new,
                             temperature=args.temperature, eos_id=args.eos_id, paged=args.paged,
                             block_size=args.block_size, pool_blocks=args.pool_blocks,
                             spec_k=args.spec_k, draft_layers=args.draft_layers,
                             draft_quant=args.draft_quant, mesh=mesh),
                 device=device)
    rs = np.random.RandomState(args.seed)
    reqs = [rs.randint(0, model.vocab, rs.randint(4, args.prompt_len + 1)).astype(np.int32)
            for _ in range(args.requests)]
    t0 = time.time()
    if args.engine == "continuous":
        outs = eng.serve_continuous(reqs, slots=args.batch, chunk_steps=args.chunk_steps,
                                    seed=args.seed)
    else:
        outs = eng.serve_requests(reqs, batch_size=args.batch, seed=args.seed)
    dt = time.time() - t0
    total_new = sum(len(o) for o in outs)
    lines.append(f"[serve:{args.engine}] {len(reqs)} requests, {total_new} tokens in "
                 f"{dt:.2f}s ({total_new / dt:.1f} tok/s) on {eng.device}")
    if args.engine == "continuous":
        s = eng.last_serve_stats
        lines.append(f"[serve:continuous] slot_utilization={s['mean_slot_utilization']:.3f} "
                     f"chunks={s['chunks_run']} served={s['n_served']}/{s['n_submitted']}")
        if args.paged:
            p = s["paged"]
            lines.append(
                f"[serve:paged] block_size={p['block_size']} "
                f"blocks_watermark={p['blocks_in_use_watermark']}/{p['pool_blocks'] - 1} "
                f"prefix_hit_blocks={p.get('prefix_hit_blocks', 0)} "
                f"prefill_tokens_saved={p['prefill_tokens_saved']} "
                f"preemptions={s['n_preemptions']}")
        if args.spec_k > 0:
            sp = s["spec"]
            lines.append(f"[serve:spec] k={sp['spec_k']} draft_layers={sp['draft_layers']} "
                         f"windows={sp['windows']} "
                         f"acceptance_rate={sp['acceptance_rate']:.3f} "
                         f"emitted={sp['emitted_tokens']}")
    lines.append(f"sample output ids: {outs[0][:10].tolist()}")
    return lines


if __name__ == "__main__":
    sys.exit(main())
