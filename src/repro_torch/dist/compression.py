"""Gradient wire-format compression (counterpart of
``repro/dist/compression.py``).

Under data parallelism the gradient all-reduce carries the most traffic;
bf16 halves its bytes and int8 quarters them.  ``compress_tree`` models a
format as a compress -> decompress round trip: the returned tree is float32
again and carries exactly the quantisation error the format would add.
int8 scales each tensor symmetrically (``q = round(g / s)``, ``s =
max|g| / 127``), as ``core/quantization.py`` scales coefficients.  On a
mesh (``shard``, a ``ShardingCtx.for_model``; the gradients this rank's
model-local leaves, already summed over ``data``) ``max|g|`` is the whole
logical leaf's: the local maximum of a leaf that ``model`` splits is
reduced over ``model`` with ``MAX``.
"""

from __future__ import annotations

import torch

from repro_torch.convert import flatten_with_paths, tree_map, unflatten_paths

KINDS = ("bf16", "int8")


def _roundtrip_bf16(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.bfloat16).to(torch.float32)


def _roundtrip_int8(g: torch.Tensor, top: torch.Tensor | None = None) -> torch.Tensor:
    """``top``: the whole leaf's max|g| where ``g`` is a shard of it."""
    scale = torch.clamp_min(g.abs().max() if top is None else top, 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def compress_leaf(g: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "bf16":
        return _roundtrip_bf16(g)
    if kind == "int8":
        return _roundtrip_int8(g)
    raise ValueError(f"unknown compression kind {kind!r}; expected {KINDS}")


def compress_tree(grads, kind: str, shard=None):
    """Round-trip a gradient tree through the given wire format; on a mesh
    the maxima of the leaves ``model`` splits are reduced in one
    ``all_reduce``."""
    split = [] if shard is None or kind != "int8" else [
        shard.leaf_plan[k][0] for k in flatten_with_paths(grads)]
    if not any(split):
        return tree_map(lambda g: compress_leaf(g, kind), grads)
    flat = flatten_with_paths(grads)
    tops = torch.stack([g.abs().max() for g in flat.values()])
    mask = torch.tensor(split, device=tops.device)
    whole = torch.where(mask, tops, 0)
    torch.distributed.all_reduce(whole, op=torch.distributed.ReduceOp.MAX,
                                 group=shard.mesh.get_group("model"))
    tops = torch.where(mask, whole, tops)
    return unflatten_paths({k: _roundtrip_int8(g, tops[i])
                            for i, (k, g) in enumerate(flat.items())})
