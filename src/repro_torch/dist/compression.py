"""Gradient wire-format compression (counterpart of
``repro/dist/compression.py``).

Under data parallelism the gradient all-reduce carries the most traffic;
bf16 halves its bytes and int8 quarters them.  ``compress_tree`` models a
format as a compress -> decompress round trip: the returned tree is float32
again and carries exactly the quantisation error the format would add.
int8 scales each tensor symmetrically (``q = round(g / s)``, ``s =
max|g| / 127``), as ``core/quantization.py`` scales coefficients.
"""

from __future__ import annotations

import torch

from repro_torch.convert import tree_map

KINDS = ("bf16", "int8")


def _roundtrip_bf16(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.bfloat16).to(torch.float32)


def _roundtrip_int8(g: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def compress_leaf(g: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "bf16":
        return _roundtrip_bf16(g)
    if kind == "int8":
        return _roundtrip_int8(g)
    raise ValueError(f"unknown compression kind {kind!r}; expected {KINDS}")


def compress_tree(grads, kind: str):
    """Round-trip a gradient tree through the given wire format."""
    return tree_map(lambda g: compress_leaf(g, kind), grads)
