"""Carry parameters from the JAX package across to the port.

Leaves are keyed by tree path exactly as ``repro/checkpoint/store.py:
_flatten_with_paths`` keys them (``"['unit']/[0]/['attn']/['wq']"``), so a
checkpoint's ``arrays.npz`` and a live parameter tree (converted to numpy
with ``jax.device_get``) load the same way.  This module imports no JAX.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_PART = re.compile(r"^\[(?:'([^']*)'|(\d+))\]$")


def flatten_with_paths(tree, prefix: str = "") -> dict[str, object]:
    """Nested dicts/lists -> ``{path: leaf}`` with the reference's keys
    (dict keys visited in sorted order, as JAX flattens dicts)."""
    out: dict[str, object] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(node[k], path + [f"['{k}']"])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [f"[{i}]"])
        else:
            out["/".join(path)] = node

    walk(tree, [prefix] if prefix else [])
    return out


def unflatten_paths(flat: Mapping[str, object]) -> dict:
    """Inverse of :func:`flatten_with_paths`: rebuild dicts and lists."""
    root: dict = {}
    for key, leaf in flat.items():
        parts = [_PART.match(p) for p in key.split("/")]
        if not all(parts):
            raise ValueError(f"not a tree path: {key!r}")
        node = root
        for here, nxt in zip(parts[:-1], parts[1:]):
            k = here.group(1) if here.group(1) is not None else int(here.group(2))
            node = node.setdefault(k, {})
        last = parts[-1]
        node[last.group(1) if last.group(1) is not None else int(last.group(2))] = leaf

    def fix_lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [fix_lists(node[i]) for i in range(len(node))]
        return {k: fix_lists(v) for k, v in node.items()}

    return fix_lists(root)


def params_from_jax(tree_of_numpy, device="cuda", dtype=None) -> dict:
    """A JAX parameter tree of numpy arrays (nested, or flat by tree path
    as in ``arrays.npz``) -> the port's tree of torch tensors."""
    if isinstance(tree_of_numpy, Mapping) and tree_of_numpy and all(
            isinstance(k, str) and k.startswith("[") for k in tree_of_numpy):
        flat = dict(tree_of_numpy)
    else:
        flat = flatten_with_paths(tree_of_numpy)

    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True))
        if dtype is not None:
            t = t.to(dtype)
        return t.to(device)

    return unflatten_paths({k: leaf(v) for k, v in flat.items()})
