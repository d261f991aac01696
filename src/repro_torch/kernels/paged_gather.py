"""Block-table gather for the paged KV cache.

Counterpart of ``repro/kernels/paged_gather.py`` (the Pallas TPU kernel
``_gather_kernel`` / ``gather_blocks_pallas``).  The paged cache stores KV
in a pool of fixed-size blocks ``pool (n_blocks, bs, ...)``, optionally with
a leading layers axis ``(layers, n_blocks, bs, ...)``, and each batch row
owns a block table ``table (B, L)`` of physical block ids.  The gather
materialises the logical contiguous view

``view[..., b, l·bs + o, ...] = pool[..., table[b, l], o, ...]``

so the unchanged dense attention math runs on it.  It is pure data
movement: kernel and plain version are bit-equal.  Table ids are clipped to
``[0, n_blocks - 1]`` (``jnp.take``'s ``mode="clip"``, as the JAX package's
plain version documents); the engine never emits one outside the pool.

The CUDA kernel (``csrc/paged_gather.cu``) gathers every leaf of a cache
that shares one table (``k`` and ``v``; at most :data:`MAX_LEAVES`, each
with its own pool, block size and dtype) and every layer of a stacked
pool in ONE launch, a part of a block per CTA, in 16-byte units where the
blocks allow; its source note states its bound.
:func:`gather_blocks_reference` is the plain PyTorch version (advanced
indexing); ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plan as pl

DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.uint8)
MAX_LEAVES = 4                 # leaf descriptors one launch takes (csrc kMaxLeaves)
_THREADS, _UNROLL = 128, 4     # csrc/paged_gather.cu:70-71
STATIC_SMEM = 0


def launch_plan(leaves: list, B: int, L: int, sms: int = pl.SMS,
                per_sm: int | None = None) -> pl.Plan:
    """``plan_leaves`` (csrc/paged_gather.cu:157-199) in Python.  Each leaf
    is a dict of ``block_bytes``, ``n_blocks``, ``layers``, ``elem_bytes``
    and ``align`` (the smaller address alignment of its pool and view)."""
    if not 1 <= len(leaves) <= MAX_LEAVES or B < 0 or L < 0:
        return pl.Plan(error=pl.INVALID_VALUE)
    layers = parts = 0
    units, rows = [], []
    for f in leaves:
        e, bb = f["elem_bytes"], f["block_bytes"]
        if f["layers"] < 0 or f["n_blocks"] < 1 or bb < 0 or e not in (1, 2, 4) or bb % e:
            return pl.Plan(error=pl.INVALID_VALUE)
        if f["layers"] == 0 or bb == 0:
            continue
        unit = 16 if bb % 16 == 0 and f["align"] == 16 else e
        n = pl.cdiv(bb, _THREADS * _UNROLL * unit)
        if n > pl.MAX_GRID_YZ or layers + f["layers"] > pl.MAX_GRID_YZ:
            return pl.Plan(error=pl.INVALID_CONFIGURATION)
        units.append(unit)
        rows.append((unit, bb))
        layers += f["layers"]
        parts = max(parts, n)
    if not units or B * L == 0:
        return pl.Plan(extra=tuple(units))
    if B * L > pl.MAX_GRID_X:
        return pl.Plan(error=pl.INVALID_CONFIGURATION)
    return pl.Plan(grid=(B * L, parts, layers), threads=_THREADS, vec=min(units),
                   extra=tuple(units), rows=tuple(rows))


def plan_export(lib, leaves: list, B: int, L: int) -> pl.Plan:
    """The library's own plan (``paged_gather_plan``); each leaf's pool
    and view addresses are stand-ins of its ``align`` (nothing is read)."""
    descs = (_Leaf * len(leaves))(*[
        _Leaf(f["align"], f["align"], f["block_bytes"], f["n_blocks"], f["layers"],
              f["elem_bytes"]) for f in leaves])
    return pl.read_export(lambda *a: lib.paged_gather_plan(ctypes.addressof(descs), *a),
                          [len(leaves), B, L], lambda inst: ())


def threads_of(template: tuple) -> int:
    """``__launch_bounds__(kThreads)`` (.cu:126)."""
    return _THREADS


class _Leaf(ctypes.Structure):
    """``PagedLeaf`` of ``csrc/paged_gather.cu``."""
    _fields_ = [("pool", ctypes.c_void_p), ("view", ctypes.c_void_p),
                ("block_bytes", ctypes.c_longlong), ("n_blocks", ctypes.c_int),
                ("layers", ctypes.c_int), ("elem_bytes", ctypes.c_int)]


def _view_shape(pool: torch.Tensor, table: torch.Tensor, stacked: bool) -> tuple:
    B, L = table.shape
    lead = pool.shape[:1] if stacked else ()
    bs = pool.shape[len(lead) + 1]
    return lead + (B, L * bs) + tuple(pool.shape[len(lead) + 2:])


def gather_blocks_reference(pool: torch.Tensor, table: torch.Tensor,
                            stacked: bool = False) -> torch.Tensor:
    """``pool (n_blocks, bs, ...)`` (``(layers, n_blocks, bs, ...)`` when
    ``stacked``) and ``table (B, L)`` -> ``(B, L·bs, ...)`` (with the
    leading layers axis when ``stacked``)."""
    n_blocks = pool.shape[1 if stacked else 0]
    idx = table.reshape(-1).long().clamp(0, n_blocks - 1)
    g = pool[:, idx] if stacked else pool[idx]
    return g.reshape(_view_shape(pool, table, stacked))


def gather_views_reference(cache: dict, table: torch.Tensor,
                           stacked: bool = False) -> dict:
    """:func:`gather_blocks_reference` of every leaf of ``cache``."""
    return {name: gather_blocks_reference(p, table, stacked) for name, p in cache.items()}


def gather_views_cuda(pools: list, table: torch.Tensor,
                      stacked: bool = False) -> list:
    """Launch the CUDA kernel on CUDA tensors: the views of ``pools``
    (leaves of one table) in ONE launch, none when every view is empty."""
    rank = 3 if stacked else 2
    if not 1 <= len(pools) <= MAX_LEAVES:
        raise ValueError(f"one launch takes 1 to {MAX_LEAVES} leaves; got {len(pools)}")
    for pool in pools:
        if pool.dim() < rank or table.dim() != 2:
            raise ValueError(f"pool must have rank >= {rank} (stacked={stacked}) and table "
                             f"rank 2; got {tuple(pool.shape)} and {tuple(table.shape)}")
        if pool.dtype not in DTYPES:
            raise ValueError(f"pool dtype {pool.dtype} not supported ({DTYPES})")
    if table.dtype != torch.int32:
        raise ValueError(f"table dtype must be int32, got {table.dtype}")
    if not (table.is_contiguous() and all(p.is_contiguous() for p in pools)):
        raise ValueError("pools and table must be contiguous")
    if table.device.type != "cuda" or any(p.device != table.device for p in pools):
        raise ValueError("pools and table must be on one CUDA device")
    B, L = table.shape
    views = [torch.empty(_view_shape(p, table, stacked), dtype=p.dtype, device=p.device)
             for p in pools]
    if not any(v.numel() for v in views):
        return views                  # nothing to copy: no launch
    leaves = (_Leaf * len(pools))(*[
        _Leaf(p.data_ptr(), v.data_ptr(), math.prod(p.shape[rank - 1:]) * p.element_size(),
              p.shape[rank - 2], p.shape[0] if stacked else 1, p.element_size())
        for p, v in zip(pools, views)])
    lib = build.load("paged_gather")
    err = lib.paged_gather(ctypes.addressof(leaves), len(pools), table.data_ptr(), B, L,
                           torch.cuda.current_stream(table.device).cuda_stream)
    build.check(err, "paged_gather")
    return views
