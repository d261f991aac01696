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

DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.uint8)
MAX_LEAVES = 4                 # leaf descriptors one launch takes (csrc kMaxLeaves)


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
