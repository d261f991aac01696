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

The CUDA kernel (``csrc/paged_gather.cu``) copies one logical block per
CUDA block in 16-byte units, all layers of a stacked pool in one launch;
its source note states its bound.  :func:`gather_blocks_reference` is the
plain PyTorch version (advanced indexing); ``chip_smoke.py`` holds the
kernel against it on the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.uint8)


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


def gather_blocks_cuda(pool: torch.Tensor, table: torch.Tensor,
                       stacked: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors: one launch for every layer,
    none when the view is empty."""
    rank = 3 if stacked else 2
    if pool.dim() < rank or table.dim() != 2:
        raise ValueError(f"pool must have rank >= {rank} (stacked={stacked}) and table "
                         f"rank 2; got {tuple(pool.shape)} and {tuple(table.shape)}")
    if pool.dtype not in DTYPES:
        raise ValueError(f"pool dtype {pool.dtype} not supported ({DTYPES})")
    if table.dtype != torch.int32:
        raise ValueError(f"table dtype must be int32, got {table.dtype}")
    if not (pool.is_contiguous() and table.is_contiguous()):
        raise ValueError("pool and table must be contiguous")
    if pool.device.type != "cuda" or table.device != pool.device:
        raise ValueError("pool and table must be on one CUDA device")
    layers = pool.shape[0] if stacked else 1
    n_blocks = pool.shape[1 if stacked else 0]
    B, L = table.shape
    view = torch.empty(_view_shape(pool, table, stacked), dtype=pool.dtype,
                       device=pool.device)
    if view.numel() == 0:
        return view                   # nothing to copy: no launch
    esize = pool.element_size()
    block_bytes = math.prod(pool.shape[rank - 1:]) * esize
    lib = build.load("paged_gather")
    err = lib.paged_gather(pool.data_ptr(), table.data_ptr(), view.data_ptr(), layers,
                           n_blocks, B, L, block_bytes, esize,
                           torch.cuda.current_stream(pool.device).cuda_stream)
    build.check(err, "paged_gather")
    return view
