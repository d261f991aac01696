"""Compact N:M sparse KAN GEMM, the decode path: float and int8 kernels.

Counterpart of ``repro/kernels/kan_sparse_gemm.py`` (the Pallas TPU kernels
``_sparse_kernel`` / ``kan_sparse_gemm_pallas`` and ``_sparse_int8_kernel``
/ ``kan_sparse_int8_gemm_pallas``): each input contracts only its ``P+1``
non-zero basis values against the coefficient slab ``C[j, k-P .. k, :]`` it
touches, in one launch.

* Float (``csrc/kan_sparse_gemm.cu``): plus the base term; a GEMV split
  over K into about two blocks per SM (the split taken from K, N, M and
  C's dtype, never from the row count, so a row's bits do not depend on
  the rows beside it); per block up to 8 rows, 4 fp32 or 8 bf16 columns a
  thread, and the slice's coefficient and Wb rows asked for at once into
  shared memory (all M rows, or at 1-2 rows only those the windows
  touch); per (row, input) one packed entry and P+1 FMAs per column;
  input lanes summed in shared memory, and the K slices' fp32 partials
  summed in a fixed order by the tile's last block in the same launch.
  Bound by the bytes of the touched rows.  It takes ``P in {1, 2, 3}``
  and ``M = G+P <= 16``.
* int8 (``csrc/kan_sparse_int8_gemm.cu``): the integer datapath of
  ``kan_int8_gemm`` (Eq. 5 address arithmetic, uint8 ROM values, int8
  slabs, optional dequant epilogue) as a GEMV split over K into about two
  blocks per SM; per (row, input) one packed word of (window, ROM values)
  and one ``dp4a`` per column; K slices summed by int32 atomics; its
  integers are the dense-band kernel's.  It takes ``P in {1, 2, 3}`` and
  ``M <= 16``.

Both kernels keep their workspace per stream (:mod:`.workspace`).  Their
source notes state their bounds.  :func:`kan_sparse_gemm_reference` and
:func:`kan_sparse_int8_gemm_reference` are the plain PyTorch versions:
gathered slabs and an einsum (float64 for the integers, exact).  Their
``(BS, K, P+1, N)`` gather is fine at decode row counts and at the CPU
tests' sizes.
"""

from __future__ import annotations

import torch

from repro_torch.core.bspline import SplineGrid
from repro_torch.kernels import build
from repro_torch.kernels.common import (
    compact_basis_inblock, gather_coeff_slabs, int8_compact_values_inblock, rom_table)
from repro_torch.kernels.kan_fused_gemm import DTYPE_CODES, check_operands
from repro_torch.kernels.kan_int8_gemm import OUT_CODES, check_int8_operands, dequant_epilogue
from repro_torch.kernels.workspace import workspace

MAX_M = 16                    # the widest M both sparse kernels are compiled for

def kan_sparse_gemm_reference(
    x: torch.Tensor, coeff: torch.Tensor, grid: SplineGrid,
    base_w: torch.Tensor | None = None,
) -> torch.Tensor:
    """``x (BS, K)``, ``coeff (K, M, N)``, ``base_w (K, N) | None`` ->
    ``(BS, N)`` in ``x.dtype``; fp32 accumulation."""
    vals, k = compact_basis_inblock(x, grid)
    vals = vals.to(coeff.dtype).float()
    slabs = gather_coeff_slabs(coeff, k, grid.P).float()   # (BS, K, P+1, N)
    y = torch.einsum("bki,bkin->bn", vals, slabs)
    if base_w is not None:
        bw = base_w.to(coeff.dtype)
        xb = torch.clamp_min(x, 0).to(bw.dtype).float()
        y = y + xb @ bw.float()
    return y.to(x.dtype)


def kan_sparse_gemm_cuda(
    x: torch.Tensor, coeff: torch.Tensor, grid: SplineGrid,
    base_w: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors ``x (BS, K)`` (one launch)."""
    if base_w is not None:
        base_w = base_w.to(coeff.dtype).contiguous()
    check_operands(x, coeff, grid, base_w, MAX_M)
    BS, K = x.shape
    _, M, N = coeff.shape
    y = torch.empty((BS, N), dtype=x.dtype, device=x.device)
    if BS == 0:
        return y
    lib = build.load("kan_sparse_gemm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tickets, partial = workspace(lib, "kan_sparse_gemm", x.device, stream, BS, K, N)
    err = lib.kan_sparse_gemm(
        x.data_ptr(), coeff.data_ptr(),
        base_w.data_ptr() if base_w is not None else None,
        tickets.data_ptr(), partial.data_ptr(), y.data_ptr(),
        BS, K, N, M, grid.P, grid.t0, grid.delta,   # ctypes rounds to fp32
        DTYPE_CODES[x.dtype], DTYPE_CODES[coeff.dtype], stream,
    )
    build.check(err, "kan_sparse_gemm")
    return y


def kan_sparse_int8_gemm_reference(
    x_q: torch.Tensor, coeff_q: torch.Tensor, grid: SplineGrid,
    scale: torch.Tensor | None = None, qmax: int = 255, S: int = 256,
    lut_scale: int = 256, out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``x_q (BS, K)`` int, ``coeff_q (K, M, N)`` int8 values -> int32
    ``(BS, N)``, or ``out_dtype`` with ``scale (N,)``."""
    bvals, k = int8_compact_values_inblock(x_q, grid, S, qmax, lut_scale)
    slabs = gather_coeff_slabs(coeff_q, k, grid.P).to(torch.float64)
    acc = torch.einsum("bki,bkin->bn", bvals.to(torch.float64), slabs).to(torch.int32)
    return dequant_epilogue(acc, scale, out_dtype)


def kan_sparse_int8_gemm_cuda(
    x_q: torch.Tensor, coeff_q: torch.Tensor, grid: SplineGrid,
    scale: torch.Tensor | None = None, qmax: int = 255, S: int = 256,
    lut_scale: int = 256, out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors ``x_q (BS, K)`` (one launch)."""
    if scale is not None:
        scale = scale.to(torch.float32).reshape(-1).contiguous()
    check_int8_operands(x_q, coeff_q, grid, scale, out_dtype, S, qmax, MAX_M)
    BS, K = x_q.shape
    _, M, N = coeff_q.shape
    odt = torch.int32 if scale is None else out_dtype
    y = torch.empty((BS, N), dtype=odt, device=x_q.device)
    if BS == 0:
        return y
    table = rom_table(grid.P, S, lut_scale, x_q.device)
    lib = build.load("kan_sparse_int8_gemm")
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    tickets, sums = workspace(lib, "kan_sparse_int8_gemm", x_q.device, stream, BS, K, N)
    err = lib.kan_sparse_int8_gemm(
        x_q.data_ptr(), coeff_q.data_ptr(),
        scale.data_ptr() if scale is not None else None, table.data_ptr(),
        tickets.data_ptr(), sums.data_ptr(), y.data_ptr(),
        BS, K, N, M, grid.G, grid.P, S, qmax, OUT_CODES[odt], stream,
    )
    build.check(err, "kan_sparse_int8_gemm")
    return y
