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
from repro_torch.kernels import plan as pl
from repro_torch.kernels.common import (
    compact_basis_inblock, gather_coeff_slabs, int8_compact_values_inblock, rom_table)
from repro_torch.kernels.kan_fused_gemm import DTYPE_CODES, check_operands
from repro_torch.kernels.kan_int8_gemm import OUT_CODES, check_int8_operands, dequant_epilogue
from repro_torch.kernels.workspace import workspace

MAX_M = 16                    # the widest M both sparse kernels are compiled for
MAX_ROM_BYTES = 16384         # csrc/kan_sparse_int8_gemm.cu:344: the ROM's shared memory

# csrc/kan_sparse_gemm.cu:70-80: rows per block, threads, the smallest TQ,
# staged bytes at most, blocks per SM targeted, column tiles targeted, the
# lane group, slices at most, rounds at most
_ROWS, _THREADS, _MIN_TQ, _MAX_STAGE_BYTES = 8, 256, 4, 96 * 1024
_BLOCKS_PER_SM, _TILES_TARGET, _LANE_GROUP, _MAX_SLICES, _MAX_ROUNDS = 2, 16, 8, 16, 2
_UNITS = (16, 4, 2)           # .cu:401-403: the copy units, by instantiation
STATIC_SMEM = 16              # .cu:190 (float), kan_sparse_int8_gemm.cu:153: ``last_s``, aligned


def _split(BS: int, K: int, N: int, M: int, esize: int, sms: int) -> tuple:
    """.cu:84-112 (``tile_quads``, ``split``) -> (TQ, tiles_n, row_blocks, JS, slices)."""
    V = 16 // esize
    TQ = _MIN_TQ
    while TQ < 32 and TQ * V * _TILES_TARGET < N:
        TQ *= 2
    CT, TJ = V * TQ, _THREADS // TQ
    tiles_n, row_blocks = pl.cdiv(N, CT), pl.cdiv(BS, _ROWS)
    want = max(1, _BLOCKS_PER_SM * sms // tiles_n)
    js = max(pl.cdiv(K, want), pl.cdiv(K, _MAX_SLICES))
    if js > TJ:
        js = pl.cdiv(js, TJ) * TJ
    cap = max(TJ, min(_MAX_ROUNDS * TJ, _MAX_STAGE_BYTES // ((M + 1) * CT * esize)) // TJ * TJ)
    JS = min(js, cap)
    return TQ, tiles_n, row_blocks, JS, max(1, pl.cdiv(K, JS))


def _layout_total(TQ: int, JS: int, M: int, esize: int) -> int:   # .cu:120-127
    CT, TJ = 16 // esize * TQ, _THREADS // TQ
    area = pl.cdiv(max(JS * (M + 1) * CT * esize,
                       (TJ + TJ // _LANE_GROUP) * _ROWS * CT * 4), 16) * 16
    return area + _ROWS * JS * 24


def template_of(inst: int) -> tuple:
    """The instantiation ``inst`` (.cu:401-404) as ``kan_sparse_kernel``'s
    template arguments ``(TX, TC, P, U)``."""
    dt = inst // 9
    return (pl.dtype_name(dt // 2), pl.dtype_name(dt % 2), inst // 3 % 3 + 1, _UNITS[inst % 3])


def launch_plan(BS: int, K: int, N: int, M: int, P: int, dtype: str = "float32",
                x_dtype: str | None = None, align: int = 16, sms: int = pl.SMS,
                per_sm: int | None = None) -> pl.Plan:
    """``kan_sparse_gemm_plan`` (.cu:437-464) in Python: ``dtype`` is C's,
    ``align`` the smallest address alignment of C and Wb.  The split takes
    the SM count, not the occupancy (``per_sm`` is not used)."""
    xd = pl.DTYPE_CODES.get(x_dtype or dtype, -1)
    cd = pl.DTYPE_CODES.get(dtype, -1)
    if not (1 <= P <= 3 and P < M <= MAX_M and K >= 1 and BS >= 1 and N >= 1
            and xd >= 0 and cd >= 0):
        return pl.Plan(error=pl.INVALID_VALUE)
    esize = pl.ESIZE[dtype]
    TQ, tiles_n, row_blocks, JS, slices = _split(BS, K, N, M, esize, sms)
    u = next((i for i, b in enumerate(_UNITS[:2]) if (N * esize) % b == 0 and align % b == 0),
             2)
    if u == 2 and esize == 4:
        return pl.Plan(error=pl.MISALIGNED_ADDRESS)
    smem = _layout_total(TQ, JS, M, esize)
    inst = ((xd * 2 + cd) * 3 + P - 1) * 3 + u
    return pl.Plan(grid=(tiles_n * row_blocks, slices, 1), threads=_THREADS, smem=smem,
                   grant=smem, vec=_UNITS[u], inst=inst, sms=sms,
                   extra=(TQ, JS, tiles_n, row_blocks), template=template_of(inst),
                   rows=((_UNITS[u], N * esize),))


def plan_export(lib, BS: int, K: int, N: int, M: int, P: int, dtype: str = "float32",
                x_dtype: str | None = None, align: int = 16) -> pl.Plan:
    """The library's own plan (``kan_sparse_gemm_plan``)."""
    args = [BS, K, N, M, P, pl.DTYPE_CODES[x_dtype or dtype], pl.DTYPE_CODES[dtype], align]
    return pl.read_export(lib.kan_sparse_gemm_plan, args, template_of)


# csrc/kan_sparse_int8_gemm.cu:69-74: rows per block, threads, inputs per
# slice at most, staged coefficient bytes at most, blocks per SM targeted
_ROWS8, _THREADS8, _MAX_JS8, _MAX_COEFF8, _BLOCKS_PER_SM8 = 8, 256, 64, 24576, 2


def int8_template_of(inst: int) -> tuple:
    """The instantiation ``inst`` (.cu:318-319) as
    ``kan_sparse_int8_kernel``'s template arguments ``(P, VEC)``."""
    return (inst // 2 + 1, inst % 2 == 1)


def int8_launch_plan(BS: int, K: int, N: int, M: int, P: int, dtype: str = "int8",
                     S: int = 256, align: int = 16, sms: int = pl.SMS,
                     per_sm: int | None = None) -> pl.Plan:
    """``kan_sparse_int8_gemm_plan`` (kan_sparse_int8_gemm.cu:341-364) in
    Python (``split``: .cu:79-83, 302-316; ``area_bytes``: .cu:87-89);
    ``S`` the ROM's rows, ``align`` C's address alignment."""
    half = (P + 2) // 2
    if not (1 <= P <= 3 and P < M <= MAX_M and S >= 2 and S * half <= MAX_ROM_BYTES
            and BS >= 1 and K >= 1 and N >= 1 and dtype == "int8"):
        return pl.Plan(error=pl.INVALID_VALUE)
    TQ = _THREADS8 // _MAX_JS8
    while TQ < 32 and 4 * TQ < N:
        TQ *= 2
    CT, TJ = 4 * TQ, _THREADS8 // TQ
    tiles_n, row_blocks = pl.cdiv(N, CT), pl.cdiv(BS, _ROWS8)
    want = max(1, _BLOCKS_PER_SM8 * sms // (tiles_n * row_blocks))
    js = pl.cdiv(pl.cdiv(K, want), TJ) * TJ
    cap = max(TJ, min(_MAX_JS8, _MAX_COEFF8 // (M * CT)) // TJ * TJ)
    JS = min(js, cap)
    area = pl.cdiv(max(JS * M * CT, TJ * _ROWS8 * CT * 4), 16) * 16
    smem = area + _ROWS8 * JS * 8 + pl.cdiv(S * half, 16) * 16
    vec = N % 16 == 0 and align % 16 == 0
    inst = (P - 1) * 2 + int(vec)
    return pl.Plan(grid=(tiles_n * row_blocks, pl.cdiv(K, JS), 1), threads=_THREADS8,
                   smem=smem, grant=smem, vec=16 if vec else 1, inst=inst, sms=sms,
                   extra=(TQ, JS, tiles_n), template=int8_template_of(inst),
                   rows=((16 if vec else 1, N),))


def int8_plan_export(lib, BS: int, K: int, N: int, M: int, P: int, dtype: str = "int8",
                     S: int = 256, align: int = 16) -> pl.Plan:
    """The library's own plan (``kan_sparse_int8_gemm_plan``)."""
    return pl.read_export(lib.kan_sparse_int8_gemm_plan, [BS, K, N, M, P, S, align],
                          int8_template_of)


def threads_of(template: tuple) -> int:
    """Both sparse kernels: ``__launch_bounds__(kThreads ...)`` (.cu:183,
    kan_sparse_int8_gemm.cu:146)."""
    return _THREADS

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
    # float64: exact integer sums (every partial sum is below 2^53)
    slabs = gather_coeff_slabs(coeff_q, k, grid.P).to(torch.float64)  # kanlint: ignore[KL103]
    acc = torch.einsum("bki,bkin->bn", bvals.to(torch.float64),  # kanlint: ignore[KL103]
                       slabs).to(torch.int32)
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
