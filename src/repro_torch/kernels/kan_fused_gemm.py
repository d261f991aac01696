"""Fused KAN GEMM: ``Y = B(x) @ C + ReLU(x) @ Wb`` in one kernel launch.

Counterpart of ``repro/kernels/kan_fused_gemm.py`` (the Pallas TPU kernel
``_fused_kernel`` / ``kan_fused_gemm_pallas``).  The CUDA kernel
(``csrc/kan_fused_gemm.cu``) builds the dense ``(rows, K*M)`` B-spline band
in shared memory from the raw x tile, never in device memory, and folds
the base term into the same band (ReLU(x) columns against the rows of Wb),
so one fp32 inner loop covers both.  Its source note states its bound; its
tiles are fixed (128 x 128 outputs; 128 x 64 where N <= 64, 128 x 256
where N >= 256; 36/(M+1) inputs per K step; spline degree P in {1, 2,
3}), and it splits K across
blocks where the output tiles are few, summing the fp32 slices in slice
order in a per-stream workspace (:mod:`.workspace`), so two calls give
the same bits.

:func:`kan_fused_gemm_reference` is the plain PyTorch version of the same
function: the dense band materialised, then one matmul.  It runs on any
device; the CPU tests use it and ``chip_smoke.py`` holds the kernel against
it on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.bspline import SplineGrid
from repro_torch.kernels import build
from repro_torch.kernels import plan as pl
from repro_torch.kernels.common import band_scatter, compact_basis_inblock
from repro_torch.kernels.workspace import workspace

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_P = (1, 2, 3)       # the spline degrees both .cu files are compiled for
MAX_M = 64                    # largest M = G+P of the fused kernel

# csrc/kan_fused_gemm.cu:64-67: rows per block, band columns per K step,
# cp.async stages, slices at most
_BM, _KW, _STAGES, _MAX_SPLITS = 128, 36, 3, 32
_TILE_KINDS = ((64, False), (64, True), (128, False), (128, True), (256, True))


def _tile_n(N: int, M: int, vec: bool) -> int:          # .cu:292-294
    return 64 if N <= 64 else (256 if N >= 256 and vec and M <= 35 else 128)


def _tiles(BS: int, N: int, BN: int) -> int:            # .cu:295
    return pl.cdiv(N, BN) * pl.cdiv(BS, _BM)


def _max_splits(BS: int, N: int, BN: int, sms: int) -> int:   # .cu:299-301
    return max(1, min(_MAX_SPLITS, 256 // BN * sms // _tiles(BS, N, BN)))


def template_of(inst: int) -> tuple:
    """The instantiation ``inst`` (.cu:303-307) as ``kan_fused_kernel``'s
    template arguments ``(TX, TC, P, BN, VEC)``."""
    BN, vec = _TILE_KINDS[inst % 5]
    dt = inst // 15
    return (pl.dtype_name(dt // 2), pl.dtype_name(dt % 2), inst // 5 % 3 + 1, BN, vec)


def launch_plan(BS: int, K: int, N: int, M: int, P: int, dtype: str = "float32",
                x_dtype: str | None = None, align: int = 16, sms: int = pl.SMS,
                per_sm: int | None = None) -> pl.Plan:
    """``kan_fused_gemm_plan`` (.cu:346-387) in Python: ``dtype`` is C's
    (and Wb's), ``x_dtype`` x's (default: C's), ``align`` the smallest
    address alignment of C and Wb.  ``per_sm`` None: the occupancy bound
    (``plan.occupancy_bound``) in place of the card's calculator, so the
    slices are at most the card's (and ``_MAX_SPLITS``)."""
    xd = pl.DTYPE_CODES.get(x_dtype or dtype, -1)
    cd = pl.DTYPE_CODES.get(dtype, -1)
    if not (1 <= P <= 3 and P < M <= MAX_M and BS >= 1 and K >= 0 and N >= 1
            and xd >= 0 and cd >= 0):
        return pl.Plan(error=pl.INVALID_VALUE)
    esize = pl.ESIZE[dtype]
    vec = N % (16 // esize) == 0 and align % 16 == 0
    BN = _tile_n(N, M, vec)
    BK = max(1, _KW // (M + 1))
    W = BK * (M + 1)
    inst = ((xd * 2 + cd) * 3 + P - 1) * 5 + _TILE_KINDS.index((BN, vec))
    smem = _STAGES * W * BN * esize + 2 * W * _BM * 4
    if per_sm is None:
        per_sm = pl.occupancy_bound(2 * BN, smem + STATIC_SMEM)
    steps = pl.cdiv(K, BK)
    splits = min(max(1, per_sm * sms // _tiles(BS, N, BN)), _max_splits(BS, N, BN, sms))
    splits = min(splits, max(steps, 1))
    per_split = max(1, pl.cdiv(steps, splits))
    splits = max(1, pl.cdiv(steps, per_split))
    return pl.Plan(grid=(pl.cdiv(N, BN), pl.cdiv(BS, _BM), splits), threads=2 * BN,
                   smem=smem, grant=smem, vec=16 if vec else esize, inst=inst, sms=sms,
                   per_sm=per_sm, extra=(BN, BK, per_split), template=template_of(inst),
                   rows=((16 if vec else esize, N * esize),))


def plan_export(lib, BS: int, K: int, N: int, M: int, P: int, dtype: str = "float32",
                x_dtype: str | None = None, align: int = 16) -> pl.Plan:
    """The library's own plan (``kan_fused_gemm_plan``), resident blocks
    per SM from the card's occupancy calculator."""
    args = [BS, K, N, M, P, pl.DTYPE_CODES[x_dtype or dtype], pl.DTYPE_CODES[dtype], align]
    return pl.read_export(lib.kan_fused_gemm_plan, args, template_of)


STATIC_SMEM = 16              # .cu:155: ``last_s``, and the dynamic area's 16-byte alignment


def threads_of(template: tuple) -> int:
    """``__launch_bounds__(2 * BN, ...)`` (.cu:144)."""
    return 2 * template[3]


def kan_fused_gemm_reference(
    x: torch.Tensor, coeff: torch.Tensor, grid: SplineGrid,
    base_w: torch.Tensor | None = None,
) -> torch.Tensor:
    """``x (BS, K)``, ``coeff (K, M, N)``, ``base_w (K, N) | None`` ->
    ``(BS, N)`` in ``x.dtype``; fp32 accumulation, basis rounded to
    ``coeff.dtype`` as the kernel does."""
    BS, K = x.shape
    _, M, N = coeff.shape
    vals, k = compact_basis_inblock(x, grid)
    band = band_scatter(vals, k, M).to(coeff.dtype).float().reshape(BS, K * M)
    y = band @ coeff.float().reshape(K * M, N)
    if base_w is not None:
        bw = base_w.to(coeff.dtype)
        xb = torch.clamp_min(x, 0).to(bw.dtype).float()
        y = y + xb @ bw.float()
    return y.to(x.dtype)


def check_operands(x, coeff, grid, base_w, max_m: int) -> None:
    """Raise on what a CUDA kernel compiled for ``M <= max_m`` does not take."""
    if x.dim() != 2 or coeff.dim() != 3:
        raise ValueError(f"x must be (BS, K) and coeff (K, M, N); got "
                         f"{tuple(x.shape)} and {tuple(coeff.shape)}")
    BS, K = x.shape
    Kc, M, N = coeff.shape
    if Kc != K or M != grid.n_basis:
        raise ValueError(f"coeff {tuple(coeff.shape)} does not match x "
                         f"{tuple(x.shape)} and M={grid.n_basis}")
    if grid.P not in SUPPORTED_P or M > max_m:
        raise ValueError(f"the CUDA kernel is compiled for P in {SUPPORTED_P} and "
                         f"M=G+P <= {max_m}; got P={grid.P}, M={M}")
    tensors = [x, coeff] + ([base_w] if base_w is not None else [])
    for t in tensors:
        if t.device != x.device:
            raise ValueError("x, coeff and base_w must be on one device")
        if t.dtype not in DTYPE_CODES:
            raise ValueError(f"dtype {t.dtype} not supported (float32, bfloat16)")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if base_w is not None and tuple(base_w.shape) != (K, N):
        raise ValueError(f"base_w {tuple(base_w.shape)} != {(K, N)}")


def kan_fused_gemm_cuda(
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
    lib = build.load("kan_fused_gemm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tickets, partial = workspace(lib, "kan_fused_gemm", x.device, stream, BS, K, N)
    err = lib.kan_fused_gemm(
        x.data_ptr(), coeff.data_ptr(),
        base_w.data_ptr() if base_w is not None else None,
        tickets.data_ptr(), partial.data_ptr(), y.data_ptr(),
        BS, K, N, M, grid.P, grid.t0, grid.delta,   # ctypes rounds to fp32
        DTYPE_CODES[x.dtype], DTYPE_CODES[coeff.dtype], stream,
    )
    build.check(err, "kan_fused_gemm")
    return y
