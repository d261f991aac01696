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
from repro_torch.kernels.common import band_scatter, compact_basis_inblock
from repro_torch.kernels.workspace import workspace

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_P = (1, 2, 3)       # the spline degrees both .cu files are compiled for
MAX_M = 64                    # largest M = G+P of the fused kernel


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
