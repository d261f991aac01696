"""The tabulated B-spline unit (paper §III-B, Fig. 5).

Counterpart of ``repro/kernels/bspline_lut.py`` (the Pallas TPU kernel
``_bspline_lut_kernel`` / ``bspline_lut_pallas``): for each input, the
Align unit ``z = (x - t0)/delta`` (a true division), the Compare unit
``k = clamp(floor z, P, M-1)``, the address ``round(x_a·(S-1))`` (half to
even) of the in-interval offset, and the ``P+1`` non-zero values from the
half-table by the direct and inverted-address fetch -> ``(vals, k)``.

The CUDA kernel (``csrc/bspline_lut.cu``) keeps the float table in shared
memory and reads it with direct indexed loads (the TPU kernel's one-hot
matmul is how an MXU reads a table, not part of the function); one thread
per input.  It takes float32 inputs and tables, ``P in {1, 2, 3}``.  Its
plain version is :func:`repro_torch.core.bspline.lut_basis_compact`.
"""

from __future__ import annotations

import torch

from repro_torch.core.bspline import SplineGrid, lut_basis_compact
from repro_torch.kernels import build
from repro_torch.kernels import plan as pl

SUPPORTED_P = (1, 2, 3)
MAX_TABLE_BYTES = 200 * 1024      # dynamic shared memory the kernel may ask for
_THREADS = 256                    # csrc/bspline_lut.cu:26
STATIC_SMEM = 0


def launch_plan(n: int, S: int, P: int, sms: int = pl.SMS,
                per_sm: int | None = None) -> pl.Plan:
    """``bspline_lut_plan`` (csrc/bspline_lut.cu:67-80) in Python: ``n``
    inputs, a float table of ``S`` rows."""
    if S < 2 or n < 0 or P not in SUPPORTED_P:
        return pl.Plan(error=pl.INVALID_VALUE)
    half = (P + 2) // 2
    smem = 4 * S * half
    return pl.Plan(grid=(pl.cdiv(n, _THREADS), 1, 1), threads=_THREADS, smem=smem, grant=smem,
                   vec=4, inst=P - 1, template=(P,), rows=((4, 4 * half),))


def plan_export(lib, n: int, S: int, P: int) -> pl.Plan:
    """The library's own plan (``bspline_lut_plan``)."""
    return pl.read_export(lib.bspline_lut_plan, [n, S, P], lambda inst: (inst + 1,))


def threads_of(template: tuple) -> int:
    """``__launch_bounds__(kThreads)`` (.cu:29)."""
    return _THREADS


def bspline_lut_reference(
    x: torch.Tensor, lut: torch.Tensor, grid: SplineGrid
) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (n,)`` -> ``(vals (n, P+1) in x.dtype, k (n,) int32)``."""
    vals, k = lut_basis_compact(x, grid, lut)
    return vals.to(x.dtype), k


def bspline_lut_cuda(
    x: torch.Tensor, lut: torch.Tensor, grid: SplineGrid
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors ``x (n,)`` (one launch)."""
    if x.dim() != 1 or lut.dim() != 2:
        raise ValueError(f"x must be (n,) and lut (S, half); got {tuple(x.shape)}, "
                         f"{tuple(lut.shape)}")
    S, half = lut.shape
    if grid.P not in SUPPORTED_P or half != grid.half_cols() or S < 2:
        raise ValueError(f"the CUDA kernel is compiled for P in {SUPPORTED_P} with a "
                         f"(S >= 2, {grid.half_cols()}) table; got P={grid.P}, "
                         f"lut {tuple(lut.shape)}")
    if S * half * 4 > MAX_TABLE_BYTES:
        raise ValueError(f"a table of {S} rows does not fit {MAX_TABLE_BYTES} bytes "
                         f"of shared memory")
    if x.dtype != torch.float32 or lut.dtype != torch.float32:
        raise ValueError(f"x and lut must be float32; got {x.dtype}, {lut.dtype}")
    if lut.device != x.device or not (x.is_contiguous() and lut.is_contiguous()):
        raise ValueError("x and lut must be contiguous and on one device")
    n = x.shape[0]
    vals = torch.empty((n, grid.P + 1), dtype=torch.float32, device=x.device)
    k = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return vals, k
    lib = build.load("bspline_lut")
    err = lib.bspline_lut(
        x.data_ptr(), lut.data_ptr(), vals.data_ptr(), k.data_ptr(), n, S, grid.P,
        grid.n_basis, grid.t0, grid.delta,            # ctypes rounds to fp32
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "bspline_lut")
    return vals, k
