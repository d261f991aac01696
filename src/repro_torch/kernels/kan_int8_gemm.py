"""Integer-only fused KAN GEMM: the int8 datapath of paper §III-B2 and §V.

Counterpart of ``repro/kernels/kan_int8_gemm.py`` (the Pallas TPU kernel
``_int8_kernel`` / ``kan_int8_gemm_pallas``): integer Align/Compare
(Eq. 5), the uint8 ROM values, the dense ``u8`` band, an int8 GEMM with
int32 accumulation and, given a per-channel ``scale``, the dequant epilogue
(``acc·scale`` rounded once into ``out_dtype``) in one launch.  Without
``scale`` it returns the int32 accumulator.

The CUDA kernel (``csrc/kan_int8_gemm.cu``) multiplies on the int8 tensor
cores and splits K across blocks where the output tiles are few, summing
the slices exactly with int32 atomics in a per-stream workspace
(:mod:`.workspace`).  It and the plain version read
the ROM, the paper's uint8 half-table ``build_lut_u8(P, S, lut_scale)``,
with the direct and inverted-address fetch, so their values are the
table's by construction (see
:func:`repro_torch.kernels.common.int8_compact_values_inblock` for the one
entry where the reference's kernels, which evaluate the table without
reading it, differ).  :func:`resolve_lut_scale` keeps the reference's
contract: the table must be ``build_lut_u8``'s at some integer value scale.

:func:`kan_int8_gemm_reference` is the plain PyTorch version: the band
materialised and one float64 matmul, exact for these integers (every
partial sum is below 2^53), cast to int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import bspline
from repro_torch.core.bspline import SplineGrid
from repro_torch.core.quantization import build_lut_u8, lut_value_scale
from repro_torch.kernels import build
from repro_torch.kernels import plan as pl
from repro_torch.kernels.common import band_scatter, int8_compact_values_inblock, rom_table
from repro_torch.kernels.workspace import workspace

SUPPORTED_P = (1, 2, 3)       # the degrees the int8 kernels are compiled for
MAX_M = 64                    # the dense-band kernel's widest band (256/M inputs per K step)
MAX_ROM_BYTES = 16384         # shared memory the kernels give the uint8 ROM
OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

# csrc/kan_int8_gemm.cu:68-73: rows per block, band bytes per K step, the
# shared row pitch, cp.async stages, codes tabulated
_BM, _W, _PITCH, _STAGES, _CODES = 64, 128, 144, 2, 256
STATIC_SMEM = 16              # .cu:225: ``last_s``, and the dynamic area's 16-byte alignment


def _layout_total(BN: int, BK: int, rom_bytes: int) -> int:   # .cu:84-102
    q = max(2, 32 // BK)
    xp = (q * BK + 6) // 4 * 4
    if (xp // 4) % 2 == 0:
        xp += 4
    bt = _STAGES * _W * BN + 2 * _BM * _PITCH
    xs = bt + BN * _PITCH
    tab = xs + 2 * _BM * xp * 4
    return tab + _CODES * 5 + pl.cdiv(rom_bytes, 16) * 16


def template_of(inst: int) -> tuple:
    """The instantiation ``inst`` (.cu:422-423) as ``kan_int8_kernel``'s
    template arguments ``(P, OUT, BN, VEC)``."""
    return (inst // 12 + 1, inst // 4 % 3, 128 if inst % 4 >= 2 else 64, inst % 2 == 1)


def launch_plan(BS: int, K: int, N: int, M: int, P: int, dtype: str = "int8", S: int = 256,
                out: int = 0, align: int = 16, sms: int = pl.SMS,
                per_sm: int | None = None) -> pl.Plan:
    """``kan_int8_gemm_plan`` (.cu:456-496) in Python: ``S`` the ROM's
    rows, ``out`` the output code (``OUT_CODES``), ``align`` C's address
    alignment.  ``per_sm`` None: the occupancy bound
    (``plan.occupancy_bound``) in place of the card's calculator.  x_q's
    16-byte reads start at the aligned element at or before each row's
    first input, so its row pitch is free; the launcher refuses an x_q
    address that is not 16-byte aligned (the wrapper copies one)."""
    half = (P + 2) // 2
    if not (1 <= P <= 3 and P < M <= MAX_M and S >= 2 and S * half <= MAX_ROM_BYTES
            and 0 <= out <= 2 and BS >= 1 and K >= 0 and N >= 1 and dtype == "int8"):
        return pl.Plan(error=pl.INVALID_VALUE)
    vec = N % 16 == 0 and align % 16 == 0
    BN = 64 if N <= 64 else 128                                # .cu:420 (tile_n)
    BK = min(_W // M, 32)
    smem = _layout_total(BN, BK, S * half)
    inst = ((P - 1) * 3 + out) * 4 + (BN == 128) * 2 + int(vec)
    if per_sm is None:
        per_sm = pl.occupancy_bound(2 * BN, smem + STATIC_SMEM)
    steps = pl.cdiv(K, BK)
    tiles = pl.cdiv(N, BN) * pl.cdiv(BS, _BM)
    splits = min(max(1, per_sm * sms // tiles), max(steps, 1))
    per_split = max(1, pl.cdiv(steps, splits))
    splits = max(1, pl.cdiv(steps, per_split))
    return pl.Plan(grid=(pl.cdiv(N, BN), pl.cdiv(BS, _BM), splits), threads=2 * BN, smem=smem,
                   grant=smem, vec=16 if vec else 1, inst=inst, sms=sms, per_sm=per_sm,
                   extra=(BN, BK, per_split), template=template_of(inst),
                   rows=((16 if vec else 1, N),))


def plan_export(lib, BS: int, K: int, N: int, M: int, P: int, dtype: str = "int8",
                S: int = 256, out: int = 0, align: int = 16) -> pl.Plan:
    """The library's own plan (``kan_int8_gemm_plan``), resident blocks
    per SM from the card's occupancy calculator."""
    return pl.read_export(lib.kan_int8_gemm_plan, [BS, K, N, M, P, S, out, align],
                          template_of)


def threads_of(template: tuple) -> int:
    """``__launch_bounds__(2 * BN, ...)`` (.cu:216)."""
    return 2 * template[2]


@functools.lru_cache(maxsize=8)
def _max_cardinal(P: int) -> float:
    return float(bspline.cardinal_bspline(torch.tensor((P + 1) / 2.0), P))


@functools.lru_cache(maxsize=32)
def _reference_lut(P: int, S: int, scale: int) -> np.ndarray:
    return build_lut_u8(P, S, scale)


def resolve_lut_scale(lut_u8, grid: SplineGrid, S: int) -> int:
    """The integer value scale of ``lut_u8``, which must equal
    ``build_lut_u8(P, S, scale)`` (the kernels reproduce that table and no
    other).  Reads the table on the host.  Raises ``ValueError`` for any
    other table."""
    default = lut_value_scale(grid.P)
    concrete = (lut_u8.detach().cpu().numpy() if isinstance(lut_u8, torch.Tensor)
                else np.asarray(lut_u8))
    inferred = int(round(float(concrete.max()) / _max_cardinal(grid.P)))
    for scale in dict.fromkeys((default, inferred, inferred - 1, inferred + 1)):
        if scale > 0 and np.array_equal(concrete, _reference_lut(grid.P, S, scale)):
            return scale
    raise ValueError(
        "kan_int8_gemm computes the build_lut_u8 ROM; the given table matches "
        "no integer value scale, and arbitrary LUT tables are not supported")


def dequant_epilogue(acc: torch.Tensor, scale: torch.Tensor | None,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """``acc`` (int32) as is, or ``acc·scale`` in float32 rounded once
    (nearest even) into ``out_dtype``."""
    if scale is None:
        return acc
    return (acc.to(torch.float32) * scale.to(torch.float32).reshape(1, -1)).to(out_dtype)


def kan_int8_gemm_reference(
    x_q: torch.Tensor, coeff_q: torch.Tensor, grid: SplineGrid,
    scale: torch.Tensor | None = None, qmax: int = 255, S: int = 256,
    lut_scale: int = 256, out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``x_q (BS, K)`` int, ``coeff_q (K, M, N)`` int8 values -> int32
    ``(BS, N)``, or ``out_dtype`` with ``scale (N,)``."""
    BS, K = x_q.shape
    _, M, N = coeff_q.shape
    bvals, k = int8_compact_values_inblock(x_q, grid, S, qmax, lut_scale)
    # float64: exact integer sums (every partial sum is below 2^53)
    band = band_scatter(bvals.to(torch.float64), k, M)  # kanlint: ignore[KL103]
    c64 = coeff_q.to(torch.float64)  # kanlint: ignore[KL103]
    acc = (band.reshape(BS, K * M) @ c64.reshape(K * M, N)).to(torch.int32)
    return dequant_epilogue(acc, scale, out_dtype)


def rom_probe(grid: SplineGrid, S: int) -> tuple[torch.Tensor, int, torch.Tensor]:
    """Operands under which an int8 kernel reads every ROM address and
    returns the values it read: ``(x_q (R, 1) int32, qmax, coeff_q (1, M, M)
    int8)``.  With ``coeff_q`` the identity, row ``r`` of the accumulator
    is input ``r``'s dense band.  ``qmax = (G+2P)(S-1) + 1`` is coprime to
    ``G+2P`` and makes each address bucket wider than the step of ``u``, so
    the codes ``x_q`` from below ``t0`` to past ``t_last`` reach every one
    of the ``S`` addresses (the last through the clip at ``qmax``)."""
    c = grid.G + 2 * grid.P
    qmax = c * (S - 1) + 1
    x_q = torch.arange(-2, (grid.n_basis + 1) * qmax // c + 3, dtype=torch.int32)[:, None]
    coeff = torch.eye(grid.n_basis, dtype=torch.int8)[None]
    return x_q, qmax, coeff


def check_int8_operands(x_q, coeff_q, grid, scale, out_dtype, S, qmax, max_m) -> None:
    """Raise on what an int8 CUDA kernel compiled for ``M <= max_m`` does
    not take."""
    if x_q.dim() != 2 or coeff_q.dim() != 3:
        raise ValueError(f"x_q must be (BS, K) and coeff_q (K, M, N); got "
                         f"{tuple(x_q.shape)} and {tuple(coeff_q.shape)}")
    K = x_q.shape[1]
    Kc, M, N = coeff_q.shape
    if Kc != K or M != grid.n_basis:
        raise ValueError(f"coeff_q {tuple(coeff_q.shape)} does not match x_q "
                         f"{tuple(x_q.shape)} and M={grid.n_basis}")
    if grid.P not in SUPPORTED_P or M > max_m:
        raise ValueError(f"the CUDA kernel is compiled for P in {SUPPORTED_P} and "
                         f"M=G+P <= {max_m}; got P={grid.P}, M={M}")
    if S * grid.half_cols() > MAX_ROM_BYTES or S < 2:
        raise ValueError(f"a ROM of S={S} rows does not fit the kernel's "
                         f"{MAX_ROM_BYTES} bytes of shared memory")
    if qmax < 1:
        raise ValueError(f"qmax must be positive; got {qmax}")
    if x_q.dtype != torch.int32 or coeff_q.dtype != torch.int8:
        raise ValueError(f"x_q must be int32 and coeff_q int8; got {x_q.dtype}, "
                         f"{coeff_q.dtype}")
    tensors = [x_q, coeff_q] + ([scale] if scale is not None else [])
    for t in tensors:
        if t.device != x_q.device:
            raise ValueError("x_q, coeff_q and scale must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if scale is not None:
        if scale.dtype != torch.float32 or scale.numel() != N:
            raise ValueError(f"scale must be float32 with {N} values")
        if out_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"out_dtype {out_dtype} not supported (float32, bfloat16)")


def kan_int8_gemm_cuda(
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
    if x_q.data_ptr() % 16:              # the kernel reads x_q in 16-byte chunks
        x_q = x_q.clone()
    table = rom_table(grid.P, S, lut_scale, x_q.device)
    lib = build.load("kan_int8_gemm")
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    tickets, sums = workspace(lib, "kan_int8_gemm", x_q.device, stream, BS, K, N)
    err = lib.kan_int8_gemm(
        x_q.data_ptr(), coeff_q.data_ptr(),
        scale.data_ptr() if scale is not None else None, table.data_ptr(),
        tickets.data_ptr(), sums.data_ptr(), y.data_ptr(),
        BS, K, N, M, grid.G, grid.P, S, qmax, OUT_CODES[odt], stream,
    )
    build.check(err, "kan_int8_gemm")
    return y
