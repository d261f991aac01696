"""Public wrappers for the kernels (counterpart of ``repro/kernels/ops.py``).

Each KAN wrapper flattens the leading dims of ``x`` and then:

* for a tensor on the CPU, runs the kernel's plain PyTorch version;
* for a CUDA tensor, launches the hand-written CUDA kernel (building it at
  first use) or raises.  There is no fallback.

Tiles are the kernels' fixed defaults (see each ``csrc/*.cu``); the JAX
package's tile autotuner is not ported yet.  ``LAUNCHES`` counts kernel
launches per kernel, so a run can show that its main path went through the
kernels: a wrapper adds one exactly where it launches, never on the CPU.
The block-table gather of the paged KV cache (:func:`gather_views`, one
launch for every leaf of a cache, and :func:`gather_blocks`), the
integer KAN GEMMs (:func:`kan_int8_gemm`, :func:`kan_sparse_int8_gemm`) and
the tabulated B-spline unit (:func:`bspline_lut`) follow the same rule.
"""

from __future__ import annotations

import torch

from repro_torch.core.bspline import SplineGrid
from repro_torch.kernels import bspline_lut as _lut
from repro_torch.kernels import kan_fused_gemm as _fused
from repro_torch.kernels import kan_int8_gemm as _int8
from repro_torch.kernels import kan_sparse_gemm as _sparse
from repro_torch.kernels import paged_gather as _gather
from repro_torch.kernels.spills import SPILLS

# Registered CUDA libraries, for the kernel-config lint
# (``repro_torch.analysis.kernel_configs``; the counterpart of
# ``repro/kernels/ops.py: KERNELS``): per library in ``build.LIBRARIES``,
# the kernel's symbol, the dtypes, spline degrees and largest M its
# wrapper's checks admit, its static shared memory at most (``last_s`` and
# the dynamic area's alignment), its threads per block by instantiation
# (the ``__launch_bounds__``), its launcher's plan in Python
# (``launch_plan``) beside the library's own (``plan_export``), and the
# bytes each of its instantiations spills (``kernels/spills.py``; a new or
# larger spill fails the lint).  A library without an entry here fails the
# lint's coverage check (KL204).
KERNELS: dict[str, dict] = {
    "kan_fused_gemm": {
        "spills": SPILLS["kan_fused_gemm"],
        "symbol": "kan_fused_kernel", "dtypes": ("float32", "bfloat16"),
        "P": _fused.SUPPORTED_P, "max_m": _fused.MAX_M, "static_smem": _fused.STATIC_SMEM,
        "threads": _fused.threads_of, "plan": _fused.launch_plan,
        "plan_export": _fused.plan_export,
    },
    "kan_sparse_gemm": {
        "spills": SPILLS["kan_sparse_gemm"],
        "symbol": "kan_sparse_kernel", "dtypes": ("float32", "bfloat16"),
        "P": _fused.SUPPORTED_P, "max_m": _sparse.MAX_M, "static_smem": _sparse.STATIC_SMEM,
        "threads": _sparse.threads_of, "plan": _sparse.launch_plan,
        "plan_export": _sparse.plan_export,
    },
    "kan_sparse_int8_gemm": {
        "spills": SPILLS["kan_sparse_int8_gemm"],
        "symbol": "kan_sparse_int8_kernel", "dtypes": ("int8",),
        "P": _int8.SUPPORTED_P, "max_m": _sparse.MAX_M, "static_smem": _sparse.STATIC_SMEM,
        "threads": _sparse.threads_of, "plan": _sparse.int8_launch_plan,
        "plan_export": _sparse.int8_plan_export,
    },
    "kan_int8_gemm": {
        "spills": SPILLS["kan_int8_gemm"],
        "symbol": "kan_int8_kernel", "dtypes": ("int8",),
        "P": _int8.SUPPORTED_P, "max_m": _int8.MAX_M, "static_smem": _int8.STATIC_SMEM,
        "threads": _int8.threads_of, "plan": _int8.launch_plan,
        "plan_export": _int8.plan_export,
    },
    "paged_gather": {
        "spills": SPILLS["paged_gather"],
        "symbol": "paged_gather_kernel", "dtypes": ("float32", "bfloat16", "float16", "int8",
                                                    "uint8"),
        "max_leaves": _gather.MAX_LEAVES, "static_smem": _gather.STATIC_SMEM,
        "threads": _gather.threads_of, "plan": _gather.launch_plan,
        "plan_export": _gather.plan_export,
    },
    "bspline_lut": {
        "spills": SPILLS["bspline_lut"],
        "symbol": "bspline_lut_kernel", "dtypes": ("float32",), "P": _lut.SUPPORTED_P,
        "max_table_bytes": _lut.MAX_TABLE_BYTES, "static_smem": _lut.STATIC_SMEM,
        "threads": _lut.threads_of, "plan": _lut.launch_plan, "plan_export": _lut.plan_export,
    },
}

LAUNCHES: dict[str, int] = {
    "kan_fused_gemm": 0, "kan_sparse_gemm": 0, "gather_blocks": 0,
    "kan_int8_gemm": 0, "kan_sparse_int8_gemm": 0, "bspline_lut": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _apply(name, plain, cuda, x, coeff, grid, base_w) -> torch.Tensor:
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.device.type == "cpu":
        y = plain(x2, coeff, grid, base_w)
    else:
        y = cuda(x2, coeff, grid, base_w)
        LAUNCHES[name] += 1
    return y.reshape(lead + (coeff.shape[-1],))


def kan_fused_gemm(
    x: torch.Tensor, coeff: torch.Tensor, grid: SplineGrid,
    base_w: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused KAN layer (Eq. 1): spline term + optional base term in ONE
    launch.  ``x (..., K)``, ``coeff (K, M, N)`` -> ``(..., N)``."""
    return _apply("kan_fused_gemm", _fused.kan_fused_gemm_reference,
                  _fused.kan_fused_gemm_cuda, x, coeff, grid, base_w)


def kan_sparse_gemm(
    x: torch.Tensor, coeff: torch.Tensor, grid: SplineGrid,
    base_w: torch.Tensor | None = None,
) -> torch.Tensor:
    """Compact N:M sparse KAN layer (paper §IV-A), the decode path: spline
    term + optional base term in ONE launch.  ``x (..., K)`` -> ``(..., N)``."""
    return _apply("kan_sparse_gemm", _sparse.kan_sparse_gemm_reference,
                  _sparse.kan_sparse_gemm_cuda, x, coeff, grid, base_w)


def gather_views(cache: dict, table: torch.Tensor, stacked: bool = False) -> dict:
    """Block-table gather of every leaf of a paged KV cache
    (``kernels/paged_gather.py``) in ONE launch: ``cache`` maps names to
    pools ``(n_blocks, bs, ...)`` or, ``stacked``, ``(layers, n_blocks, bs,
    ...)`` (at most ``MAX_LEAVES``), ``table (B, L)`` int32 -> the same
    names mapped to their logical views.  On the CPU, the plain version per
    leaf."""
    if all(p.device.type == "cpu" for p in cache.values()):
        return _gather.gather_views_reference(cache, table, stacked)
    views = _gather.gather_views_cuda(list(cache.values()), table, stacked)
    if any(v.numel() for v in views):
        LAUNCHES["gather_blocks"] += 1
    return dict(zip(cache, views))


def gather_blocks(pool: torch.Tensor, table: torch.Tensor,
                  stacked: bool = False) -> torch.Tensor:
    """:func:`gather_views` of one pool: ``(n_blocks, bs, ...)`` or,
    ``stacked``, ``(layers, n_blocks, bs, ...)``, ``table (B, L)`` int32 ->
    the logical view."""
    return gather_views({"pool": pool}, table, stacked)["pool"]


def _apply_int8(name, plain, cuda, x_q, lut_u8, coeff_q, grid, scale, qmax, lut_scale,
                out_dtype) -> torch.Tensor:
    if lut_scale is None:
        lut_scale = _int8.resolve_lut_scale(lut_u8, grid, lut_u8.shape[0])
    lead = x_q.shape[:-1]
    x2 = x_q.reshape(-1, x_q.shape[-1]).to(torch.int32).contiguous()
    kw = dict(scale=scale, qmax=qmax, S=lut_u8.shape[0], lut_scale=lut_scale,
              out_dtype=out_dtype)
    if x2.device.type == "cpu":
        y = plain(x2, coeff_q, grid, **kw)
    else:
        y = cuda(x2, coeff_q.to(torch.int8).contiguous(), grid, **kw)
        LAUNCHES[name] += 1
    return y.reshape(lead + (coeff_q.shape[-1],))


def kan_int8_gemm(
    x_q: torch.Tensor, lut_u8: torch.Tensor, coeff_q: torch.Tensor, grid: SplineGrid,
    scale: torch.Tensor | None = None, qmax: int = 255, lut_scale: int | None = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Integer-only fused KAN GEMM through the dense u8 band (paper §V).

    ``x_q (..., K)`` activations quantised over the extended domain,
    ``coeff_q (K, M, N)`` int8 values; ``lut_u8`` fixes the table size
    ``S`` and, when ``lut_scale`` is None, its value scale (read and
    verified on the host, :func:`~repro_torch.kernels.kan_int8_gemm.resolve_lut_scale`).
    Returns the int32 accumulator, or with ``scale (N,)`` the dequantised
    ``out_dtype`` from the fused epilogue."""
    return _apply_int8("kan_int8_gemm", _int8.kan_int8_gemm_reference,
                       _int8.kan_int8_gemm_cuda, x_q, lut_u8, coeff_q, grid, scale, qmax,
                       lut_scale, out_dtype)


def kan_sparse_int8_gemm(
    x_q: torch.Tensor, lut_u8: torch.Tensor, coeff_q: torch.Tensor, grid: SplineGrid,
    scale: torch.Tensor | None = None, qmax: int = 255, lut_scale: int | None = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Integer sparse KAN GEMM: :func:`kan_int8_gemm`'s contract and
    integers, through gathered int8 slabs instead of the dense band (the
    int8 decode path)."""
    return _apply_int8("kan_sparse_int8_gemm", _sparse.kan_sparse_int8_gemm_reference,
                       _sparse.kan_sparse_int8_gemm_cuda, x_q, lut_u8, coeff_q, grid,
                       scale, qmax, lut_scale, out_dtype)


def bspline_lut(
    x: torch.Tensor, lut: torch.Tensor, grid: SplineGrid
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tabulated B-spline unit (paper Fig. 5): ``x (...)`` -> ``(vals
    (..., P+1) in x.dtype, k (...) int32)`` from the half-table ``lut
    (S, ceil((P+1)/2))``."""
    lead = x.shape
    x1 = x.reshape(-1).contiguous()
    if x1.device.type == "cpu":
        vals, k = _lut.bspline_lut_reference(x1, lut, grid)
    else:
        vals, k = _lut.bspline_lut_cuda(x1, lut.contiguous(), grid)
        LAUNCHES["bspline_lut"] += 1
    return vals.reshape(lead + (grid.P + 1,)), k.reshape(lead)
