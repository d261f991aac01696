"""Public wrappers for the KAN kernels (counterpart of ``repro/kernels/ops.py``).

Each wrapper flattens the leading dims of ``x`` and then:

* for a tensor on the CPU, runs the kernel's plain PyTorch version;
* for a CUDA tensor, launches the hand-written CUDA kernel (building it at
  first use) or raises.  There is no fallback.

Tiles are the kernels' fixed defaults (see each ``csrc/*.cu``); the JAX
package's tile autotuner is not ported yet.  ``LAUNCHES`` counts kernel
launches per kernel, so a run can show that its main path went through the
kernels: a wrapper adds one exactly where it launches, never on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core.bspline import SplineGrid
from repro_torch.kernels import kan_fused_gemm as _fused
from repro_torch.kernels import kan_sparse_gemm as _sparse

LAUNCHES: dict[str, int] = {"kan_fused_gemm": 0, "kan_sparse_gemm": 0}


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
