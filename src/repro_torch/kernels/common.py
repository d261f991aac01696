"""Plain PyTorch versions of the in-kernel KAN building blocks.

Counterpart of ``repro/kernels/common.py``.  The CUDA kernels carry the same
helpers as ``__device__`` functions in ``csrc/kan_common.cuh``; the functions
here are what the kernels' plain versions (and the CPU tests) run:

* :func:`cardinal_values_inblock`: the ``P+1`` cardinal B-spline values by
  the Cox-de Boor triangle on a ``(P+2)``-wide band;
* :func:`compact_basis_inblock`: ``z = (x - t0)/delta``,
  ``k = clamp(floor z, P, M-1)``, ``xa = clamp(z - k, 0, 1)`` in float32
  whatever the input dtype, then the values;
* :func:`band_scatter`: the compact values placed into the dense ``M`` band;
* :func:`gather_coeff_slabs`: per input, the ``(P+1, N)`` coefficient slab
  ``C[j, k-P .. k, :]`` its non-zero basis values touch.
"""

from __future__ import annotations

import torch

from repro_torch.core.bspline import SplineGrid


def cardinal_values_inblock(xa: torch.Tensor, P: int) -> torch.Tensor:
    """``B_{0,P}(xa + (P - i))`` for ``i = 0..P``: shape ``xa.shape + (P+1,)``."""
    dt = xa.dtype
    offs = P - torch.arange(P + 1, device=xa.device).to(dt)
    u = xa[..., None] + offs                                    # (..., P+1)
    seg = torch.arange(P + 1, device=xa.device).to(dt)
    uu = u[..., None]
    b = ((uu >= seg) & (uu < seg + 1)).to(dt)                   # (..., P+1, P+1)
    for p in range(1, P + 1):
        idx = torch.arange(P + 1 - p, device=xa.device).to(dt)
        left = (uu - idx) / p * b[..., :-1]
        right = (idx + (p + 1) - uu) / p * b[..., 1:]
        b = left + right
    return b[..., 0]


def compact_basis_inblock(
    x: torch.Tensor, grid: SplineGrid
) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(vals x.shape + (P+1,), k int32)`` for any input dtype."""
    P = grid.P
    xf = x.float()
    # 0-dim device tensors: a true division (CUDA divides by a Python scalar
    # as a multiply by its reciprocal, which can move floor(z) at a knot),
    # made by a fill kernel (a host-to-device copy would sync the stream)
    t0 = torch.full((), grid.t0, dtype=torch.float32, device=x.device)
    delta = torch.full((), grid.delta, dtype=torch.float32, device=x.device)
    z = (xf - t0) / delta
    k = torch.clamp(torch.floor(z).to(torch.int32), P, grid.n_basis - 1)
    xa = torch.clamp(z - k.float(), 0.0, 1.0)
    return cardinal_values_inblock(xa, P), k


def band_scatter(vals: torch.Tensor, k: torch.Tensor, M: int) -> torch.Tensor:
    """Compact ``vals (..., P+1)`` into the dense band ``(..., M)``."""
    P = vals.shape[-1] - 1
    m = torch.arange(M, device=vals.device)
    rel = m - (k.to(torch.int64)[..., None] - P)               # (..., M)
    band = torch.zeros(k.shape + (M,), dtype=vals.dtype, device=vals.device)
    for i in range(P + 1):
        band = band + torch.where(rel == i, vals[..., i:i + 1], 0.0)
    return band


def gather_coeff_slabs(c: torch.Tensor, k: torch.Tensor, P: int) -> torch.Tensor:
    """``c (K, M, N)``, ``k (B, K)`` -> slabs ``(B, K, P+1, N)``."""
    Bn, K = k.shape
    offs = torch.arange(P + 1, device=k.device)
    idx = k.to(torch.int64)[..., None] - P + offs              # (B, K, P+1)
    kk = torch.arange(K, device=k.device)[None, :, None]
    return c[kk, idx]
