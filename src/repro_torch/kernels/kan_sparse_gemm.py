"""Compact N:M sparse KAN GEMM, the decode path (float kernel only).

Counterpart of ``repro/kernels/kan_sparse_gemm.py`` (the Pallas TPU kernel
``_sparse_kernel`` / ``kan_sparse_gemm_pallas``): each input contracts only
its ``P+1`` non-zero basis values against the coefficient slab
``C[j, k-P .. k, :]`` it touches, plus the base term, in one launch.  The
CUDA kernel (``csrc/kan_sparse_gemm.cu``) is a GEMV for up to 8 rows per
block that reads each touched coefficient row once for all rows, splits K
into slices and sums the slices' fp32 partials in the same launch; its
source note states its bound.  It takes ``P = 3`` and ``M = G+P <= 8``.  The
int8 variant is not ported yet.

:func:`kan_sparse_gemm_reference` is the plain PyTorch version: gathered
slabs and an einsum.  Its ``(BS, K, P+1, N)`` gather is fine at decode row
counts and at the CPU tests' sizes.
"""

from __future__ import annotations

import torch

from repro_torch.core.bspline import SplineGrid
from repro_torch.kernels import build
from repro_torch.kernels.common import compact_basis_inblock, gather_coeff_slabs
from repro_torch.kernels.kan_fused_gemm import DTYPE_CODES, check_operands

MAX_M = 8                     # the kernel's compile-time band width

# The kernel's device workspace, one per (device, stream) so that calls
# ordered on one stream share it and calls on two streams never do: ticket
# counters (zero when made, and every launch leaves them zero) and the K
# slices' fp32 partials.  Each buffer only ever grows.
_workspaces: dict[tuple[int, int], dict[str, torch.Tensor]] = {}
_workspace_sizes: dict[tuple[int, int, int], tuple[int, int]] = {}


def _workspace(lib, device: torch.device, stream: int, BS: int, K: int, N: int):
    sizes = _workspace_sizes.get((BS, K, N))
    if sizes is None:
        sizes = _workspace_sizes[(BS, K, N)] = (int(lib.kan_sparse_gemm_tickets(BS, N)),
                                                int(lib.kan_sparse_gemm_partials(BS, K, N)))
    n_tickets, n_partial = sizes
    ws = _workspaces.setdefault((device.index, stream), {})
    if "tickets" not in ws or ws["tickets"].numel() < n_tickets:
        ws["tickets"] = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    if "partial" not in ws or ws["partial"].numel() < n_partial:
        ws["partial"] = torch.empty(n_partial, dtype=torch.float32, device=device)
    return ws["tickets"], ws["partial"]


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
    tickets, partial = _workspace(lib, x.device, stream, BS, K, N)
    err = lib.kan_sparse_gemm(
        x.data_ptr(), coeff.data_ptr(),
        base_w.data_ptr() if base_w is not None else None,
        tickets.data_ptr(), partial.data_ptr(), y.data_ptr(),
        BS, K, N, M, grid.P, grid.t0, grid.delta,   # ctypes rounds to fp32
        DTYPE_CODES[x.dtype], DTYPE_CODES[coeff.dtype], stream,
    )
    build.check(err, "kan_sparse_gemm")
    return y
