"""KAN layers as GEMM workloads (paper §II-A, Eq. 1), in PyTorch.

Counterpart of ``repro/core/kan_layer.py``.  ``KANLayer(x) = sum_j phi_j(x_j)
+ w_b · ReLU(x)`` with ``phi`` in the B-spline basis; parameters are
``{"coeff": (K, M, N), "base_w": (K, N)}``.

Forward paths (``kan_layer_apply(method=...)``):

* ``dense``   — the full ``(..., K, M)`` Cox-de Boor basis and an einsum
  (differentiable; the conventional-array baseline);
* ``compact`` — the N:M form: ``P+1`` values per input against gathered
  coefficient slabs (the plain path on the CPU);
* ``fused``   — the fused CUDA kernel (``kernels/ops.kan_fused_gemm``);
* ``sparse``  — the sparse CUDA kernel (``kernels/ops.kan_sparse_gemm``);
* ``auto``    — :func:`resolve_inference_method`.

The LUT path, KAN stacks and ConvKAN are not ported yet.
"""

from __future__ import annotations

import math
import os
from typing import Any

import torch

from repro_torch.core import bspline
from repro_torch.core.bspline import SplineGrid

Params = dict[str, Any]


def _result_dtype(params: Params, x: torch.Tensor) -> torch.dtype:
    """JAX's type promotion: bf16 activations with fp32 parameters give fp32."""
    return torch.promote_types(x.dtype, params["coeff"].dtype)


def _base_term(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "base_w" not in params:
        return torch.zeros(x.shape[:-1] + (params["coeff"].shape[-1],),
                           dtype=x.dtype, device=x.device)
    dt = _result_dtype(params, x)
    return torch.relu(x).to(dt) @ params["base_w"].to(dt)


def kan_layer_dense(params: Params, x: torch.Tensor, grid: SplineGrid) -> torch.Tensor:
    """Conventional-SA baseline: dense B materialisation + GEMM (Fig. 1c)."""
    dt = _result_dtype(params, x)
    B = bspline.cox_de_boor_dense(x, grid)                 # (..., K, M)
    y = torch.einsum("...km,kmn->...n", B.to(dt), params["coeff"].to(dt))
    return y + _base_term(params, x)


def kan_layer_compact(params: Params, x: torch.Tensor, grid: SplineGrid) -> torch.Tensor:
    """N:M path (paper §IV): the ``P+1`` non-zero values per input against
    the gathered coefficient slabs ``C[j, k-P+i, :]``."""
    dt = _result_dtype(params, x)
    vals, k = bspline.compact_basis(x, grid)               # (..., K, P+1), (..., K)
    coeff = params["coeff"].to(dt)                         # (K, M, N)
    K = coeff.shape[0]
    m_idx = k.to(torch.int64)[..., None] - grid.P + torch.arange(
        grid.P + 1, device=x.device)
    flat_m = m_idx.reshape(-1, K, grid.P + 1)              # (BSf, K, P+1)
    kk = torch.arange(K, device=x.device)[None, :, None]
    slabs = coeff[kk, flat_m]                              # (BSf, K, P+1, N)
    vals_f = vals.reshape(-1, K, grid.P + 1).to(dt)
    y = torch.einsum("bki,bkin->bn", vals_f, slabs)
    y = y.reshape(x.shape[:-1] + (coeff.shape[-1],))
    return y + _base_term(params, x)


def resolve_inference_method(device: str | torch.device | None = None,
                             rows: int | None = None) -> str:
    """The default serving path per device and batch regime.

    On CUDA: ``sparse`` when the flattened row count is in the decode regime
    (``rows <= $KAN_SAS_SPARSE_MAX_ROWS``, default 8), else ``fused``.  On
    the CPU: ``compact``.  ``$KAN_SAS_INFERENCE_METHOD`` overrides the
    choice.  ``rows=None`` (unknown) gives the large-batch answer.  On CUDA
    the sparse kernel launches or raises; nothing probes or falls back.
    """
    forced = os.environ.get("KAN_SAS_INFERENCE_METHOD")
    if forced:
        return forced
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type != "cuda":
        return "compact"
    max_rows = int(os.environ.get("KAN_SAS_SPARSE_MAX_ROWS", "8"))
    if rows is not None and rows <= max_rows:
        return "sparse"
    return "fused"


def kan_layer_apply(
    params: Params, x: torch.Tensor, grid: SplineGrid, method: str = "dense",
) -> torch.Tensor:
    if method == "auto":
        method = resolve_inference_method(x.device, rows=math.prod(x.shape[:-1]))
    if method == "dense":
        return kan_layer_dense(params, x, grid)
    if method == "compact":
        return kan_layer_compact(params, x, grid)
    if method == "fused":
        from repro_torch.kernels import ops as kops

        return kops.kan_fused_gemm(x, params["coeff"], grid,
                                   base_w=params.get("base_w"))
    if method == "sparse":
        from repro_torch.kernels import ops as kops

        return kops.kan_sparse_gemm(x, params["coeff"], grid,
                                    base_w=params.get("base_w"))
    if method == "lut":
        raise NotImplementedError(
            "method='lut' is not ported yet (ROADMAP queue 1, item 2)")
    raise ValueError(f"unknown method {method!r}")
