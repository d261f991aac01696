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
* ``lut``     — tabulated evaluation (paper Fig. 5) through the B-spline LUT
  kernel (``kernels/ops.bspline_lut``), scattered dense, then an einsum;
* ``auto``    — :func:`resolve_inference_method`.

KAN stacks (MNIST-KAN and the other Table II networks) are
:func:`kan_net_apply`.  ConvKAN (``im2col``, ``conv_kan_apply``) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any

import torch

from repro_torch.core import bspline
from repro_torch.core.bspline import SplineGrid

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class KANLayerConfig:
    in_dim: int
    out_dim: int
    grid: SplineGrid = SplineGrid()
    base: bool = True           # include the w_b · ReLU(x) term of Eq. 1
    noise_scale: float = 0.1    # init scale for spline coefficients
    lut_size: int = 256         # paper: 8-bit address -> 256 entries


def init_kan_layer(cfg: KANLayerConfig, gen: torch.Generator,
                   dtype=torch.float32) -> Params:
    """Coefficients ``(K, M, N)`` + base weight ``(K, N)`` on ``gen``'s
    device, with the reference's shapes and scales (values differ from
    JAX's draws)."""
    M = cfg.grid.n_basis
    dev = gen.device
    coeff = cfg.noise_scale * torch.randn(
        (cfg.in_dim, M, cfg.out_dim), generator=gen, device=dev
    ) / math.sqrt(cfg.in_dim * (cfg.grid.P + 1))
    params: Params = {"coeff": coeff.to(dtype)}
    if cfg.base:
        w = torch.randn((cfg.in_dim, cfg.out_dim), generator=gen, device=dev)
        params["base_w"] = (w * math.sqrt(2.0 / cfg.in_dim)).to(dtype)
    return params


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


def kan_layer_lut(
    params: Params, x: torch.Tensor, grid: SplineGrid, lut: torch.Tensor
) -> torch.Tensor:
    """Tabulated inference path (paper Fig. 5): the compact values from the
    LUT kernel, scattered dense, then one einsum."""
    from repro_torch.kernels import ops as kops

    dt = _result_dtype(params, x)
    vals, k = kops.bspline_lut(x, lut, grid)
    B = bspline.compact_to_dense(vals, k, grid)            # (..., K, M)
    y = torch.einsum("...km,kmn->...n", B.to(dt), params["coeff"].to(dt))
    return y + _base_term(params, x)


@functools.lru_cache(maxsize=16)
def _default_lut(P: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(bspline.build_lut(P), device=device)


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
    lut: torch.Tensor | None = None,
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
        if lut is None:
            lut = _default_lut(grid.P, x.device)
        return kan_layer_lut(params, x, grid, lut)
    raise ValueError(f"unknown method {method!r}")


# ---------------------------------------------------------------------------
# KAN stacks (MLP-style): the paper's application workloads.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KANNetConfig:
    """A KAN MLP: e.g. MNIST-KAN is ``layers=[784, 64, 10], G=10, P=3``."""

    layers: tuple[int, ...]
    G: int = 5
    P: int = 3
    x_min: float = -1.0
    x_max: float = 1.0
    base: bool = True
    layer_norm: bool = True  # keep activations in-domain between layers

    def grid(self) -> SplineGrid:
        return SplineGrid(self.x_min, self.x_max, self.G, self.P)


def init_kan_net(cfg: KANNetConfig, seed: int = 0, device="cuda",
                 dtype=torch.float32) -> list[Params]:
    """One parameter dict per layer, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return [
        init_kan_layer(KANLayerConfig(cfg.layers[i], cfg.layers[i + 1], cfg.grid(),
                                      base=cfg.base), gen, dtype)
        for i in range(len(cfg.layers) - 1)
    ]


def _tanh_norm(h: torch.Tensor) -> torch.Tensor:
    """Map intermediate activations back into the spline domain (a smooth
    squash, which keeps the LUT and int8 paths' clipping honest)."""
    return torch.tanh(h)


def kan_net_apply(
    params: list[Params], x: torch.Tensor, cfg: KANNetConfig, method: str = "dense",
    lut: torch.Tensor | None = None,
) -> torch.Tensor:
    g = cfg.grid()
    h = x
    for i, p in enumerate(params):
        if i > 0 and cfg.layer_norm:
            h = _tanh_norm(h)
        h = kan_layer_apply(p, h, g, method=method, lut=lut)
    return h
