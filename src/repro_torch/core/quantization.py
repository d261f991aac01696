"""Integer-only KAN inference (paper §V, ref [18] Jacob et al.), in PyTorch.

Counterpart of ``repro/core/quantization.py``.  Activations are affine
uint8 over the *extended grid domain* (so the Align/Compare units run the
Eq. 5 integer address arithmetic), LUT values are uint8 with a power-of-two
value scale (``B·256`` for cubic, or the paper's ``B·192``), spline
coefficients and base weights are symmetric int8 per output channel, and
the accumulator is int32.  Integers (``x_q``, ``addr``, ``k``, ROM values,
``coeff_q``, ``base_w_q``, accumulators) equal the reference's exactly.

Divisions are by 0-dim tensors: CUDA divides by a Python scalar as a
multiply by its reciprocal, which can move a rounded integer by one.

:func:`quantized_kan_forward_fused` is the kernel-backed layer: the
dense-band int8 kernel (``kernels/kan_int8_gemm.py``), or at decode row
counts on the card the sparse int8 kernel (``kernels/kan_sparse_gemm.py``),
which gives the same integers.  :func:`quantized_kan_forward` is the plain
version with the uint8 table fetch and gathered int8 slabs.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch

from repro_torch.core import bspline
from repro_torch.core.bspline import SplineGrid


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-dim tensor of ``like``'s dtype and device (a fill, no
    host sync; the reference's Python scalars take the array's dtype too)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class AffineQuant:
    """q = clip(round(x/scale) + zero, 0, 2^bits - 1)."""

    scale: float
    zero: int
    bits: int = 8

    @property
    def qmax(self) -> int:
        return (1 << self.bits) - 1

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        q = torch.round(x / _scalar(self.scale, x)) + self.zero
        return torch.clamp(q, 0, self.qmax).to(torch.int32)

    def dequantize(self, q: torch.Tensor) -> torch.Tensor:
        return (q.to(torch.float32) - self.zero) * self.scale


def affine_from_range(lo: float, hi: float, bits: int = 8) -> AffineQuant:
    scale = (hi - lo) / ((1 << bits) - 1)
    zero = int(round(-lo / scale))
    return AffineQuant(scale=scale, zero=zero, bits=bits)


def symmetric_scales(w: torch.Tensor, axis=None, bits: int = 8) -> torch.Tensor:
    """Per-axis symmetric int8 scales: q = round(w/s), s = max|w|/127."""
    a = w.abs()
    amax = a.amax() if axis is None else a.amax(dim=axis, keepdim=True)
    return torch.clamp_min(amax, 1e-12) / _scalar((1 << (bits - 1)) - 1, amax)


@functools.lru_cache(maxsize=8)
def lut_value_scale(P: int) -> int:
    """Largest power-of-two s with max(B_{0,P})·s <= 255 (uint8 values):
    256 for P=3 (max 2/3), 128 for P=1."""
    mx = float(bspline.cardinal_bspline(torch.tensor((P + 1) / 2.0), P))
    return 1 << int(math.floor(math.log2(255.0 / mx)))


def build_lut_u8(P: int, S: int = 256, scale: int | None = None) -> np.ndarray:
    """uint8 half-table ``round(B_{0,P}·scale)`` (paper Fig. 5), shape
    ``(S, ceil((P+1)/2))``."""
    if scale is None:
        scale = lut_value_scale(P)
    tab = bspline.build_lut(P, S, dtype=np.float64) * scale
    return np.clip(np.round(tab), 0, 255).astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class QuantizedGrid:
    """Integer-domain grid: activations quantised over the extended knot
    span ``[t0, t_last]`` so the Eq. 5 address arithmetic is exact in int32."""

    grid: SplineGrid
    x_quant: AffineQuant
    lut_scale: int
    S: int = 256

    @staticmethod
    def make(grid: SplineGrid, S: int = 256, bits: int = 8) -> "QuantizedGrid":
        xq = affine_from_range(grid.t0, grid.t_last, bits)
        return QuantizedGrid(grid, xq, lut_value_scale(grid.P), S)


def int_address(qg: QuantizedGrid, x_q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer Align + Compare (paper Eq. 5) -> ``(addr, k)`` int32:
    ``u = (G+2P)·x_q``, ``k = clamp(u // qmax, P, M-1)``,
    ``addr = (clamp(u - qmax·k, 0, qmax)·(S-1)) // qmax``."""
    g = qg.grid
    qmax = qg.x_quant.qmax
    u = (g.G + 2 * g.P) * x_q.to(torch.int32)
    k = torch.clamp(torch.div(u, qmax, rounding_mode="floor"), g.P, g.n_basis - 1)
    addr = torch.clamp(u - qmax * k, 0, qmax)
    addr = torch.div(addr * (qg.S - 1), qmax, rounding_mode="floor")
    return addr.to(torch.int32), k.to(torch.int32)


def lut_fetch_u8(qg: QuantizedGrid, lut_u8: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """The P+1 non-zero uint8 values (ascending basis index), direct and
    inverted-address fetch (paper Fig. 5's ``~`` unit) -> int32."""
    P = qg.grid.P
    half = lut_u8.shape[1]
    a = addr.to(torch.int64)
    a_inv = (qg.S - 1) - a
    cols = []
    for i in range(P + 1):
        j = P - i
        cols.append(lut_u8[a, j] if j < half else lut_u8[a_inv, P - j])
    return torch.stack(cols, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class QuantizedKANLayer:
    coeff_q: torch.Tensor               # (K, M, N) int8 values as int32
    coeff_scale: torch.Tensor           # (1, 1, N) per output channel
    base_w_q: torch.Tensor | None       # (K, N) int8 values as int32
    base_w_scale: torch.Tensor | None   # (1, N)
    qg: QuantizedGrid
    lut_u8: torch.Tensor                # (S, ceil((P+1)/2)) uint8
    coeff_i8: torch.Tensor              # coeff_q as int8, the kernels' operand


def _quantize_symmetric(w: torch.Tensor, axis) -> tuple[torch.Tensor, torch.Tensor]:
    s = symmetric_scales(w, axis=axis)
    return torch.clamp(torch.round(w / s), -127, 127).to(torch.int32), s


def quantize_kan_layer(params, grid: SplineGrid, S: int = 256) -> QuantizedKANLayer:
    """Symmetric int8 per output channel for ``coeff`` and ``base_w``, on
    the device the parameters lie on."""
    qg = QuantizedGrid.make(grid, S)
    coeff = params["coeff"]
    coeff_q, cs = _quantize_symmetric(coeff, (0, 1))
    base_w = params.get("base_w")
    base_q, bs_ = _quantize_symmetric(base_w, 0) if base_w is not None else (None, None)
    return QuantizedKANLayer(
        coeff_q=coeff_q, coeff_scale=cs, base_w_q=base_q, base_w_scale=bs_, qg=qg,
        lut_u8=torch.as_tensor(build_lut_u8(grid.P, S), device=coeff.device),
        coeff_i8=coeff_q.to(torch.int8),
    )


def _quantized_base_term(qlayer: QuantizedKANLayer, x_q: torch.Tensor, out_shape):
    """Integer base term: ReLU in the quantised domain, an integer GEMM, one
    rescale (paper Eq. 1 base term with ReLU).  The GEMM runs in float64,
    exact for these integers (|sum| < 2^53), since the card has no int32
    matmul; the result equals the int32 einsum's."""
    if qlayer.base_w_q is None:
        return None
    xq = qlayer.qg.x_quant
    relu_q = torch.clamp_min(x_q, xq.zero) - xq.zero
    yb = (relu_q.to(torch.float64) @ qlayer.base_w_q.to(torch.float64)).to(torch.float32)
    return (yb * (qlayer.base_w_scale.reshape(1, -1) * xq.scale)).reshape(out_shape)


def resolve_int8_method(device: torch.device, rows: int) -> str:
    """The int8 kernel for a call: on CUDA the sparse int8 kernel at decode
    row counts (``rows <= $KAN_SAS_SPARSE_MAX_ROWS``, default 8, as
    ``kan_layer.resolve_inference_method``), else the dense-band one; on
    the CPU the dense-band plain version.  Both give the same integers."""
    max_rows = int(os.environ.get("KAN_SAS_SPARSE_MAX_ROWS", "8"))
    if device.type == "cuda" and rows <= max_rows:
        return "sparse_int8"
    return "int8"


def quantized_kan_forward_fused(qlayer: QuantizedKANLayer, x: torch.Tensor) -> torch.Tensor:
    """Kernel-backed integer forward: Align/Compare, ROM, int8 GEMM and the
    per-channel dequant in one launch (the kernel :func:`resolve_int8_method`
    picks), emitting ``x.dtype``; then the base term.  Numerically
    identical to :func:`quantized_kan_forward`."""
    from repro_torch.kernels import ops as kops

    qg = qlayer.qg
    x_q = qg.x_quant.quantize(x)
    scale = qlayer.coeff_scale.reshape(-1) / _scalar(qg.lut_scale, qlayer.coeff_scale)
    method = resolve_int8_method(x.device, math.prod(x.shape[:-1]))
    gemm = {"int8": kops.kan_int8_gemm, "sparse_int8": kops.kan_sparse_int8_gemm}[method]
    y = gemm(x_q, qlayer.lut_u8, qlayer.coeff_i8, qg.grid, scale=scale,
             lut_scale=qg.lut_scale, out_dtype=x.dtype)
    base = _quantized_base_term(qlayer, x_q, y.shape)
    return y if base is None else y + base.to(y.dtype)


def quantized_kan_forward(qlayer: QuantizedKANLayer, x: torch.Tensor) -> torch.Tensor:
    """End-to-end integer KAN layer with the uint8 table fetch and gathered
    int8 slabs (paper §IV-A): float32 output, the final rescale the only
    float op.  The slab contraction runs in float64, exact for these
    integers; its ``(rows, K, P+1, N)`` gather suits small row counts."""
    qg = qlayer.qg
    P = qg.grid.P
    x_q = qg.x_quant.quantize(x)
    addr, k = int_address(qg, x_q)
    bvals = lut_fetch_u8(qg, qlayer.lut_u8, addr)             # (..., K, P+1)
    K, M, N = qlayer.coeff_q.shape
    m_idx = k.to(torch.int64)[..., None] - P + torch.arange(P + 1, device=x.device)
    flat_m = m_idx.reshape(-1, K, P + 1)
    kk = torch.arange(K, device=x.device)[None, :, None]
    slabs = qlayer.coeff_q[kk, flat_m].to(torch.float64)      # (BSf, K, P+1, N)
    acc = torch.einsum("bki,bkin->bn", bvals.reshape(-1, K, P + 1).to(torch.float64), slabs)
    y = acc.to(torch.int32).to(torch.float32).reshape(x.shape[:-1] + (N,))
    y = y * (qlayer.coeff_scale.reshape(1, -1) / _scalar(qg.lut_scale, qlayer.coeff_scale))
    base = _quantized_base_term(qlayer, x_q, y.shape)
    return y if base is None else y + base
