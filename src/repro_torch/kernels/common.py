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
  ``C[j, k-P .. k, :]`` its non-zero basis values touch;
* :func:`int8_compact_values_inblock`: the integer Align/Compare units
  (paper Eq. 5) and the uint8 ROM values of the int8 datapath, fetched
  from the ROM (:func:`rom_table`).
"""

from __future__ import annotations

import torch

from repro_torch.core.bspline import SplineGrid
from repro_torch.core.quantization import build_lut_u8


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


_roms: dict[tuple, torch.Tensor] = {}


def rom_table(P: int, S: int, lut_scale: int, device: torch.device) -> torch.Tensor:
    """The paper's ROM, ``build_lut_u8(P, S, lut_scale)`` (uint8, ``(S,
    ceil((P+1)/2))``), on ``device``; made once per key."""
    key = (P, S, lut_scale, device.type, device.index)
    t = _roms.get(key)
    if t is None:
        t = _roms[key] = torch.as_tensor(build_lut_u8(P, S, lut_scale), device=device)
    return t


def int8_compact_values_inblock(
    x_q: torch.Tensor, grid: SplineGrid, S: int, qmax: int, lut_scale: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer Align + Compare (paper Eq. 5) and the uint8 ROM values.

    ``x_q (...)`` int activations quantised over the extended domain ->
    ``(bvals (..., P+1) int32, k (...) int32)``: ``u = (G+2P)·x_q``,
    ``k = clamp(u // qmax, P, M-1)`` (floor division),
    ``addr = (clamp(u - qmax·k, 0, qmax)·(S-1)) // qmax``, and the values
    ``B0(x_a + j)``, ``j = P-i``, fetched from ``build_lut_u8(P, S,
    lut_scale)`` directly (``j < ceil((P+1)/2)``) or at the inverted address.

    The reference's kernels evaluate these entries from the float
    Cox-de Boor triangle instead of reading the table; for ``P = 2`` at the
    value scale 192 that rounds one entry (address 2, exactly 94.50002)
    down to 94 where the table holds 95.  The port reads the table.
    """
    P, M = grid.P, grid.n_basis
    u = (grid.G + 2 * P) * x_q.to(torch.int32)
    k = torch.clamp(torch.div(u, qmax, rounding_mode="floor"), P, M - 1)
    addr = torch.clamp(u - qmax * k, 0, qmax)
    addr = torch.div(addr * (S - 1), qmax, rounding_mode="floor").to(torch.int64)
    rom = rom_table(P, S, lut_scale, x_q.device)
    half = rom.shape[1]
    cols = [rom[addr, P - i] if P - i < half else rom[(S - 1) - addr, i] for i in range(P + 1)]
    return torch.stack(cols, dim=-1).to(torch.int32), k.to(torch.int32)
