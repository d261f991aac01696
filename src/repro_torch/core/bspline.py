"""B-spline math for KAN layers (paper §II-A, §III-B), in PyTorch.

Counterpart of ``repro/core/bspline.py``; same grid conventions:

* knots ``t_i = x_min + (i - P) * delta`` for ``i = 0 .. G+2P``;
* ``M = G+P`` basis functions; ``B_m`` is supported on ``[t_m, t_{m+P+1})``;
* an in-domain input lies in interval ``k in [P, G+P-1]`` and its non-zero
  functions are ``B_{k-P} .. B_k``.

Boundary convention (shared by every evaluation path): out-of-domain inputs
saturate to the boundary basis (the paper's Eq. 5 address clip), and
``x == x_max`` activates the last in-domain interval.

The tabulated evaluation (paper §III-B, Fig. 4-5) is :func:`build_lut`,
:func:`lut_basis_compact` and :func:`lut_basis_dense`; the CUDA kernel of
the tabulated unit is ``kernels/bspline_lut.py``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "SplineGrid",
    "cox_de_boor_dense",
    "cardinal_bspline",
    "align",
    "interval_index",
    "compact_basis",
    "compact_to_dense",
    "build_lut",
    "lut_basis_compact",
    "lut_basis_dense",
]


@dataclasses.dataclass(frozen=True)
class SplineGrid:
    """A uniform, extended B-spline grid (paper Fig. 2)."""

    x_min: float = -1.0
    x_max: float = 1.0
    G: int = 5
    P: int = 3

    def __post_init__(self):
        if self.G < 1 or self.P < 1:
            raise ValueError(f"G >= 1 and P >= 1 required, got G={self.G} P={self.P}")
        if not self.x_max > self.x_min:
            raise ValueError("x_max must exceed x_min")

    @property
    def delta(self) -> float:
        return (self.x_max - self.x_min) / self.G

    @property
    def n_basis(self) -> int:
        """M = G+P basis functions (paper §II-A)."""
        return self.G + self.P

    @property
    def n_nonzero(self) -> int:
        """N = P+1 non-zero basis values per input (paper §IV-A)."""
        return self.P + 1

    @property
    def t0(self) -> float:
        """First extended knot, t_0 = x_min - P*delta."""
        return self.x_min - self.P * self.delta

    @property
    def t_last(self) -> float:
        """Last extended knot, t_{G+2P}."""
        return self.x_min + (self.G + self.P) * self.delta

    def knots(self) -> np.ndarray:
        """All G+2P+1 extended knots."""
        return self.t0 + self.delta * np.arange(self.G + 2 * self.P + 1)

    def half_cols(self) -> int:
        """Columns of the LUT half-table (paper §III-B)."""
        return math.ceil((self.P + 1) / 2)


def cox_de_boor_dense(x: torch.Tensor, grid: SplineGrid) -> torch.Tensor:
    """All ``G+P`` basis values at ``x``: shape ``x.shape + (G+P,)``.

    Iterative Cox-de Boor (paper Eq. 2-3), differentiable in ``x`` a.e.
    Out-of-domain inputs are clamped to the knot values ``t_P``/``t_{G+P}``
    and ``x == x_max`` belongs to the last in-domain interval.
    """
    knots = torch.as_tensor(grid.knots(), dtype=x.dtype, device=x.device)
    # maximum then minimum, as ``jnp.clip`` does: at an input exactly on a
    # bound the gradient is split 0.5 / 0.5 between x and the bound, where
    # ``torch.clamp`` would pass all of it to x
    xx = torch.minimum(torch.maximum(x, knots[grid.P]), knots[grid.n_basis])[..., None]
    inside = (xx >= knots[:-1]) & (xx < knots[1:])
    iota = torch.arange(knots.shape[0] - 1, device=x.device)
    on_edge = xx == knots[grid.n_basis]
    inside = (inside | (on_edge & (iota == grid.n_basis - 1))) & ~(
        on_edge & (iota == grid.n_basis)
    )
    b = inside.to(x.dtype)
    for p in range(1, grid.P + 1):
        t_i = knots[: -(p + 1)]
        t_ip = knots[p:-1]
        t_i1 = knots[1:-p]
        t_ip1 = knots[p + 1:]
        left = (xx - t_i) / (t_ip - t_i) * b[..., :-1]
        right = (t_ip1 - xx) / (t_ip1 - t_i1) * b[..., 1:]
        b = left + right
    return b[..., : grid.n_basis]


def cardinal_bspline(u: torch.Tensor, P: int) -> torch.Tensor:
    """Cardinal B-spline ``B_{0,P}(u)`` on integer knots ``0..P+1``."""
    uu = u[..., None]
    i = torch.arange(P + 2, dtype=u.dtype, device=u.device)
    b = ((uu >= i[:-1]) & (uu < i[1:])).to(u.dtype)
    for p in range(1, P + 1):
        idx = torch.arange(P + 1 - p, dtype=u.dtype, device=u.device)
        left = (uu - idx) / p * b[..., :-1]
        right = (idx + p + 1 - uu) / p * b[..., 1:]
        b = left + right
    return b[..., 0]


def align(x: torch.Tensor, grid: SplineGrid) -> torch.Tensor:
    """Aligned coordinate ``z = (x - t0)/delta`` (paper Eq. 4)."""
    # a 0-dim tensor keeps the division true on CUDA (see
    # kernels/common.compact_basis_inblock); torch.full avoids a host sync
    return (x - grid.t0) / torch.full((), grid.delta, dtype=x.dtype, device=x.device)


def interval_index(x: torch.Tensor, grid: SplineGrid) -> torch.Tensor:
    """Interval index ``k`` (int32), clipped to ``[P, G+P-1]``."""
    k = torch.floor(align(x, grid)).to(torch.int32)
    return torch.clamp(k, grid.P, grid.n_basis - 1)


def compact_basis(
    x: torch.Tensor, grid: SplineGrid
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact compact N:M evaluation -> ``(vals x.shape + (P+1,), k)``.

    ``vals[..., i]`` is ``B_{k-P+i}(x)`` (ascending basis index).
    """
    z = align(x, grid)
    k = interval_index(x, grid)
    xa = torch.clamp(z - k.to(z.dtype), 0.0, 1.0)
    offs = torch.arange(grid.P, -1, -1, dtype=z.dtype, device=z.device)
    vals = cardinal_bspline(xa[..., None] + offs, grid.P)
    return vals, k


def compact_to_dense(
    vals: torch.Tensor, k: torch.Tensor, grid: SplineGrid
) -> torch.Tensor:
    """Scatter compact values into the dense ``(..., G+P)`` layout."""
    m = torch.arange(grid.n_basis, dtype=torch.int64, device=vals.device)
    rel = m - (k.to(torch.int64)[..., None] - grid.P)
    inside = (rel >= 0) & (rel <= grid.P)
    gathered = torch.gather(vals, -1, torch.clamp(rel, 0, grid.P))
    return torch.where(inside, gathered, torch.zeros((), dtype=vals.dtype,
                                                      device=vals.device))


def build_lut(P: int, S: int = 256, dtype=np.float32) -> np.ndarray:
    """Half-table of the cardinal B-spline: ``T[a, c] = B_{0,P}(a/(S-1) + c)``
    for ``a in [0, S)`` and ``c in [0, ceil((P+1)/2))``.

    Evaluated in float32, as the reference evaluates it (its float64 grid
    becomes float32 in JAX's default precision), then cast to ``dtype``.
    """
    cols = math.ceil((P + 1) / 2)
    a = np.arange(S, dtype=np.float64) / (S - 1)
    u = a[:, None] + np.arange(cols)[None, :]
    tab = cardinal_bspline(torch.as_tensor(u, dtype=torch.float32), P).numpy()
    return tab.astype(dtype)


def lut_basis_compact(
    x: torch.Tensor, grid: SplineGrid, lut: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tabulated compact evaluation (paper Fig. 5) -> ``(vals, k)``.

    The in-interval offset ``x_a`` becomes the address
    ``addr = round(x_a·(S-1))`` (half to even); ``B0(x_a + j)`` is the
    direct fetch ``T[addr, j]`` for ``j < ceil((P+1)/2)`` and the
    inverted-address fetch ``T[S-1-addr, P-j]`` otherwise.  ``vals[..., i]``
    is ordered by ascending basis index (``j = P-i``), in ``lut.dtype``.
    """
    S, half = lut.shape
    P = grid.P
    z = align(x, grid)
    k = interval_index(x, grid)
    xa = torch.clamp(z - k.to(z.dtype), 0.0, 1.0)
    addr = torch.clamp(torch.round(xa * (S - 1)).to(torch.int64), 0, S - 1)
    addr_inv = (S - 1) - addr
    cols = []
    for i in range(P + 1):
        j = P - i
        cols.append(lut[addr, j] if j < half else lut[addr_inv, P - j])
    return torch.stack(cols, dim=-1), k


def lut_basis_dense(x: torch.Tensor, grid: SplineGrid, lut: torch.Tensor) -> torch.Tensor:
    """Tabulated evaluation scattered to the dense ``(..., G+P)`` layout."""
    vals, k = lut_basis_compact(x, grid, lut)
    return compact_to_dense(vals, k, grid)
