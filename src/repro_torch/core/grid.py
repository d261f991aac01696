"""Grid utilities: uniform-grid refinement with a least-squares refit
(counterpart of ``repro/core/grid.py``).

Paper §II-B: a uniform grid can be made finer without retraining, by least
squares on the new basis, and a finer uniform grid approximates a
non-uniform one.  Given coefficients on a coarse (or non-uniform) grid,
this module samples the spline densely and fits coefficients on a finer
uniform grid.

The solve runs in at least float32 (bf16 coefficients are promoted for it
and the solution cast back), through ``torch.linalg.lstsq``'s ``gels``
solver, the only one it has on CUDA.  ``gels`` needs a full-rank
tall system, and the refit's is: ``n_samples`` points over the domain
against ``G_new + P`` basis functions, each of which is non-zero on some
interval of the domain that the samples cover.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bspline
from repro_torch.core.bspline import SplineGrid


def refine_grid(grid: SplineGrid, factor: int = 2) -> SplineGrid:
    """A finer uniform grid over the same domain (G -> G*factor)."""
    return SplineGrid(grid.x_min, grid.x_max, grid.G * factor, grid.P)


def _solve(B_new: torch.Tensor, B_old: torch.Tensor, coeff: torch.Tensor,
           n_basis: int) -> torch.Tensor:
    """``argmin ||B_new @ c_new - B_old @ coeff||`` per (input, output):
    ``coeff (K, M_old, N)`` -> ``(K, n_basis, N)`` in ``coeff.dtype``."""
    targets = torch.einsum("sm,kmn->skn", B_old, coeff.to(B_old.dtype))
    sol = torch.linalg.lstsq(B_new, targets.reshape(B_new.shape[0], -1), driver="gels").solution
    K, _, N = coeff.shape
    return sol.reshape(n_basis, K, N).permute(1, 0, 2).to(coeff.dtype)


def refit_coefficients(
    coeff: torch.Tensor, old_grid: SplineGrid, new_grid: SplineGrid, n_samples: int = 512,
) -> torch.Tensor:
    """Least-squares refit of KAN coefficients onto a new grid:
    ``coeff (K, M_old, N)`` -> ``(K, M_new, N)`` minimising
    ``||B_new @ c_new - B_old @ c_old||`` over ``n_samples`` points of the
    domain, on ``coeff``'s device."""
    solve_dtype = torch.promote_types(coeff.dtype, torch.float32)
    xs = torch.linspace(old_grid.x_min, old_grid.x_max, n_samples, dtype=solve_dtype,
                        device=coeff.device)
    B_old = bspline.cox_de_boor_dense(xs, old_grid)         # (S, M_old)
    B_new = bspline.cox_de_boor_dense(xs, new_grid)         # (S, M_new)
    return _solve(B_new, B_old, coeff, new_grid.n_basis)


def nonuniform_to_uniform(
    knots: np.ndarray, coeff: torch.Tensor, P: int, G_new: int, n_samples: int = 1024,
) -> tuple[SplineGrid, torch.Tensor]:
    """Approximate a spline on a non-uniform knot sequence by a finer
    uniform grid (the paper's §II-B generality argument).

    ``knots``: the full extended non-uniform knot vector (``G_old + 2P + 1``
    values); ``coeff (K, G_old + P, N)``."""
    knots = np.asarray(knots, dtype=np.float64)
    x_min, x_max = float(knots[P]), float(knots[-P - 1])
    new_grid = SplineGrid(x_min, x_max, G_new, P)
    xs_np = np.linspace(x_min, x_max, n_samples)
    # the non-uniform basis by Cox-de Boor on the given knots, in numpy
    # (an offline refit)
    M_old = len(knots) - P - 1
    b = np.where(
        (xs_np[:, None] >= knots[None, :-1]) & (xs_np[:, None] < knots[None, 1:]), 1.0, 0.0)
    # Close the right edge of the last in-domain interval: with half-open
    # tests alone the sample at exactly x_max lands in no interval when the
    # right knots are repeated, and its basis row would be all zero.
    dom = np.where((knots[:-1] < knots[1:]) & (knots[1:] <= x_max + 1e-12))[0]
    last_dom = int(dom.max())
    on_edge = xs_np >= knots[last_dom + 1]
    b[on_edge] = 0.0
    b[on_edge, last_dom] = 1.0
    for p in range(1, P + 1):
        nb = np.zeros((n_samples, b.shape[1] - 1))
        for i in range(b.shape[1] - 1):
            d1 = knots[i + p] - knots[i]
            d2 = knots[i + p + 1] - knots[i + 1]
            left = ((xs_np - knots[i]) / d1) * b[:, i] if d1 > 0 else 0.0
            right = ((knots[i + p + 1] - xs_np) / d2) * b[:, i + 1] if d2 > 0 else 0.0
            nb[:, i] = left + right
        b = nb
    solve_dtype = torch.promote_types(coeff.dtype, torch.float32)
    xs = torch.as_tensor(xs_np, dtype=solve_dtype, device=coeff.device)
    B_old = torch.as_tensor(b[:, :M_old], dtype=solve_dtype, device=coeff.device)
    B_new = bspline.cox_de_boor_dense(xs, new_grid)
    return new_grid, _solve(B_new, B_old, coeff, new_grid.n_basis)
