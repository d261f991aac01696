"""The port's grid refit (``core/grid.py``) and the gradient of its
Cox-de Boor basis against the JAX package, on the CPU.

Tolerances: refit coefficients (|c| ~ 2) atol 1e-4 in fp32, since the two
least-squares solvers differ (JAX's SVD-based ``lstsq`` against torch's QR
``gels``; up to 1.3e-5 apart here); in bf16 one bf16 ulp of max|c| (the
fp32 solutions round to neighbouring bf16 values in ~8 % of entries).
Basis gradients rtol/atol 1e-5: the same float32 recurrences, one ulp or so.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bspline as jbs
from repro.core import grid as jgr
from repro_torch.core import bspline as tbs
from repro_torch.core import grid as tgr

REFIT_ATOL = 1e-4
GRAD_TOL = 1e-5
GRIDS = [(-1.0, 1.0, 5, 3), (-1.0, 1.0, 10, 3), (-1.0, 1.0, 3, 2), (-1.0, 1.0, 2, 1),
         (-2.0, 0.5, 7, 3)]


def _grids(spec):
    return tbs.SplineGrid(*spec), jbs.SplineGrid(*spec)


def _jit(fn, *args, **kw):
    """The reference function with its static arguments bound, jitted
    (one compile instead of one per eager op)."""
    return jax.jit(functools.partial(fn, *args, **kw))


@pytest.mark.parametrize("factor", [1, 2, 3])
@pytest.mark.parametrize("spec", GRIDS[:3])
def test_refine_grid_matches_reference(spec, factor):
    tg, jg = _grids(spec)
    got, want = tgr.refine_grid(tg, factor), jgr.refine_grid(jg, factor)
    assert (got.x_min, got.x_max, got.G, got.P) == (want.x_min, want.x_max, want.G, want.P)


@pytest.mark.parametrize("factor,n_samples", [(2, 512), (3, 200), (1, 64)])
@pytest.mark.parametrize("spec", GRIDS[:3])
def test_refit_coefficients_matches_reference(spec, factor, n_samples):
    tg, jg = _grids(spec)
    c = np.random.RandomState(factor).randn(3, tg.n_basis, 4).astype(np.float32)
    want = np.asarray(_jit(jgr.refit_coefficients, old_grid=jg,
                           new_grid=jgr.refine_grid(jg, factor), n_samples=n_samples)(c))
    got = tgr.refit_coefficients(torch.tensor(c), tg, tgr.refine_grid(tg, factor),
                                 n_samples=n_samples)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REFIT_ATOL)


def test_refit_bf16_coefficients():
    """The solve is promoted to fp32: a bf16 refit lands within bf16
    resolution of the fp32 refit, and within one bf16 ulp of the
    reference's bf16 refit (as ``tests/test_boundary.py`` holds the
    reference)."""
    tg, jg = _grids((-1.0, 1.0, 5, 3))
    c32 = np.random.RandomState(0).randn(3, tg.n_basis, 4).astype(np.float32)
    ref = tgr.refit_coefficients(torch.tensor(c32), tg, tgr.refine_grid(tg, 2), n_samples=128)
    got = tgr.refit_coefficients(torch.tensor(c32).bfloat16(), tg, tgr.refine_grid(tg, 2),
                                 n_samples=128)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    scale = ref.abs().max().item()
    assert (got.float() - ref).abs().max().item() / scale < 5e-2
    want = _jit(jgr.refit_coefficients, old_grid=jg, new_grid=jgr.refine_grid(jg, 2),
                n_samples=128)(jnp.asarray(c32).astype(jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=2.0 ** -7 * scale)


@pytest.mark.parametrize("knots,G_new", [
    ([-1.6, -1.4, -1.2, -1.0, -0.7, -0.1, 0.2, 0.6, 1.0, 1.1, 1.3, 1.6], 12),
    ([-1.0, -1.0, -1.0, -1.0, -0.5, 0.3, 1.0, 1.0, 1.0, 1.0], 8),      # clamped ends
])
def test_nonuniform_to_uniform_matches_reference(knots, G_new):
    P = 3
    c = np.random.RandomState(1).randn(2, len(knots) - P - 1, 3).astype(np.float32)
    jg, want = jgr.nonuniform_to_uniform(np.asarray(knots), jnp.asarray(c), P, G_new)
    tg, got = tgr.nonuniform_to_uniform(np.asarray(knots), torch.tensor(c), P, G_new)
    assert (tg.x_min, tg.x_max, tg.G, tg.P) == (jg.x_min, jg.x_max, jg.G, jg.P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=REFIT_ATOL)


def _points(grid, where):
    rs = np.random.RandomState(3)
    if where == "x_min":
        return np.full(4, grid.x_min, np.float32)
    if where == "x_max":
        return np.full(4, grid.x_max, np.float32)
    if where == "inside":
        inner = grid.knots()[grid.P + 1:grid.n_basis]      # the inner knots too
        return np.concatenate([inner, rs.uniform(grid.x_min, grid.x_max, 40)]).astype(np.float32)
    return np.concatenate([rs.uniform(grid.x_max + 0.01, grid.x_max + 2, 20),
                           rs.uniform(grid.x_min - 2, grid.x_min - 0.01, 20)]).astype(np.float32)


@pytest.mark.parametrize("where", ["x_min", "x_max", "inside", "outside"])
def test_basis_gradient_matches_jax_grad(where):
    """d/dx of a weighted sum of every basis value, against ``jax.grad`` of
    the reference: at an input exactly on a bound ``jnp.clip`` passes half
    the gradient to x (the other half to the bound), and so must the port's
    clamp; inside the domain the whole of it, outside none."""
    for spec in GRIDS:
        tg, jg = _grids(spec)
        x = _points(tg, where)
        w = np.random.RandomState(4).randn(x.size, tg.n_basis).astype(np.float32)
        want = jax.jit(jax.grad(lambda v: jnp.sum(jbs.cox_de_boor_dense(v, jg) * w)))(x)
        xt = torch.tensor(x, requires_grad=True)
        (tbs.cox_de_boor_dense(xt, tg) * torch.tensor(w)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"grid {spec}")
