"""The port's B-spline math (``repro_torch.core.bspline``) against the JAX
reference (``repro.core.bspline``), fp32 on the CPU.

Tolerances: interval indices ``k`` must be exactly equal, and the dense
scatter exactly zero outside each input's window; basis values within atol
1e-6 (the same Cox-de Boor
operations in fp32, evaluated by XLA and by torch).  Inputs include
``x_min``, ``x_max``, every knot and out-of-domain values: the boundary
convention of ``tests/test_boundary.py`` is the spec.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bspline as jbs
from repro_torch.core import bspline as tbs

VALUE_ATOL = 1e-6
GRIDS = [(-1.0, 1.0, 5, 3), (-1.0, 1.0, 3, 2), (-1.0, 1.0, 10, 3),
         (-1.0, 1.0, 2, 1), (-2.0, 3.0, 4, 4)]


def _points(grid: tbs.SplineGrid, n: int = 200, seed: int = 0) -> np.ndarray:
    """Random in-domain points plus x_min, x_max, every extended knot and
    out-of-domain values on both sides."""
    rs = np.random.RandomState(seed)
    span = grid.x_max - grid.x_min
    inside = rs.uniform(grid.x_min, grid.x_max, n)
    special = np.concatenate([grid.knots(), [
        grid.x_min, grid.x_max, grid.x_min - 0.5 * span, grid.x_max + 0.5 * span,
        grid.x_min - 5 * span, grid.x_max + 5 * span]])
    return np.concatenate([special, inside]).astype(np.float32)


def _grids(spec):
    x_min, x_max, G, P = spec
    return tbs.SplineGrid(x_min, x_max, G, P), jbs.SplineGrid(x_min, x_max, G, P)


@pytest.mark.parametrize("spec", GRIDS)
def test_spline_grid_fields_and_properties_match(spec):
    tg, jg = _grids(spec)
    for name in ("x_min", "x_max", "G", "P", "delta", "n_basis", "n_nonzero",
                 "t0", "t_last"):
        assert getattr(tg, name) == getattr(jg, name), name
    np.testing.assert_array_equal(tg.knots(), jg.knots())
    assert tg.half_cols() == jg.half_cols()


def test_spline_grid_rejects_bad_grids():
    for bad in [dict(G=0), dict(P=0), dict(x_min=1.0, x_max=1.0)]:
        with pytest.raises(ValueError):
            tbs.SplineGrid(**bad)


@pytest.mark.parametrize("spec", GRIDS)
def test_cox_de_boor_dense_matches_reference(spec):
    tg, jg = _grids(spec)
    x = _points(tg)
    got = tbs.cox_de_boor_dense(torch.tensor(x), tg).numpy()
    want = np.asarray(jax.jit(jbs.cox_de_boor_dense, static_argnums=1)(jnp.asarray(x), jg))
    assert got.shape == want.shape == x.shape + (tg.n_basis,)
    np.testing.assert_allclose(got, want, atol=VALUE_ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)   # partition of unity


@pytest.mark.parametrize("spec", GRIDS)
def test_align_and_interval_index_match_reference(spec):
    tg, jg = _grids(spec)
    x = _points(tg, seed=1)
    np.testing.assert_allclose(tbs.align(torch.tensor(x), tg).numpy(),
                               np.asarray(jbs.align(jnp.asarray(x), jg)), atol=VALUE_ATOL)
    k = tbs.interval_index(torch.tensor(x), tg)
    assert k.dtype == torch.int32
    np.testing.assert_array_equal(k.numpy(),
                                  np.asarray(jbs.interval_index(jnp.asarray(x), jg)))


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_cardinal_bspline_matches_reference(P):
    u = np.linspace(-0.5, P + 1.5, 301).astype(np.float32)
    np.testing.assert_allclose(tbs.cardinal_bspline(torch.tensor(u), P).numpy(),
                               np.asarray(jbs.cardinal_bspline(jnp.asarray(u), P)),
                               atol=VALUE_ATOL)


@pytest.mark.parametrize("spec", GRIDS)
def test_compact_basis_and_dense_scatter_match_reference(spec):
    tg, jg = _grids(spec)
    x = _points(tg, seed=2)
    x = x[: len(x) // 2 * 2].reshape(-1, 2)           # leading dims carried
    tv, tk = tbs.compact_basis(torch.tensor(x), tg)
    jv, jk = jax.jit(jbs.compact_basis, static_argnums=1)(jnp.asarray(x), jg)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=VALUE_ATOL)
    dense = tbs.compact_to_dense(tv, tk, tg).numpy()
    want = np.asarray(jbs.compact_to_dense(jv, jk, jg))
    rel = np.arange(tg.n_basis) - (tk.numpy()[..., None] - tg.P)
    outside = (rel < 0) | (rel > tg.P)
    assert not dense[outside].any() and not want[outside].any()
    np.testing.assert_allclose(dense, want, atol=VALUE_ATOL)
    # the compact path agrees with the dense oracle on the port's side too
    np.testing.assert_allclose(dense, tbs.cox_de_boor_dense(torch.tensor(x), tg).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("spec", GRIDS)
def test_x_max_activates_last_interval_and_out_of_domain_saturates(spec):
    tg, _ = _grids(spec)
    span = tg.x_max - tg.x_min
    x = torch.tensor([tg.x_max, tg.x_max + span, tg.x_min, tg.x_min - span],
                     dtype=torch.float32)
    k = tbs.interval_index(x, tg)
    assert k.tolist() == [tg.n_basis - 1] * 2 + [tg.P] * 2
    dense = tbs.cox_de_boor_dense(x, tg)
    torch.testing.assert_close(dense[0], dense[1])     # saturates to x_max's row
    torch.testing.assert_close(dense[2], dense[3])     # saturates to x_min's row
    assert dense[0].max() > 0.1
