"""The port's tabulated B-spline path and KAN stacks against the JAX
package, fp32 on the CPU.

``build_lut``, ``lut_basis_compact``/``lut_basis_dense``, the ``lut``
method of ``kan_layer_apply`` (through ``ops.bspline_lut``, whose plain
version runs on CPU tensors), and ``kan_net_apply`` for every method on a
narrow MNIST-KAN-shaped net ``[40, 24, 10]``, G=10, P=3.

Tolerances: ``k`` and LUT addresses exactly equal; table and basis values
atol 1e-6 (the port's float32 Cox-de Boor table differs from the
reference's by up to one ulp, 1.2e-7 for P=3), exactly equal when both
sides read the reference's table; net outputs atol 1e-5 (fp32 sums over
K*(P+1) or K*M terms in another order, through two layers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bspline as jbs
from repro.core import kan_layer as jkl
from repro_torch.core import bspline as tbs
from repro_torch.core import kan_layer as tkl

VALUE_ATOL = 1e-6
NET_ATOL = 1e-5
GRIDS = [(-1.0, 1.0, 5, 3), (-1.0, 1.0, 10, 3), (-1.0, 1.0, 3, 2), (-1.0, 1.0, 2, 1)]
NET = dict(layers=(40, 24, 10), G=10, P=3)


def _grids(spec):
    x_min, x_max, G, P = spec
    return tbs.SplineGrid(x_min, x_max, G, P), jbs.SplineGrid(x_min, x_max, G, P)


def _points(grid, n=300, seed=0):
    """Uniform over [-1.2, 1.2] with x_min, x_max and every knot planted."""
    rs = np.random.RandomState(seed)
    special = np.concatenate([[grid.x_min, grid.x_max], grid.knots(), [-3.0, 2.5]])
    return np.concatenate([special, rs.uniform(-1.2, 1.2, n)]).astype(np.float32)


@pytest.mark.parametrize("S", [256, 4096, 100])
@pytest.mark.parametrize("P", [1, 2, 3])
def test_build_lut_matches_reference(P, S):
    got, want = tbs.build_lut(P, S), jbs.build_lut(P, S)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=VALUE_ATOL)
    np.testing.assert_allclose(tbs.build_lut(P, S, dtype=np.float64), got)


@pytest.mark.parametrize("spec", GRIDS)
def test_lut_basis_matches_reference(spec):
    tg, jg = _grids(spec)
    x = _points(tg)
    x = x[: x.size // 2 * 2].reshape(-1, 2)                # leading dims carried
    jlut = jbs.build_lut(tg.P, 256)
    jv, jk = jbs.lut_basis_compact(jnp.asarray(x), jg, jnp.asarray(jlut))
    # exact on the reference's table
    tv, tk = tbs.lut_basis_compact(torch.tensor(x), tg, torch.tensor(jlut))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        tbs.lut_basis_dense(torch.tensor(x), tg, torch.tensor(jlut)).numpy(),
        np.asarray(jbs.lut_basis_dense(jnp.asarray(x), jg, jnp.asarray(jlut))))
    # within one table ulp on the port's own table
    tv2, tk2 = tbs.lut_basis_compact(torch.tensor(x), tg, torch.tensor(tbs.build_lut(tg.P)))
    assert torch.equal(tk2, tk)
    np.testing.assert_allclose(tv2.numpy(), np.asarray(jv), rtol=0, atol=VALUE_ATOL)
    # and within the table's resolution of the exact basis
    exact, _ = tbs.compact_basis(torch.tensor(x), tg)
    np.testing.assert_allclose(tv2.numpy(), exact.numpy(), atol=2e-2)


def test_lut_address_rounds_half_to_even():
    """An offset exactly halfway between two addresses takes the even one,
    as ``jnp.round`` does (S=3: x_a = 0.25 -> addr 0, 0.75 -> addr 2)."""
    tg, jg = _grids((-1.0, 1.0, 4, 1))
    lut = np.asarray([[0.0], [0.5], [1.0]], np.float32)
    x = np.asarray([-1.0 + 0.25 * 0.5, -1.0 + 0.75 * 0.5], np.float32)   # delta = 0.5
    tv, _ = tbs.lut_basis_compact(torch.tensor(x), tg, torch.tensor(lut))
    jv, _ = jbs.lut_basis_compact(jnp.asarray(x), jg, jnp.asarray(lut))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_kan_net_config_and_init_match_reference_shapes_and_scales():
    tcfg, jcfg = tkl.KANNetConfig(**NET), jkl.KANNetConfig(**NET)
    for f in ("layers", "G", "P", "x_min", "x_max", "base", "layer_norm"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.grid() == tbs.SplineGrid(-1.0, 1.0, 10, 3)
    big = tkl.KANNetConfig(layers=(400, 300, 10), G=10, P=3)
    params = tkl.init_kan_net(big, seed=3, device="cpu")
    again = tkl.init_kan_net(big, seed=3, device="cpu")
    assert all(torch.equal(a[k], b[k]) for a, b in zip(params, again) for k in a)
    for (K, N), p in zip([(400, 300), (300, 10)], params):
        assert p["coeff"].shape == (K, 13, N) and p["base_w"].shape == (K, N)
        assert p["coeff"].dtype == torch.float32
        # the reference's scales: 0.1/sqrt(K (P+1)) and sqrt(2/K)
        np.testing.assert_allclose(p["coeff"].std().item(), 0.1 / np.sqrt(4 * K), rtol=0.05)
        np.testing.assert_allclose(p["base_w"].std().item(), np.sqrt(2.0 / K), rtol=0.05)
    nobase = tkl.init_kan_net(tkl.KANNetConfig(layers=(4, 3), base=False), device="cpu")
    assert set(nobase[0]) == {"coeff"}


def _net_params(seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for K, N in zip(NET["layers"][:-1], NET["layers"][1:]):
        out.append({"coeff": (0.3 * rs.randn(K, NET["G"] + NET["P"], N)).astype(np.float32),
                    "base_w": (0.3 * rs.randn(K, N)).astype(np.float32)})
    return out


@pytest.mark.parametrize("method", ["dense", "compact", "lut", "fused", "sparse", "auto"])
@pytest.mark.parametrize("rows", [7, 33])
def test_kan_net_apply_matches_reference(method, rows):
    """Every method of the port against the reference's ``dense`` (``lut``
    against the reference's ``lut``); ``fused``, ``sparse`` and ``auto`` run
    the kernels' plain versions on the CPU (``sparse`` with M = 13)."""
    tcfg, jcfg = tkl.KANNetConfig(**NET), jkl.KANNetConfig(**NET)
    params = _net_params()
    x = _points(tcfg.grid(), n=rows * 40, seed=rows)[: rows * 40].reshape(rows, 40)
    tp = [{k: torch.tensor(v) for k, v in p.items()} for p in params]
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    jmethod = "lut" if method == "lut" else "dense"
    want = np.asarray(jkl.kan_net_apply(jp, jnp.asarray(x), jcfg, method=jmethod))
    got = tkl.kan_net_apply(tp, torch.tensor(x), tcfg, method=method)
    assert got.shape == (rows, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NET_ATOL)
    if method == "lut":       # the reference's own table: the same within fp32 sums
        lut = jbs.build_lut(3)
        got = tkl.kan_net_apply(tp, torch.tensor(x), tcfg, method="lut", lut=torch.tensor(lut))
        want = jkl.kan_net_apply(jp, jnp.asarray(x), jcfg, method="lut", lut=jnp.asarray(lut))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=NET_ATOL)


def test_lut_path_runs_through_the_lut_wrapper():
    from repro_torch.kernels import ops

    tcfg = tkl.KANNetConfig(**NET)
    params = tkl.init_kan_net(tcfg, seed=1, device="cpu")
    calls = []
    real = ops.bspline_lut
    try:
        ops.bspline_lut = lambda *a: calls.append(a[0].shape) or real(*a)
        tkl.kan_net_apply(params, torch.zeros(3, 40), tcfg, method="lut")
    finally:
        ops.bspline_lut = real
    assert calls == [(3, 40), (3, 24)]
