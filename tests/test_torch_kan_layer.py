"""The port's KAN layer (``repro_torch.core.kan_layer``) and KAN FFN against
the JAX reference, fp32 on the CPU, and the port's method resolution.

Tolerance: layer outputs atol 1e-5 (fp32 sums over K*(P+1) or K*M terms
taken in another order by XLA and by torch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kan_layer as jkl
from repro.core.bspline import SplineGrid as JGrid
from repro.models import blocks as jblocks
from repro_torch.core import kan_layer as tkl
from repro_torch.core.bspline import SplineGrid
from repro_torch.kernels import ops
from repro_torch.models import blocks as tblocks

LAYER_ATOL = 1e-5


def _layer(G, P, K, N, lead, seed, with_base=True):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1.3, 1.3, lead + (K,)).astype(np.float32)
    p = {"coeff": (0.3 * rs.randn(K, G + P, N)).astype(np.float32)}
    if with_base:
        p["base_w"] = (0.3 * rs.randn(K, N)).astype(np.float32)
    return x, p


@pytest.mark.parametrize("method", ["dense", "compact"])
@pytest.mark.parametrize("G,P,K,N,lead,with_base", [
    (5, 3, 12, 7, (2, 3), True),
    (10, 3, 9, 5, (4,), False),
    (3, 2, 6, 11, (1, 2, 2), True),
])
def test_kan_layer_apply_matches_reference(method, G, P, K, N, lead, with_base):
    x, p = _layer(G, P, K, N, lead, seed=G * K + N, with_base=with_base)
    jgrid = JGrid(-1.0, 1.0, G, P)
    want = jax.jit(jkl.kan_layer_apply, static_argnums=(2, 3))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jgrid, method)
    got = tkl.kan_layer_apply({k: torch.tensor(v) for k, v in p.items()},
                              torch.tensor(x), SplineGrid(-1.0, 1.0, G, P), method)
    assert tuple(got.shape) == lead + (N,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL)


@pytest.mark.parametrize("method", ["dense", "compact"])
def test_bf16_activations_with_fp32_params_promote_like_the_reference(method):
    """bf16 compute with fp32 parameters: the basis is evaluated in bf16 on
    both sides, the contraction is promoted to fp32 (JAX's promotion), so
    the result is fp32; atol 1e-4 allows a few fp32 ulps of reordering."""
    x, p = _layer(5, 3, 12, 7, (6,), seed=11)
    want = jkl.kan_layer_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x).astype(jnp.bfloat16), JGrid(), method)
    got = tkl.kan_layer_apply({k: torch.tensor(v) for k, v in p.items()},
                              torch.tensor(x).bfloat16(), SplineGrid(), method)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("method", ["fused", "sparse", "auto"])
def test_kernel_methods_on_cpu_tensors_match_the_reference_layer(method):
    """On CPU tensors ``fused``/``sparse`` run the kernels' plain versions
    and ``auto`` resolves to ``compact``: all equal the reference layer."""
    x, p = _layer(5, 3, 16, 9, (3, 2), seed=4)
    want = jkl.kan_layer_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), JGrid(), "compact")
    ops.reset_launches()
    got = tkl.kan_layer_apply({k: torch.tensor(v) for k, v in p.items()},
                              torch.tensor(x), SplineGrid(), method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL)
    assert sum(ops.LAUNCHES.values()) == 0


def test_kan_ffn_matches_reference():
    rs = np.random.RandomState(0)
    d, ff = 16, 24
    grid, jgrid = SplineGrid(), JGrid()
    params = {"c1": 0.02 * rs.randn(d, grid.n_basis, ff), "b1": 0.02 * rs.randn(d, ff),
              "c2": 0.02 * rs.randn(ff, grid.n_basis, d), "b2": 0.02 * rs.randn(ff, d)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = (3 * rs.randn(2, 5, d)).astype(np.float32)
    want = jblocks._kan_ffn({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x), jgrid, method="auto")
    got = tblocks._kan_ffn({k: torch.tensor(v) for k, v in params.items()},
                           torch.tensor(x), grid, method="auto")
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 5, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL)


def test_resolve_inference_method(monkeypatch):
    monkeypatch.delenv("KAN_SAS_INFERENCE_METHOD", raising=False)
    monkeypatch.delenv("KAN_SAS_SPARSE_MAX_ROWS", raising=False)
    r = tkl.resolve_inference_method
    assert r("cuda", rows=1) == r("cuda", rows=8) == "sparse"
    assert r("cuda", rows=9) == r("cuda", rows=512) == r("cuda") == "fused"
    assert r(torch.device("cuda", 0), rows=4) == "sparse"
    assert r("cpu", rows=1) == r("cpu", rows=512) == "compact"
    assert r(rows=4) == "sparse"                        # entry points default to cuda
    monkeypatch.setenv("KAN_SAS_SPARSE_MAX_ROWS", "16")
    assert r("cuda", rows=16) == "sparse" and r("cuda", rows=17) == "fused"
    monkeypatch.setenv("KAN_SAS_INFERENCE_METHOD", "compact")
    assert r("cuda", rows=4) == r("cuda", rows=512) == "compact"
    monkeypatch.setenv("KAN_SAS_INFERENCE_METHOD", "fused")
    assert r("cpu", rows=1) == "fused"


def test_unknown_and_unported_methods_raise():
    x, p = _layer(5, 3, 4, 3, (2,), seed=1)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="unknown method"):
        tkl.kan_layer_apply(tp, torch.tensor(x), SplineGrid(), "bogus")
    # "lut" was the last unported method: it now runs, as the reference's
    got = tkl.kan_layer_apply(tp, torch.tensor(x), SplineGrid(), "lut")
    want = jkl.kan_layer_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                               JGrid(), "lut")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL)
