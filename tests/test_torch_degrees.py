"""The fp32 KAN kernels at spline degrees P = 1 and 2, against the JAX
package on the CPU.

The fused and sparse CUDA kernels are compiled for P in {1, 2, 3}, as the
reference's Pallas kernels take any P.  Here their plain versions (what the
wrappers run on CPU tensors, and what the card's kernels are held against
in ``test_torch_cuda.py``) meet the Pallas kernels of ``repro.kernels.ops``
in interpret mode at (G, P) = (2, 1) and (3, 2) on a ragged shape, and a
GKAN net (Table II: ``[200, 16, 7]``, G=2, P=1) goes through
``kan_net_apply`` by every method against the reference's.

Tolerances: fp32 layer outputs atol 1e-5 (fp32 sums over K*M <= 100 terms
of size ~0.1 in another order); net outputs atol 1e-5 (sums over
K*(P+1) or K*M terms, two layers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kan_layer as jkl
from repro.core.bspline import SplineGrid as JGrid
from repro.kernels import ops as jops
from repro_torch.core import kan_layer as tkl
from repro_torch.core.bspline import SplineGrid
from repro_torch.kernels import build, ops
from repro_torch.kernels import kan_fused_gemm as F
from repro_torch.kernels import kan_sparse_gemm as S

FP32_ATOL = 1e-5
NET_ATOL = 1e-5
LOW_DEGREES = [(2, 1), (3, 2)]
JAX_TILES = {"kan_fused_gemm": dict(bb=16, bn=32, bk=8),
             "kan_sparse_gemm": dict(bb=8, bn=32, bk=8)}
GKAN = dict(layers=(200, 16, 7), G=2, P=1)          # benchmarks/workloads.py


@pytest.fixture(autouse=True)
def _isolated_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("KAN_SAS_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


def _inputs(grid, BS, K, N, seed, with_base=True):
    """tanh'd normals with x_min, x_max, every knot and out-of-domain values
    planted at the front."""
    rs = np.random.RandomState(seed)
    x = np.tanh(rs.randn(BS, K)).astype(np.float32)
    plant = np.concatenate([[grid.x_min, grid.x_max], grid.knots(), [-3.0, 2.5, -1.0001]])
    x.reshape(-1)[: min(len(plant), x.size)] = plant[: x.size]
    c = (0.1 * rs.randn(K, grid.n_basis, N)).astype(np.float32)
    w = (0.1 * rs.randn(K, N)).astype(np.float32) if with_base else None
    return x, c, w


@pytest.mark.parametrize("with_base", [True, False])
@pytest.mark.parametrize("G,P", LOW_DEGREES)
@pytest.mark.parametrize("name", ["kan_fused_gemm", "kan_sparse_gemm"])
def test_plain_version_matches_pallas_kernel_at_low_degree(name, G, P, with_base):
    """(13, 20, 24) is ragged against the reference's tiles in every
    dimension, so the reference pads and the port masks."""
    grid = SplineGrid(-1.0, 1.0, G, P)
    x, c, w = _inputs(grid, 13, 20, 24, seed=10 * G + P, with_base=with_base)
    want = getattr(jops, name)(jnp.asarray(x), jnp.asarray(c), JGrid(-1.0, 1.0, G, P),
                               base_w=None if w is None else jnp.asarray(w), interpret=True,
                               **JAX_TILES[name])
    plain = F.kan_fused_gemm_reference if name == "kan_fused_gemm" else \
        S.kan_sparse_gemm_reference
    got = plain(torch.tensor(x), torch.tensor(c), grid,
                None if w is None else torch.tensor(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (13, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("launcher", [F.kan_fused_gemm_cuda, S.kan_sparse_gemm_cuda])
def test_cuda_launchers_take_every_compiled_degree(launcher, P, monkeypatch, tmp_path):
    """A grid of degree 1, 2 or 3 passes the launcher's checks and reaches
    the build, which, with no nvcc, raises."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    grid = SplineGrid(-1.0, 1.0, 2, P)
    x = torch.empty(4, 16, device="meta")
    c = torch.empty(16, grid.n_basis, 8, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        launcher(x, c, grid)


def _gkan_params(seed=0):
    rs = np.random.RandomState(seed)
    M = GKAN["G"] + GKAN["P"]
    return [{"coeff": (0.3 * rs.randn(K, M, N)).astype(np.float32),
             "base_w": (0.3 * rs.randn(K, N)).astype(np.float32)}
            for K, N in zip(GKAN["layers"][:-1], GKAN["layers"][1:])]


@pytest.mark.parametrize("method", ["dense", "compact", "lut", "fused", "sparse", "auto"])
@pytest.mark.parametrize("rows", [5, 12])
def test_gkan_net_apply_matches_reference(method, rows):
    """GKAN (P = 1, M = 3) by every method of the port against the
    reference's ``dense`` (``lut`` against the reference's ``lut``);
    ``fused``, ``sparse`` and ``auto`` run the kernels' plain versions on
    the CPU, with the launch counts left at zero."""
    tcfg, jcfg = tkl.KANNetConfig(**GKAN), jkl.KANNetConfig(**GKAN)
    params = _gkan_params()
    rs = np.random.RandomState(rows)
    x = rs.uniform(-1.2, 1.2, (rows, GKAN["layers"][0])).astype(np.float32)
    plant = np.concatenate([[-1.0, 1.0], tcfg.grid().knots()])
    x.reshape(-1)[: plant.size] = plant
    tp = [{k: torch.tensor(v) for k, v in p.items()} for p in params]
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    want = np.asarray(jkl.kan_net_apply(jp, jnp.asarray(x), jcfg,
                                        method="lut" if method == "lut" else "dense"))
    ops.reset_launches()
    got = tkl.kan_net_apply(tp, torch.tensor(x), tcfg, method=method)
    assert all(v == 0 for v in ops.LAUNCHES.values())
    assert got.shape == (rows, GKAN["layers"][-1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NET_ATOL)
