"""The port's KAN kernels against the JAX reference, fp32/bf16 on the CPU.

On the CPU the wrappers in ``repro_torch.kernels.ops`` run each kernel's
plain PyTorch version; these tests hold those against the Pallas kernels of
``repro.kernels.ops`` run in interpret mode with explicit tiles (ragged
shapes, so the reference pads and the port masks).  The CUDA kernels
themselves are compiled and run only on a card: ``test_torch_cuda.py``
holds them against the plain versions there.

Tolerances: ``k`` exactly equal; basis values atol 1e-6; fp32 layer
outputs atol 1e-5 (fp32 sums over K*M <= 200 terms of size ~0.1, taken in
another order); bf16 outputs within one bf16 ulp of max|y| (both sides
multiply the same bf16-rounded operands exactly and accumulate in fp32,
then round once to bf16, where a different summation order can flip the
last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bspline import SplineGrid as JGrid
from repro.kernels import common as jcommon
from repro.kernels import ops as jops
from repro_torch.core.bspline import SplineGrid
from repro_torch.kernels import build, common, ops
from repro_torch.kernels import kan_fused_gemm as F
from repro_torch.kernels import kan_sparse_gemm as S

VALUE_ATOL = 1e-6
FP32_ATOL = 1e-5
BF16_ULP = 2.0 ** -7
GRID = (-1.0, 1.0, 5, 3)
# (BS, K, N): ragged against the reference tiles below in every dimension
SHAPES = [(13, 20, 24), (3, 9, 40)]
JAX_TILES = {"kan_fused_gemm": dict(bb=16, bn=32, bk=8),
             "kan_sparse_gemm": dict(bb=8, bn=32, bk=8)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _isolated_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("KAN_SAS_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


def _inputs(grid, BS, K, N, seed, with_base=True):
    """tanh'd normals (what the KAN FFN feeds) with x_min, x_max, every knot
    and out-of-domain values planted at the front."""
    rs = np.random.RandomState(seed)
    x = np.tanh(rs.randn(BS, K)).astype(np.float32)
    plant = np.concatenate([[grid.x_min, grid.x_max], grid.knots(), [-3.0, 2.5, -1.0001]])
    x.reshape(-1)[: min(len(plant), x.size)] = plant[: x.size]
    c = (0.1 * rs.randn(K, grid.n_basis, N)).astype(np.float32)
    w = (0.1 * rs.randn(K, N)).astype(np.float32) if with_base else None
    return x, c, w


def _both(a, dtype):
    tdt, jdt = DTYPES[dtype]
    if a is None:
        return None, None
    return torch.tensor(a).to(tdt), jnp.asarray(a).astype(jdt)


def _assert_close(got: torch.Tensor, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    atol = FP32_ATOL if dtype == "float32" else BF16_ULP * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ----------------------------------------------------------------- helpers


def test_cardinal_values_inblock_matches_reference():
    xa = np.linspace(0.0, 1.0, 101).astype(np.float32)
    for P in (1, 2, 3):
        np.testing.assert_allclose(
            common.cardinal_values_inblock(torch.tensor(xa), P).numpy(),
            np.asarray(jax.jit(jcommon.cardinal_values_inblock, static_argnums=1)(
                jnp.asarray(xa), P)),
            atol=VALUE_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compact_basis_inblock_band_and_slabs_match_reference(dtype):
    grid = SplineGrid(*GRID)
    jgrid = JGrid(*GRID)
    x, c, _ = _inputs(grid, 6, 11, 5, seed=3)
    tx, jx = _both(x, dtype)
    tv, tk = common.compact_basis_inblock(tx, grid)
    jv, jk = jax.jit(jcommon.compact_basis_inblock, static_argnums=1)(jx, jgrid)
    assert tv.dtype == torch.float32 and tk.dtype == torch.int32   # fp32 for bf16 too
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=VALUE_ATOL)
    np.testing.assert_array_equal(
        common.band_scatter(tv, tk, grid.n_basis).numpy(),
        np.asarray(jcommon.band_scatter(jnp.asarray(tv.numpy()), jk, grid.n_basis)))
    np.testing.assert_array_equal(
        common.gather_coeff_slabs(torch.tensor(c), tk, grid.P).numpy(),
        np.asarray(jcommon.gather_coeff_slabs(jnp.asarray(c), jk, grid.P)))


# ------------------------------------------- plain versions vs the Pallas kernels


@pytest.mark.parametrize("with_base", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BS,K,N", SHAPES)
@pytest.mark.parametrize("name", ["kan_fused_gemm", "kan_sparse_gemm"])
def test_plain_version_matches_pallas_kernel(name, BS, K, N, dtype, with_base):
    grid = SplineGrid(*GRID)
    x, c, w = _inputs(grid, BS, K, N, seed=BS * K + N, with_base=with_base)
    (tx, jx), (tc, jc), (tw, jw) = _both(x, dtype), _both(c, dtype), _both(w, dtype)
    want = getattr(jops, name)(jx, jc, JGrid(*GRID), base_w=jw, interpret=True,
                               **JAX_TILES[name])
    got = getattr(ops, name)(tx, tc, grid, tw)
    assert got.dtype == tx.dtype and tuple(got.shape) == (BS, N)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("name", ["kan_fused_gemm", "kan_sparse_gemm"])
def test_cpu_wrapper_flattens_leading_dims_and_counts_no_launch(name):
    grid = SplineGrid(*GRID)
    x, c, w = _inputs(grid, 6, 10, 7, seed=5)
    ops.reset_launches()
    y = getattr(ops, name)(torch.tensor(x).reshape(2, 3, 10), torch.tensor(c), grid,
                           torch.tensor(w))
    assert tuple(y.shape) == (2, 3, 7)
    flat = getattr(ops, name)(torch.tensor(x), torch.tensor(c), grid, torch.tensor(w))
    torch.testing.assert_close(y.reshape(6, 7), flat, rtol=0, atol=0)
    assert ops.LAUNCHES == {"kan_fused_gemm": 0, "kan_sparse_gemm": 0, "gather_blocks": 0,
                            "kan_int8_gemm": 0, "kan_sparse_int8_gemm": 0, "bspline_lut": 0}


def test_fused_and_sparse_plain_versions_agree():
    """The sparse kernel skips only the zero MACs of the fused one."""
    grid = SplineGrid(*GRID)
    x, c, w = _inputs(grid, 9, 33, 17, seed=9)
    args = (torch.tensor(x), torch.tensor(c), grid, torch.tensor(w))
    torch.testing.assert_close(F.kan_fused_gemm_reference(*args),
                               S.kan_sparse_gemm_reference(*args), rtol=0, atol=FP32_ATOL)


# ----------------------------------- the CUDA path: launch or raise, never fall back


@pytest.mark.parametrize("name", ["kan_fused_gemm", "kan_sparse_gemm"])
def test_non_cpu_tensor_never_takes_the_plain_version(name, monkeypatch, tmp_path):
    """A tensor off the CPU goes to the CUDA launcher.  With no nvcc to
    build the kernel that raises, and no launch is counted."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    grid = SplineGrid(*GRID)
    x = torch.empty(4, 16, device="meta")
    c = torch.empty(16, grid.n_basis, 8, device="meta")
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        getattr(ops, name)(x, c, grid)
    assert ops.LAUNCHES[name] == 0


@pytest.mark.parametrize("launcher", [F.kan_fused_gemm_cuda, S.kan_sparse_gemm_cuda])
def test_cuda_launchers_reject_what_the_kernels_do_not_take(launcher):
    grid = SplineGrid(*GRID)
    x = torch.zeros(4, 16)
    c = torch.zeros(16, grid.n_basis, 8)
    with pytest.raises(ValueError, match="does not match"):
        launcher(x, torch.zeros(15, grid.n_basis, 8), grid)
    with pytest.raises(ValueError, match="compiled for P in"):
        launcher(x, torch.zeros(16, 9, 8), SplineGrid(-1.0, 1.0, 5, 4))
    with pytest.raises(ValueError, match="dtype"):
        launcher(x.double(), c.double(), grid)
    with pytest.raises(ValueError, match="contiguous"):
        launcher(torch.zeros(16, 4).t(), c, grid)
    with pytest.raises(ValueError, match="base_w"):
        launcher(x, c, grid, torch.zeros(16, 9))


def test_sparse_launcher_rejects_a_band_wider_than_its_compiled_width():
    """The sparse kernel's band is a compile-time 8 or 16 slots (M = G+P <=
    16, so MNIST-KAN's G=10 runs)."""
    grid = SplineGrid(-1.0, 1.0, 14, 3)
    assert grid.n_basis == S.MAX_M + 1 == 17
    with pytest.raises(ValueError, match="M=G\\+P <= 16"):
        S.kan_sparse_gemm_cuda(torch.zeros(4, 16), torch.zeros(16, grid.n_basis, 8), grid)


def test_build_names_libraries_by_source_and_flags():
    paths = {n: build._lib_path(n) for n in build.LIBRARIES}
    assert len(set(paths.values())) == len(paths)
    for n, p in paths.items():
        assert p.parent == build.BUILD_DIR and p.name.startswith(n + "-")
    assert "-use_fast_math" not in " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in build.ARCH_FLAGS
