"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

This file imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
inputs, and the reduced kanformer's kernel path against the plain path on
the CPU.  Tolerances: fp32 atol 1e-4 (|y| ~ 2, sums in another order);
bf16 one bf16 ulp of max|y| (same products, fp32 sums in another order,
one final rounding); logits atol 1e-4.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs, set_ieee_fp32
from repro_torch.core.bspline import SplineGrid
from repro_torch.kernels import ops
from repro_torch.kernels import kan_fused_gemm as F
from repro_torch.kernels import kan_sparse_gemm as S
from repro_torch.models import lm

BF16_ULP = 2.0 ** -7
PLAIN = {"kan_fused_gemm": F.kan_fused_gemm_reference,
         "kan_sparse_gemm": S.kan_sparse_gemm_reference}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are compiled with nvcc for sm_90a")
    set_ieee_fp32()
    return torch.device("cuda")


def _inputs(grid, BS, K, N, seed, with_base):
    """tanh'd normals with x_min, x_max, every knot and out-of-domain values
    planted at the front."""
    rs = np.random.RandomState(seed)
    x = np.tanh(rs.randn(BS, K)).astype(np.float32)
    plant = np.concatenate([[grid.x_min, grid.x_max], grid.knots(), [-3.0, 2.5, -1.0001]])
    x.reshape(-1)[: min(len(plant), x.size)] = plant[: x.size]
    c = (0.1 * rs.randn(K, grid.n_basis, N)).astype(np.float32)
    w = (0.1 * rs.randn(K, N)).astype(np.float32) if with_base else None
    return x, c, w


@pytest.mark.cuda
@pytest.mark.parametrize("with_base", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BS,K,N", [(13, 100, 200), (512, 512, 1024), (4, 1024, 512),
                                    (1, 512, 1024), (8, 512, 1024)])
@pytest.mark.parametrize("name", ["kan_fused_gemm", "kan_sparse_gemm"])
@pytest.mark.parametrize("G,P", [(5, 3), (4, 3)])
def test_cuda_kernel_matches_plain_version(cuda_device, G, P, name, BS, K, N, dtype,
                                           with_base):
    grid = SplineGrid(-1.0, 1.0, G, P)
    x, c, w = _inputs(grid, BS, K, N, BS + K + N, with_base)
    tx, tc = (torch.tensor(a).to(dtype).to(cuda_device) for a in (x, c))
    tw = None if w is None else torch.tensor(w).to(dtype).to(cuda_device)
    ops.reset_launches()
    got = getattr(ops, name)(tx, tc, grid, tw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == 1 and got.dtype == dtype
    want = PLAIN[name](tx, tc, grid, tw)
    atol = 1e-4 if dtype == torch.float32 else BF16_ULP * want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.cuda
def test_sparse_kernel_workspace_serves_calls_of_every_shape(cuda_device):
    """Calls of growing and shrinking shapes on one stream share the sparse
    kernel's workspace (ticket counters and partials); each call still
    matches the plain version, and a repeated call is bit-equal."""
    grid = SplineGrid(-1.0, 1.0, 5, 3)
    for BS, K, N in [(1, 64, 128), (13, 100, 200), (512, 512, 1024), (4, 1024, 512),
                     (600, 96, 1000), (2, 33, 17)]:
        x, c, w = _inputs(grid, BS, K, N, BS * K + N, True)
        tx, tc, tw = (torch.tensor(a).to(cuda_device) for a in (x, c, w))
        got = ops.kan_sparse_gemm(tx, tc, grid, tw)
        assert torch.equal(got, ops.kan_sparse_gemm(tx, tc, grid, tw))
        want = S.kan_sparse_gemm_reference(tx, tc, grid, tw)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_reduced_kanformer_kernel_path_matches_plain_path(cuda_device):
    """Prefill (fused, 2x9 rows) and 3 decode steps (sparse, 2 rows) on the
    card against the plain path on the CPU."""
    model = configs.get_reduced("kanformer-100m").model
    params = lm.init_params(model, seed=0, device="cpu")
    gpu = {"embed": {k: v.to(cuda_device) for k, v in params["embed"].items()},
           "final_ln": {k: v.to(cuda_device) for k, v in params["final_ln"].items()},
           "unit": [{s: {k: v.to(cuda_device) for k, v in sub.items()}
                     for s, sub in params["unit"][0].items()}]}
    toks = torch.as_tensor(np.random.RandomState(0).randint(0, model.vocab, (2, 9)))
    ops.reset_launches()
    got, gc = lm.prefill(gpu, model, toks.to(cuda_device), 16)
    want, wc = lm.prefill(params, model, toks, 16)
    assert ops.LAUNCHES == {"kan_fused_gemm": 2 * model.n_repeats, "kan_sparse_gemm": 0}
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    pos = torch.tensor(9)
    for s in range(3):
        tok = toks[:, s:s + 1]
        got, gc = lm.decode_step(gpu, model, tok.to(cuda_device), gc, pos.to(cuda_device))
        want, wc = lm.decode_step(params, model, tok, wc, pos)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
        pos = pos + 1
    assert ops.LAUNCHES["kan_sparse_gemm"] == 3 * 2 * model.n_repeats
