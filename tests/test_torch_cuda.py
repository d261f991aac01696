"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

This file imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
inputs, and the reduced kanformer's kernel path against the plain path on
the CPU.  The threefry port's integers and uniforms on the card equal the
CPU's; its Gumbel noise is held within 1e-5, and sampled tokens and streams
equal the CPU's unless the first divergence is a near-tie of the perturbed
scores.  Tolerances: fp32 atol 1e-4 (|y| ~ 2, sums in another order);
bf16 one bf16 ulp of max|y| (same products, fp32 sums in another order,
one final rounding); logits atol 1e-4.  The block-table gather moves data
only and must be bit-equal to its plain version.  The integer kernels
(``kan_int8_gemm``, ``kan_sparse_int8_gemm``) must be bit-equal to their
plain versions and to each other, with and without the dequant epilogue,
and read every ROM address as ``build_lut_u8`` holds it; the B-spline LUT
kernel's values and ``k`` must equal its plain version's exactly.  ConvKAN
through the fused kernel is held within 2^-16 of max|y| of its plain version
(K up to 4608); training steps on the card against the CPU's within 1e-5
of each Adam moment's max and 1e-2 lr on parameters.
"""

import ctypes
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs, set_ieee_fp32
from repro_torch.core import kan_layer as KL
from repro_torch.core import quantization as Q
from repro_torch.core.bspline import SplineGrid, build_lut
from repro_torch.kernels import bspline_lut as L
from repro_torch.kernels import build
from repro_torch.kernels import kan_int8_gemm as I8
from repro_torch.kernels import ops
from repro_torch.kernels import kan_fused_gemm as F
from repro_torch.kernels import kan_sparse_gemm as S
from repro_torch.kernels import paged_gather as G
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, ServeConfig

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
                                    (1, 512, 1024), (8, 512, 1024), (2048, 784, 64),
                                    (129, 1024, 512), (512, 1000, 130)])
@pytest.mark.parametrize("name", ["kan_fused_gemm", "kan_sparse_gemm"])
@pytest.mark.parametrize("G,P", [(5, 3), (4, 3), (10, 3), (13, 3), (2, 1), (3, 2)])
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
@pytest.mark.parametrize("name", ["kan_fused_gemm", "kan_sparse_gemm"])
def test_fp32_kernels_raise_on_an_uncompiled_degree(cuda_device, name):
    """P = 4 is not compiled: the wrapper raises before any launch, and
    nothing falls back to the plain version."""
    grid = SplineGrid(-1.0, 1.0, 5, 4)
    x = torch.zeros(4, 16, device=cuda_device)
    c = torch.zeros(16, grid.n_basis, 8, device=cuda_device)
    ops.reset_launches()
    with pytest.raises(ValueError, match="compiled for P in"):
        getattr(ops, name)(x, c, grid)
    assert all(v == 0 for v in ops.LAUNCHES.values())


@pytest.mark.cuda
def test_gkan_net_auto_on_card_runs_both_kernels(cuda_device):
    """GKAN ([200, 16, 7], G=2, P=1): ``kan_net_apply(method="auto")``
    through the sparse kernel at 8 rows and the fused one at 40, each
    within fp32 sums of the plain ``compact`` path on the card."""
    cfg = KL.KANNetConfig(layers=(200, 16, 7), G=2, P=1)
    params = KL.init_kan_net(cfg, seed=0, device="cuda")
    x = torch.rand(40, 200, device=cuda_device) * 2.4 - 1.2
    for rows, kernel in ((8, "kan_sparse_gemm"), (40, "kan_fused_gemm")):
        ops.reset_launches()
        got = KL.kan_net_apply(params, x[:rows], cfg, method="auto")
        torch.cuda.synchronize()
        assert ops.LAUNCHES[kernel] == 2 and sum(ops.LAUNCHES.values()) == 2
        want = KL.kan_net_apply(params, x[:rows], cfg, method="compact")
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,P,BS,K,N", [(10, 3, 8, 784, 64), (10, 3, 8, 64, 10),
                                        (2, 1, 8, 200, 16), (2, 1, 8, 16, 7),
                                        (5, 3, 1, 64, 128), (5, 3, 4, 512, 1024),
                                        (5, 3, 8, 1024, 512), (5, 3, 3, 2810, 512)])
def test_sparse_kernel_writes_only_the_workspace_it_exports(cuda_device, G, P, BS, K, N,
                                                            dtype):
    """Given tickets and partials of exactly the sizes the library exports
    (``kan_sparse_gemm_tickets`` / ``_partials``), followed by guard
    elements, a launch leaves the guards untouched and the tickets zero,
    and matches the plain version: the fp32 MNIST-KAN and GKAN decode
    layers (slices of fewer inputs than a round), the LM layers and a K
    of many rounds.  A fresh workspace is sized by these exports alone."""
    grid = SplineGrid(-1.0, 1.0, G, P)
    x, c, w = _inputs(grid, BS, K, N, BS + K + N, True)
    tx, tc, tw = (torch.tensor(a).to(dtype).to(cuda_device) for a in (x, c, w))
    lib = build.load("kan_sparse_gemm")
    n_tickets, n_partials = lib.kan_sparse_gemm_tickets(BS, N), lib.kan_sparse_gemm_partials(
        BS, K, N)
    guard = 16 * BS * (N + 3)                       # room for 16 more slices
    tickets = torch.zeros(n_tickets + guard, dtype=torch.int32, device=cuda_device)
    partials = torch.full((n_partials + guard,), 7.0, device=cuda_device)
    y = torch.empty((BS, N), dtype=dtype, device=cuda_device)
    err = lib.kan_sparse_gemm(
        tx.data_ptr(), tc.data_ptr(), tw.data_ptr(), tickets.data_ptr(), partials.data_ptr(),
        y.data_ptr(), BS, K, N, grid.n_basis, P, grid.t0, grid.delta,
        F.DTYPE_CODES[dtype], F.DTYPE_CODES[dtype], torch.cuda.current_stream().cuda_stream)
    build.check(err, "kan_sparse_gemm")
    torch.cuda.synchronize()
    assert torch.equal(partials[n_partials:], torch.full_like(partials[n_partials:], 7.0))
    assert not tickets.any()
    want = S.kan_sparse_gemm_reference(tx, tc, grid, tw)
    atol = 1e-4 if dtype == torch.float32 else BF16_ULP * want.float().abs().max().item()
    torch.testing.assert_close(y.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,K,N", [(5, 512, 1024), (5, 1024, 512), (10, 784, 64)])
def test_sparse_kernel_rows_do_not_depend_on_their_companions(cuda_device, G, K, N, dtype):
    """The kanformer FFN's two layers and MNIST-KAN's first: for BS in 1..8
    each row of a call is bit-equal to the same row served alone, and to it
    served at another position beside other rows (the continuous engine
    compares each stream with the request served alone)."""
    grid = SplineGrid(-1.0, 1.0, G, 3)
    x, c, w = _inputs(grid, 16, K, N, G + K + N, True)
    tx, tc, tw = (torch.tensor(a).to(dtype).to(cuda_device) for a in (x, c, w))
    alone = torch.cat([ops.kan_sparse_gemm(tx[i:i + 1], tc, grid, tw) for i in range(8)])
    for BS in range(1, 9):
        assert torch.equal(ops.kan_sparse_gemm(tx[:BS], tc, grid, tw), alone[:BS])
        mixed = torch.cat([tx[8:16 - BS], tx[:BS].flip(0)])      # 8 rows, ours last
        got = ops.kan_sparse_gemm(mixed, tc, grid, tw)
        assert torch.equal(got[8 - BS:], alone[:BS].flip(0))


@pytest.mark.cuda
@pytest.mark.parametrize("G,P", [(2, 1), (3, 2), (5, 3), (13, 3)])
@pytest.mark.parametrize("K", [33, 100, 784, 2810])
@pytest.mark.parametrize("N", [7, 10, 17, 64, 130, 512, 1024])
@pytest.mark.parametrize("rows", [1, 2, 3, 5, 7, 8])
def test_sparse_kernel_across_its_tiles_and_slices(cuda_device, rows, N, K, G, P):
    """Rows on both sides of the touched-rows copy (<= 2 rows), N below,
    at and across the column tiles (7, 10 and 17 by element copies), K
    below one slice and over hundreds, M = 3 to 16; odd row counts with
    the base term, even ones without.  fp32 within 1e-4 of the plain
    version, bf16 within one bf16 ulp of max|y|, both bit-equal on a
    repeat."""
    grid = SplineGrid(-1.0, 1.0, G, P)
    g = torch.Generator(device=cuda_device).manual_seed(rows * N + K + G)
    x = torch.tanh(torch.randn(rows, K, generator=g, device=cuda_device))
    plant = [grid.x_min, grid.x_max, *grid.knots().tolist(), -3.0, 2.5, -1.0001]
    x.view(-1)[:min(len(plant), x.numel())] = torch.tensor(plant[:x.numel()],
                                                           device=cuda_device)
    c = 0.1 * torch.randn(K, grid.n_basis, N, generator=g, device=cuda_device)
    w = 0.1 * torch.randn(K, N, generator=g, device=cuda_device) if rows % 2 else None
    for dtype in (torch.float32, torch.bfloat16):
        tx, tc = x.to(dtype), c.to(dtype)
        tw = None if w is None else w.to(dtype)
        got = ops.kan_sparse_gemm(tx, tc, grid, tw)
        assert torch.equal(got, ops.kan_sparse_gemm(tx, tc, grid, tw))
        want = S.kan_sparse_gemm_reference(tx, tc, grid, tw)
        atol = 1e-4 if dtype == torch.float32 else BF16_ULP * want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


# Shapes that cross the dense-band kernels' tile, stage and split-K
# boundaries: K split over many slices (2048 x 784 -> 64, 512 x 1024 -> 512),
# one slice (2048 x 2810 -> 512), ragged rows, K and N.
DENSE_SPLIT_SHAPES = [(512, 1024, 512), (2048, 784, 64), (2048, 64, 10), (129, 1024, 512),
                      (512, 1000, 130), (1, 512, 1024), (77, 1000, 130)]


def _dense_calls(grid, lut, BS, K, N, seed, dev):
    """``(call, plain result, atol)`` for each dense-band kernel: fused fp32
    (atol 1e-4) and bf16 (one bf16 ulp of max|y|), int8 with and without
    the dequant epilogue (bit-equal: atol None)."""
    x, c, w = _inputs(grid, BS, K, N, seed, True)
    tx, tc, tw = (torch.tensor(a).to(dev) for a in (x, c, w))
    bx, bc, bw = (t.to(torch.bfloat16) for t in (tx, tc, tw))
    xq, cq, sc = (t.to(dev) for t in _int8_case(grid, BS, K, N, seed))
    want_b16 = F.kan_fused_gemm_reference(bx, bc, grid, bw)
    return [(lambda: ops.kan_fused_gemm(tx, tc, grid, tw),
             F.kan_fused_gemm_reference(tx, tc, grid, tw), 1e-4),
            (lambda: ops.kan_fused_gemm(bx, bc, grid, bw), want_b16,
             BF16_ULP * want_b16.float().abs().max().item()),
            (lambda: ops.kan_int8_gemm(xq, lut, cq, grid),
             I8.kan_int8_gemm_reference(xq, cq, grid), None),
            (lambda: ops.kan_int8_gemm(xq, lut, cq, grid, scale=sc),
             I8.kan_int8_gemm_reference(xq, cq, grid, scale=sc), None)]


def _check_dense_calls(calls):
    for call, want, atol in calls:
        got = call()
        assert torch.equal(got, call())
        if atol is None:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("BS,K,N", DENSE_SPLIT_SHAPES)
def test_dense_band_kernels_repeat_bitwise(cuda_device, BS, K, N):
    """Split K sums fp32 slices in slice order and int32 slices exactly, so
    two calls on the same inputs give the same bits."""
    grid = SplineGrid(-1.0, 1.0, 10 if N <= 64 else 5, 3)
    lut = torch.tensor(Q.build_lut_u8(3, 256), device=cuda_device)
    _check_dense_calls(_dense_calls(grid, lut, BS, K, N, BS + K + N, cuda_device))


@pytest.mark.cuda
def test_dense_band_kernels_share_a_workspace_across_shapes(cuda_device):
    """The fused and int8 dense-band kernels share their stream's workspace
    (tickets, fp32 partials, int32 accumulators) with the sparse kernels;
    calls of growing and shrinking shapes, interleaved, each match their
    plain versions and repeat bit-equal."""
    grid = SplineGrid(-1.0, 1.0, 10, 3)
    lut = torch.tensor(Q.build_lut_u8(3, 256), device=cuda_device)
    for BS, K, N in [(9, 64, 128), (2048, 784, 64), (512, 1024, 512), (13, 100, 200),
                     (2048, 64, 10), (600, 96, 1000), (2, 33, 17), (512, 512, 1024)]:
        _check_dense_calls(_dense_calls(grid, lut, BS, K, N, BS * K + N, cuda_device))
        xq, cq, _ = (t.to(cuda_device) for t in _int8_case(grid, min(BS, 8), K, N, K))
        got = ops.kan_sparse_int8_gemm(xq, lut, cq, grid)
        assert torch.equal(got, S.kan_sparse_int8_gemm_reference(xq, cq, grid))


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
    assert ops.LAUNCHES == {"kan_fused_gemm": 2 * model.n_repeats, "kan_sparse_gemm": 0,
                            "gather_blocks": 0, "kan_int8_gemm": 0,
                            "kan_sparse_int8_gemm": 0, "bspline_lut": 0}
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    pos = torch.tensor(9)
    for s in range(3):
        tok = toks[:, s:s + 1]
        got, gc = lm.decode_step(gpu, model, tok.to(cuda_device), gc, pos.to(cuda_device))
        want, wc = lm.decode_step(params, model, tok, wc, pos)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
        pos = pos + 1
    assert ops.LAUNCHES["kan_sparse_gemm"] == 3 * 2 * model.n_repeats


def _gather_case(device, dtype, stacked, shape, B, L, ids, seed):
    """A pool of random values (``shape`` = (n_blocks, bs, ...)) and a
    ``(B, L)`` table: live ids, the sentinel repeated, or ids outside the
    pool."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    full = ((3,) if stacked else ()) + shape
    if dtype == torch.int8:
        pool = torch.randint(-128, 128, full, generator=g, dtype=torch.int8)
    else:
        pool = torch.randn(full, generator=g).to(dtype)
    n_blocks = shape[0]
    if ids == "live":
        table = torch.randint(1, n_blocks, (B, L), generator=g)
    elif ids == "sentinel":
        table = torch.randint(1, n_blocks, (B, L), generator=g)
        table[:, L // 2:] = 0
    else:
        table = torch.randint(-3 * n_blocks, 3 * n_blocks, (B, L), generator=g)
    return pool.to(device), table.to(torch.int32).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("ids", ["live", "sentinel", "outside"])
@pytest.mark.parametrize("shape", [(13, 4, 2, 8), (97, 16, 8, 64), (9, 2, 3, 5)])
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_gather_kernel_equals_plain_version_bitwise(cuda_device, dtype, stacked, shape, ids):
    """(9, 2, 3, 5) has blocks of 30 elements: not a whole number of
    16-byte units in any dtype, so the kernel copies element by element."""
    pool, table = _gather_case(cuda_device, dtype, stacked, shape, 8, 12, ids,
                               sum(shape) + 7 * stacked + len(ids))
    ops.reset_launches()
    got = ops.gather_blocks(pool, table, stacked=stacked)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gather_blocks"] == 1
    assert got.dtype == dtype and torch.equal(got, G.gather_blocks_reference(pool, table, stacked))


@pytest.mark.cuda
def test_gather_kernel_one_launch_covers_a_stacked_pool(cuda_device):
    pool = torch.randn(8, 97, 16, 8, 64, device=cuda_device)
    table = torch.randint(0, 97, (8, 12), device=cuda_device, dtype=torch.int32)
    ops.reset_launches()
    got = ops.gather_blocks(pool, table, stacked=True)
    assert ops.LAUNCHES["gather_blocks"] == 1 and got.shape == (8, 8, 192, 8, 64)
    for layer in range(8):
        assert torch.equal(got[layer], ops.gather_blocks(pool[layer], table))
    assert ops.LAUNCHES["gather_blocks"] == 9


@pytest.mark.cuda
def test_gather_kernel_raises_and_never_falls_back(cuda_device):
    pool = torch.zeros(13, 4, 2, 8, device=cuda_device)
    table = torch.zeros(2, 3, dtype=torch.int32, device=cuda_device)
    ops.reset_launches()
    with pytest.raises(ValueError, match="dtype"):
        ops.gather_blocks(pool.double(), table)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gather_blocks(pool.transpose(2, 3), table)
    with pytest.raises(ValueError, match="int32"):
        ops.gather_blocks(pool, table.long())
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.gather_blocks(pool, table.cpu())
    assert ops.LAUNCHES["gather_blocks"] == 0


GATHER_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.uint8]
# the leaves of a multi-leaf gather: (dtype or None for the test's, n_blocks,
# block shape, storage offset in elements).  Blocks of 32 KB in fp32 (four
# CTAs each), of 14 elements (never a whole number of 16-byte units), of 48
# elements 4 bytes past an aligned address, and of 64 elements in a pool
# of 7 blocks (other ids clipped).
GATHER_LEAVES = [(None, 13, (16, 8, 64), 0), (None, 13, (2, 1, 7), 0),
                 (torch.float32, 13, (4, 3, 4), 1), (None, 7, (4, 2, 8), 0)]


def _random_pool(shape, dtype, g, offset=0):
    """Random values of ``dtype`` in a contiguous tensor whose data begins
    ``offset`` elements past the start of its storage."""
    n = math.prod(shape)
    if dtype.is_floating_point:
        flat = torch.randn(n + offset, generator=g).to(dtype)
    else:
        lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
        flat = torch.randint(lo, hi, (n + offset,), generator=g, dtype=dtype)
    return flat[offset:].view(shape)


def _gather_cache(device, dtype, n_leaves, stacked, seed):
    """``n_leaves`` of :data:`GATHER_LEAVES` on ``device`` and a (3, 5)
    table with ids below, inside and past every pool."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    cache = {}
    for i, (dt, n_blocks, block, offset) in enumerate(GATHER_LEAVES[:n_leaves]):
        shape = ((2,) if stacked else ()) + (n_blocks,) + block
        pool = _random_pool(shape, dt or dtype, g, offset)
        moved = torch.empty(pool.numel() + offset, dtype=pool.dtype, device=device)
        cache[f"leaf{i}"] = moved[offset:].view(shape).copy_(pool)
    table = torch.randint(-4, 18, (3, 5), generator=g, dtype=torch.int32)
    return cache, table.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("n_leaves", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", GATHER_DTYPES)
def test_gather_views_kernel_equals_plain_version_bitwise(cuda_device, dtype, n_leaves,
                                                           stacked):
    """1 to 4 leaves of different block bytes, pool sizes and dtypes in one
    launch: 16-byte copies (the first leaf) and element copies (the
    second, and the third, whose pool begins off a 16-byte boundary), each
    leaf's ids clipped to its own pool."""
    cache, table = _gather_cache(cuda_device, dtype, n_leaves, stacked, n_leaves + stacked)
    if n_leaves >= 3:
        assert cache["leaf2"].data_ptr() % 16 == 4
    ops.reset_launches()
    got = ops.gather_views(cache, table, stacked)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gather_blocks"] == 1 and list(got) == list(cache)
    for name, pool in cache.items():
        assert got[name].dtype == pool.dtype
        assert torch.equal(got[name], G.gather_blocks_reference(pool, table, stacked))


@pytest.mark.cuda
def test_gather_views_kernel_launches_once_and_not_for_empty_views(cuda_device):
    cache, table = _gather_cache(cuda_device, torch.bfloat16, 4, True, 3)
    ops.reset_launches()
    ops.gather_views(cache, table, stacked=True)
    assert ops.LAUNCHES["gather_blocks"] == 1
    for empty in (table[:0], table[:, :0]):
        views = ops.gather_views(cache, empty.contiguous(), stacked=True)
        assert all(v.numel() == 0 for v in views.values())
    assert ops.LAUNCHES["gather_blocks"] == 1
    # a leaf of no layers beside one with layers: one launch, both views right
    part = {"none": cache["leaf0"][:0], "some": cache["leaf1"]}
    views = ops.gather_views(part, table, stacked=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gather_blocks"] == 2 and views["none"].numel() == 0
    assert torch.equal(views["some"], G.gather_blocks_reference(part["some"], table, True))


@pytest.mark.cuda
def test_gather_views_kernel_raises_and_never_falls_back(cuda_device):
    cache, table = _gather_cache(cuda_device, torch.float32, 2, False, 4)
    ops.reset_launches()
    with pytest.raises(ValueError, match="1 to 4 leaves"):
        ops.gather_views({f"l{i}": cache["leaf0"] for i in range(5)}, table)
    with pytest.raises(ValueError, match="table rank 2"):
        ops.gather_views(cache, table[0])
    with pytest.raises(ValueError, match="int32"):
        ops.gather_views(cache, table.long())
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.gather_views(cache, table.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.gather_views({"k": cache["leaf0"], "v": cache["leaf1"].cpu()}, table)
    with pytest.raises(ValueError, match="dtype"):
        ops.gather_views({"k": cache["leaf0"], "v": cache["leaf1"].double()}, table)
    assert ops.LAUNCHES["gather_blocks"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_gather_kernel_writes_only_its_views(cuda_device, dtype):
    """Four views carved out of one buffer of guard bytes (the third, of
    float32, 4 bytes off a 16-byte boundary): after one launch every view holds the
    plain version's bytes, every byte around them still holds the guard,
    and the pools are unchanged."""
    from repro_torch.kernels import paged_gather as PG

    cache, table = _gather_cache(cuda_device, dtype, 4, True, 5)
    before = {n: p.clone() for n, p in cache.items()}
    want = [G.gather_blocks_reference(p, table, True).reshape(-1).view(torch.uint8)
            for p in cache.values()]
    starts, end = [], 0
    for i, w in enumerate(want):
        start = (end + 64 + 15) // 16 * 16 + (4 if i == 2 else 0)
        starts.append(start)
        end = start + w.numel()
    buf = torch.full((end + 64,), 0xA5, dtype=torch.uint8, device=cuda_device)
    leaves = (PG._Leaf * 4)(*[
        PG._Leaf(p.data_ptr(), buf.data_ptr() + s, math.prod(p.shape[2:]) * p.element_size(),
                 p.shape[1], p.shape[0], p.element_size())
        for p, s in zip(cache.values(), starts)])
    err = build.load("paged_gather").paged_gather(
        ctypes.addressof(leaves), 4, table.data_ptr(), *table.shape,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "paged_gather")
    torch.cuda.synchronize()
    guard = torch.ones_like(buf, dtype=torch.bool)
    for s, w in zip(starts, want):
        assert torch.equal(buf[s:s + w.numel()], w)
        guard[s:s + w.numel()] = False
    assert bool((buf[guard] == 0xA5).all())
    for n, p in cache.items():
        assert torch.equal(p, before[n])


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [{}, {"paged": True}, {"paged": True, "paged_read": "step"},
                                 {"paged": True, "pool_blocks": 12}, {"spec_k": 3},
                                 {"paged": True, "paged_read": "step", "spec_k": 2}])
def test_reduced_continuous_engine_on_card_matches_cpu(cuda_device, cfg):
    """The continuous engine, dense and paged, speculative or not, on the
    card (KAN kernels and the gather kernel) gives the CPU's streams and
    counters."""
    model = configs.get_reduced("kanformer-100m").model
    params = lm.init_params(model, seed=0, device="cpu")
    rs = np.random.RandomState(0)
    common = rs.randint(1, model.vocab, 8).astype(np.int32)
    reqs = [rs.randint(1, model.vocab, int(rs.randint(3, 14))).astype(np.int32)
            for _ in range(8)]
    reqs = [np.concatenate([common, r]) if i % 2 else r for i, r in enumerate(reqs)]
    scfg = ServeConfig(max_seq=32, max_new_tokens=8, block_size=4, **cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(params, model, scfg, device=dev)
        ops.reset_launches()
        streams = eng.serve_continuous(reqs, slots=3, chunk_steps=3)
        out[dev] = (streams, eng.last_serve_stats, dict(ops.LAUNCHES))
    (cs, cst, _), (gs, gst, launches) = out["cpu"], out["cuda"]
    for a, b in zip(cs, gs):
        np.testing.assert_array_equal(a, b)
    for key in ("chunks_run", "useful_token_steps", "n_preemptions", "paged", "spec"):
        assert cst.get(key) == gst.get(key)
    assert (launches["gather_blocks"] > 0) == bool(cfg.get("paged"))
    assert launches["kan_sparse_gemm"] > 0


SAMPLE_T, EMBED_SCALE = 1.0, 0.07     # logit gaps of the noise's scale (test_torch_sampling)
GUMBEL_ATOL, SAMPLE_LOGIT_ATOL = 1e-5, 1e-4


def _tie_tol(T: float) -> float:
    """Two samplers whose logits differ by at most ``SAMPLE_LOGIT_ATOL`` and
    noise by ``GUMBEL_ATOL`` can draw different tokens only where the top-2
    gap of the perturbed scores ``logits / T + g`` is below this."""
    return 2 * (SAMPLE_LOGIT_ATOL / T + GUMBEL_ATOL)


def _near_tie(params, model, prompt, stream, rid, j, seed=0) -> bool:
    """Whether token ``j`` of ``stream`` (request ``rid``) was a near-tie:
    its perturbed top-2 gap, from the CPU's teacher-forced logits."""
    from repro_torch.serve import speculative as sp
    from repro_torch.serve import threefry

    seq = np.concatenate([prompt, stream[:j]]).astype(np.int64)
    logits, _ = lm.prefill(params, model, torch.as_tensor(seq[None]), len(seq))
    pair = Engine._row_key_pairs(threefry.prng_key(seed).numpy(), [rid])[0]
    key = pair[1] if j == 0 else sp.split_chain(pair[None, 0], j)[0][0, j - 1]
    lg = logits[0, -1:]
    noise = threefry.gumbel(torch.as_tensor(key)[None], lg.shape[-1:])
    return float(sp.perturbed_top2_gap(lg, noise, SAMPLE_T)[0]) < _tie_tol(SAMPLE_T)


@pytest.mark.cuda
def test_threefry_bits_and_noise_on_card_match_cpu(cuda_device):
    """Keys, bits and uniforms of a large draw on the card equal the CPU's
    bit for bit; Gumbel noise within ``GUMBEL_ATOL``."""
    from repro_torch.serve import threefry

    host = Engine._row_key_pairs(threefry.prng_key(2 ** 32 + 9).numpy(), np.arange(8))[:, 1]
    keys = {d: torch.as_tensor(host, device=d) for d in ("cpu", "cuda")}
    again = threefry.split(threefry.fold_in(threefry.prng_key(2 ** 32 + 9, "cuda"),
                                            torch.arange(8, device="cuda")))[:, 1]
    np.testing.assert_array_equal(again.cpu().numpy(), host)
    for fn in (lambda k: threefry.random_bits_u32(k, (8, 32000)),
               lambda k: threefry.random_bits_u32(k, (3, 5, 70001)),
               lambda k: threefry.uniform(k, (8, 32000)).view(torch.int32),
               lambda k: threefry.uniform(k, (3, 1000), -0.3, 2.7).view(torch.int32)):
        assert torch.equal(fn(keys["cuda"]).cpu(), fn(keys["cpu"]))
    g = {d: threefry.gumbel(keys[d], (8, 32000)) for d in keys}
    assert torch.isfinite(g["cuda"]).all()
    assert (g["cuda"].cpu() - g["cpu"]).abs().max().item() <= GUMBEL_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("T", [0.7, 1.0, 100.0])
def test_sample_tokens_on_card_match_cpu(cuda_device, T):
    """``sample_tokens`` on the card draws the CPU's tokens on the same
    logits and keys, every row with no near-tie (the logits are the same
    array, so only the noise differs, within ``GUMBEL_ATOL``); each row
    alone draws what it draws in the batch."""
    from repro_torch.serve import speculative as sp
    from repro_torch.serve import threefry

    host = Engine._row_key_pairs(threefry.prng_key(11).numpy(), np.arange(64))[:, 1]
    lg = torch.randn(64, 32000, generator=torch.Generator().manual_seed(0)) * 3
    tok = {d: sp.sample_tokens(lg.to(d), torch.as_tensor(host, device=d), T).cpu()
           for d in ("cpu", "cuda")}
    gap = sp.perturbed_top2_gap(lg, threefry.gumbel(torch.as_tensor(host), (32000,)), T)
    tie = gap < 2 * GUMBEL_ATOL
    assert not tie.any()
    assert torch.equal(tok["cuda"], tok["cpu"])
    assert (tok["cpu"] != lg.argmax(-1)).any()
    for r in (0, 63):
        one = sp.sample_tokens(lg[r:r + 1].cuda(), torch.as_tensor(host[r:r + 1], device="cuda"), T)
        assert one.item() == tok["cpu"][r].item()


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [{}, {"paged": True}, {"paged": True, "paged_read": "step"},
                                 {"paged": True, "pool_blocks": 12}, {"spec_k": 3},
                                 {"paged": True, "paged_read": "step", "spec_k": 2}])
def test_reduced_sampled_engine_on_card_matches_cpu(cuda_device, cfg):
    """Sampling at T = 1 (embedding scaled so the noise competes with the
    logit gaps): the continuous engine on the card, dense and paged,
    speculative or not, gives the CPU's streams and counters, unless a
    stream's first divergence is a near-tie."""
    model = configs.get_reduced("kanformer-100m").model
    params = lm.init_params(model, seed=0, device="cpu")
    params["embed"] = {"table": params["embed"]["table"] * EMBED_SCALE}
    rs = np.random.RandomState(0)
    common = rs.randint(1, model.vocab, 8).astype(np.int32)
    reqs = [rs.randint(1, model.vocab, int(rs.randint(3, 14))).astype(np.int32)
            for _ in range(8)]
    reqs = [np.concatenate([common, r]) if i % 2 else r for i, r in enumerate(reqs)]
    scfg = ServeConfig(max_seq=32, max_new_tokens=8, block_size=4, temperature=SAMPLE_T, **cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(params, model, scfg, device=dev)
        ops.reset_launches()
        streams = eng.serve_continuous(reqs, slots=3, chunk_steps=3)
        out[dev] = (streams, eng.last_serve_stats, dict(ops.LAUNCHES))
    (cs, cst, _), (gs, gst, launches) = out["cpu"], out["cuda"]
    ties = 0
    for rid, (p, a, b) in enumerate(zip(reqs, cs, gs)):
        diff = np.nonzero(a != b)[0]
        if diff.size:
            assert _near_tie(params, model, p, a, rid, int(diff[0]))
            ties += 1
    if not ties:
        for key in ("chunks_run", "useful_token_steps", "n_preemptions", "paged", "spec"):
            assert cst.get(key) == gst.get(key)
    greedy = Engine(params, model, dataclasses.replace(scfg, temperature=0.0), device="cpu")
    assert any(not np.array_equal(a, b) for a, b in
               zip(greedy.serve_continuous(reqs, slots=3, chunk_steps=3), cs))
    assert (launches["gather_blocks"] > 0) == bool(cfg.get("paged"))
    assert launches["kan_sparse_gemm"] > 0


@pytest.mark.cuda
def test_sampled_preempting_run_on_card_equals_its_dense_run(cuda_device):
    """On the card, a sampled paged run whose pool preempts re-derives each
    preempted request's key chain from its id: its streams equal the dense
    sampled run's on the card, unless a first divergence is a near-tie."""
    model = configs.get_reduced("kanformer-100m").model
    params = lm.init_params(model, seed=0, device="cpu")
    params["embed"] = {"table": params["embed"]["table"] * EMBED_SCALE}
    rs = np.random.RandomState(3)
    reqs = [rs.randint(1, model.vocab, int(rs.randint(3, 14))).astype(np.int32)
            for _ in range(10)]
    base = ServeConfig(max_seq=32, max_new_tokens=8, block_size=4, temperature=SAMPLE_T)
    dense = Engine(params, model, base, device="cuda")
    want = dense.serve_continuous(reqs, slots=3, chunk_steps=3, seed=5)
    tight = Engine(params, model, dataclasses.replace(base, paged=True, pool_blocks=12),
                   device="cuda")
    got = tight.serve_continuous(reqs, slots=3, chunk_steps=3, seed=5)
    assert tight.last_serve_stats["n_preemptions"] >= 1
    for rid, (p, a, b) in enumerate(zip(reqs, want, got)):
        diff = np.nonzero(a != b)[0]
        if diff.size:
            assert _near_tie(params, model, p, a, rid, int(diff[0]), seed=5)


def _reduced_on(device, params):
    return {"embed": {k: v.to(device) for k, v in params["embed"].items()},
            "final_ln": {k: v.to(device) for k, v in params["final_ln"].items()},
            "unit": [{s: {k: v.to(device) for k, v in sub.items()}
                      for s, sub in params["unit"][0].items()}]}


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_verify_window_kernel_path_matches_plain_path(cuda_device, paged):
    """8 rows x W = 5 (40 rows: the fused kernel) through ``lm.verify_window``
    on the card against the plain path on the CPU, logits atol 1e-4, and
    against 5 sequential decode steps (the sparse kernel) on the card."""
    model = configs.get_reduced("kanformer-100m").model
    params = lm.init_params(model, seed=0, device="cpu")
    rs = np.random.RandomState(7)
    B, W, bs, S = 8, 5, 4, 32
    toks = torch.as_tensor(rs.randint(0, model.vocab, (B, 9)))
    window = torch.as_tensor(rs.randint(0, model.vocab, (B, W)))
    lens = torch.as_tensor(rs.randint(3, 10, B))
    table = torch.as_tensor((1 + np.arange(B * S // bs)).reshape(B, S // bs).astype(np.int32))

    def run(device, verify):
        p = params if device == "cpu" else _reduced_on(device, params)
        t, ln = toks.to(device), lens.to(device)
        tb = table.to(device) if paged else None
        if paged:
            caches = lm.init_paged_caches(model, 1 + B * S // bs, bs, torch.float32, device)
            lm.prefill_into_pages(p, model, t, ln, tb, caches, 0, torch.float32)
        else:
            _, caches = lm.prefill(p, model, t, S)
        if verify:
            lg, _ = lm.verify_window(p, model, window.to(device), caches, ln, torch.float32, tb)
            return lg
        pos, out = ln.clone(), []
        for j in range(W):
            lg, caches = lm.decode_step(p, model, window[:, j:j + 1].to(device), caches, pos,
                                        torch.float32, tb)
            out.append(lg)
            pos = pos + 1
        return torch.stack(out, dim=1)

    ops.reset_launches()
    got = run(cuda_device, True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["kan_fused_gemm"] == 2 * 2 * model.n_repeats     # prefill + verify
    assert ops.LAUNCHES["kan_sparse_gemm"] == 0
    assert (ops.LAUNCHES["gather_blocks"] > 0) == paged
    torch.testing.assert_close(got.cpu(), run("cpu", True), rtol=0, atol=1e-4)
    torch.testing.assert_close(got.cpu(), run(cuda_device, False).cpu(), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_dense_span_write_drops_positions_past_the_cache(cuda_device):
    """Row 0 overruns the cache by 2 of its 4 positions, row 1 starts past
    it, row 2 fits: slots outside each row's in-range positions keep their
    values, and the in-range ones take the window's, on the card."""
    from repro_torch.models import attention as A

    S, W = 16, 4
    g = torch.Generator(device="cpu").manual_seed(3)
    buf = torch.randn(3, S, 2, 8, generator=g)
    val = torch.randn(3, W, 2, 8, generator=g)
    pos = torch.tensor([S - 2, S + 1, 5])
    positions = pos[:, None] + torch.arange(W)[None, :]
    want = buf.clone()
    for b in range(3):
        for j in range(W):
            if positions[b, j] < S:
                want[b, positions[b, j]] = val[b, j]
    cache = {"k": buf.to(cuda_device)}
    A._write_cache_span(cache, "k", val.to(cuda_device), positions.to(cuda_device))
    assert torch.equal(cache["k"].cpu(), want)


@pytest.mark.cuda
def test_drafter_is_views_of_the_target_on_the_card(cuda_device):
    """``Engine(spec_k=...)`` derives its drafter from views of the weights
    it placed on the card: no tensor of the unit is copied, and the device
    memory does not grow, unless ``draft_quant`` asks for new weights."""
    model = configs.get_reduced("kanformer-100m").model
    params = lm.init_params(model, seed=0, device=cuda_device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng = Engine(params, model, ServeConfig(max_seq=32, spec_k=2, draft_layers=1),
                 device=cuda_device)
    assert torch.cuda.memory_allocated() == before
    for blk_t, blk_d in zip(eng.params["unit"], eng.draft.params["unit"]):
        for sub in blk_t:
            for k, a in blk_t[sub].items():
                d = blk_d[sub][k]
                assert d._base is a and d.data_ptr() == a.data_ptr() and d.shape[0] == 1
    assert eng.draft.params["embed"] is eng.params["embed"]
    quant = Engine(params, model, ServeConfig(max_seq=32, spec_k=2, draft_quant=True),
                   device=cuda_device)
    assert torch.cuda.memory_allocated() > before
    assert quant.draft.params["unit"][0]["kan"]["c1"].data_ptr() != params["unit"][0]["kan"]["c1"].data_ptr()


INT8 = {"kan_int8_gemm": ops.kan_int8_gemm, "kan_sparse_int8_gemm": ops.kan_sparse_int8_gemm}
INT8_PLAIN = {"kan_int8_gemm": I8.kan_int8_gemm_reference,
              "kan_sparse_int8_gemm": S.kan_sparse_int8_gemm_reference}


def _int8_case(grid, BS, K, N, seed):
    """Codes over [-40, 300] (0, qmax and negative ones planted at the
    front), int8 coefficients over [-127, 127], per-channel scales."""
    rs = np.random.RandomState(seed)
    xq = rs.randint(-40, 300, (BS, K)).astype(np.int32)
    xq.reshape(-1)[:6] = [0, 255, -1, -255, 256, 128][: xq.size]
    cq = rs.randint(-127, 128, (K, grid.n_basis, N)).astype(np.int8)
    sc = rs.uniform(1e-5, 1e-3, N).astype(np.float32)
    return torch.tensor(xq), torch.tensor(cq), torch.tensor(sc)


@pytest.mark.cuda
@pytest.mark.parametrize("out", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,BS,K,N", [
    (name, *shape) for name in sorted(INT8)
    for shape in [(13, 100, 200), (1, 784, 64), (8, 784, 64), (70, 37, 10), (4, 64, 512)]
] + [("kan_int8_gemm", 2048, 2810, 512), ("kan_int8_gemm", 2048, 784, 64),
     ("kan_int8_gemm", 2048, 64, 10), ("kan_int8_gemm", 77, 1000, 130)])
@pytest.mark.parametrize("G,P", [(10, 3), (13, 3), (3, 2), (2, 1)])
def test_int8_kernel_equals_plain_version_bitwise(cuda_device, name, G, P, BS, K, N, out):
    """M = 13 (MNIST-KAN) and 16 (the widest sparse band), P = 1, 2, 3,
    ragged shapes, codes at 0, qmax and negative, with and without the
    dequant epilogue; the dense-band kernel also at the int8 path's and
    CF-KAN's layer shapes, across its tile, stage and split-K boundaries."""
    grid = SplineGrid(-1.0, 1.0, G, P)
    xq, cq, sc = (t.to(cuda_device) for t in _int8_case(grid, BS, K, N, G + BS + K + N))
    lut = torch.tensor(Q.build_lut_u8(P, 256), device=cuda_device)
    kw = {} if out is None else dict(scale=sc, out_dtype=out)
    ops.reset_launches()
    got = INT8[name](xq, lut, cq, grid, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == 1 and got.dtype == (out or torch.int32)
    want = INT8_PLAIN[name](xq, cq, grid, S=256, lut_scale=Q.lut_value_scale(P),
                            scale=kw.get("scale"), out_dtype=out or torch.float32)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 8])
@pytest.mark.parametrize("K,N", [(784, 64), (64, 10), (2810, 512)])
def test_sparse_int8_kernel_bit_equal_to_dense_band_kernel(cuda_device, rows, K, N):
    """MNIST-KAN's layers (G=10) and CF-KAN's first (G=2), at decode rows."""
    grid = SplineGrid(-1.0, 1.0, 2 if K == 2810 else 10, 3)
    xq, cq, sc = (t.to(cuda_device) for t in _int8_case(grid, rows, K, N, rows * K))
    lut = torch.tensor(Q.build_lut_u8(3, 256, 192), device=cuda_device)
    for kw in ({}, dict(scale=sc), dict(scale=sc, out_dtype=torch.bfloat16)):
        a = ops.kan_int8_gemm(xq, lut, cq, grid, **kw)
        b = ops.kan_sparse_int8_gemm(xq, lut, cq, grid, **kw)
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("G,P", [(2, 1), (13, 3)])
@pytest.mark.parametrize("N", [10, 130, 512])
@pytest.mark.parametrize("rows", [1, 2, 3, 5, 7, 8])
def test_sparse_int8_kernel_across_its_tiles(cuda_device, rows, N, G, P):
    """M = 3 (P = 1) and M = 16 (the widest band); N = 10 (a tile wider than
    N, element copies), 130 (a ragged second tile) and 512 (four full
    tiles); K = 789, a multiple of no slice width; bit-equal to its plain
    version and to the dense-band kernel, every out code."""
    grid = SplineGrid(-1.0, 1.0, G, P)
    K = 789
    xq, cq, sc = (t.to(cuda_device) for t in _int8_case(grid, rows, K, N, rows * N + G))
    lut = torch.tensor(Q.build_lut_u8(P, 256), device=cuda_device)
    for out in (None, torch.float32, torch.bfloat16):
        kw = {} if out is None else dict(scale=sc, out_dtype=out)
        got = ops.kan_sparse_int8_gemm(xq, lut, cq, grid, **kw)
        want = S.kan_sparse_int8_gemm_reference(xq, cq, grid, lut_scale=Q.lut_value_scale(P),
                                                scale=kw.get("scale"),
                                                out_dtype=out or torch.float32)
        assert torch.equal(got, want)
        assert torch.equal(got, ops.kan_int8_gemm(xq, lut, cq, grid, **kw))


def _sparse_int8_smem(N: int, M: int, P: int, S_: int) -> int:
    """Kernel 3's dynamic shared memory at N <= 16, from its ``split()``
    and ``area_bytes``: one column tile of CT = 16 (TQ = 4), TJ = 64 input
    lanes and a slice of JS = 64 inputs whatever K and BS, so the lane sums
    (64 x 8 rows x 16 columns x 4 bytes) outgrow the M <= 16 coefficient
    rows; then a packed word per (row, input) and the ROM."""
    assert N <= 16 and M <= 16
    area = max(64 * M * 16, 64 * 8 * 16 * 4)
    return (area + 15) // 16 * 16 + 8 * 64 * 8 + (S_ * ((P + 2) // 2) + 15) // 16 * 16


@pytest.mark.cuda
@pytest.mark.parametrize("N", [10, 16])
@pytest.mark.parametrize("P,S_,smem", [(3, 6136, 49136), (3, 6144, 49152), (3, 6152, 49168),
                                       (1, 12288, 49152)])
def test_sparse_int8_kernel_grants_shared_memory_at_48_kb(cuda_device, P, S_, smem, N):
    """ROMs that bring the dynamic shared memory to 16 bytes under, exactly
    at and 16 bytes over 48 KB.  At exactly 49,152 bytes the kernel's static
    ``last_s`` takes the block past the 48 KB default, so the launcher must
    grant the bytes there too.  N = 10 and 16 are the element-copy and
    16-byte-copy instantiations, each with its own grant."""
    G = 13 - P                                                 # M = 13
    assert _sparse_int8_smem(N, G + P, P, S_) == smem
    grid = SplineGrid(-1.0, 1.0, G, P)
    xq, cq, sc = (t.to(cuda_device) for t in _int8_case(grid, 8, 300, N, S_ + N))
    lut = torch.tensor(Q.build_lut_u8(P, S_), device=cuda_device)
    ops.reset_launches()
    for out in (None, torch.float32):
        kw = {} if out is None else dict(scale=sc, out_dtype=out)
        got = ops.kan_sparse_int8_gemm(xq, lut, cq, grid, **kw)
        want = S.kan_sparse_int8_gemm_reference(xq, cq, grid, S=S_,
                                                lut_scale=Q.lut_value_scale(P),
                                                scale=kw.get("scale"),
                                                out_dtype=out or torch.float32)
        assert torch.equal(got, want)
    assert ops.LAUNCHES["kan_sparse_int8_gemm"] == 2


def _stream_workspace(t: torch.Tensor):
    """The workspace the kernels use on ``t``'s device and current stream."""
    from repro_torch.kernels import workspace

    return workspace._workspaces[(t.device.index,
                                  torch.cuda.current_stream(t.device).cuda_stream)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,K,N", [(8, 784, 64), (8, 2810, 512), (3, 100, 130)])
def test_sparse_int8_kernel_repeats_and_leaves_its_workspace_zero(cuda_device, rows, K, N):
    """Two calls in a row are bit-equal, and after each the stream's ticket
    counters and int32 accumulators read back zero."""
    grid = SplineGrid(-1.0, 1.0, 2 if K == 2810 else 10, 3)
    xq, cq, sc = (t.to(cuda_device) for t in _int8_case(grid, rows, K, N, rows + K + N))
    lut = torch.tensor(Q.build_lut_u8(3, 256), device=cuda_device)
    first = None
    for _ in range(2):
        got = ops.kan_sparse_int8_gemm(xq, lut, cq, grid, scale=sc)
        torch.cuda.synchronize()
        ws = _stream_workspace(got)
        assert not ws["tickets"].any() and not ws["accumulators"].any()
        if first is None:
            first = got
        assert torch.equal(got, first)


@pytest.mark.cuda
def test_sparse_int8_kernel_interleaves_with_the_dense_band_kernel(cuda_device):
    """Kernels 3 and 4 share the stream's tickets and accumulators; calls of
    both, alternating over growing and shrinking shapes on one stream, each
    equal the plain version."""
    grid = SplineGrid(-1.0, 1.0, 10, 3)
    lut = torch.tensor(Q.build_lut_u8(3, 256), device=cuda_device)
    for i, (BS, K, N) in enumerate([(8, 784, 64), (2048, 784, 64), (1, 64, 10), (5, 2810, 512),
                                    (300, 100, 130), (7, 33, 17), (8, 784, 64)]):
        xq, cq, _ = (t.to(cuda_device) for t in _int8_case(grid, BS, K, N, i))
        want = I8.kan_int8_gemm_reference(xq, cq, grid)
        for fn in (ops.kan_sparse_int8_gemm, ops.kan_int8_gemm, ops.kan_sparse_int8_gemm):
            assert torch.equal(fn(xq, lut, cq, grid), want)
    torch.cuda.synchronize()
    ws = _stream_workspace(xq)
    assert not ws["tickets"].any() and not ws["accumulators"].any()


@pytest.mark.cuda
def test_sparse_kernel_interleaves_with_the_other_split_kernels(cuda_device):
    """Kernel 2 shares the stream's tickets with the fused (1), sparse int8
    (3) and dense-band int8 (4) kernels; calls of all four, alternating over
    growing and shrinking shapes on one stream, each match their plain
    versions, kernel 2 repeats bit-equal, and after each call the tickets
    (and the int8 kernels' accumulators) read back zero."""
    grid = SplineGrid(-1.0, 1.0, 10, 3)
    lut = torch.tensor(Q.build_lut_u8(3, 256), device=cuda_device)

    def zero_after(t):
        torch.cuda.synchronize()
        ws = _stream_workspace(t)
        assert not ws["tickets"].any()
        assert "accumulators" not in ws or not ws["accumulators"].any()
        return t

    for i, (BS, K, N) in enumerate([(8, 784, 64), (4, 1024, 512), (1, 64, 10), (5, 2810, 512),
                                    (3, 100, 130), (7, 33, 17), (8, 784, 64)]):
        x, c, w = _inputs(grid, 40, K, N, i, True)
        tx, tc, tw = (torch.tensor(a).to(cuda_device) for a in (x, c, w))
        first = zero_after(ops.kan_sparse_gemm(tx[:BS], tc, grid, tw))
        torch.testing.assert_close(first, S.kan_sparse_gemm_reference(tx[:BS], tc, grid, tw),
                                   rtol=0, atol=1e-4)
        fused = zero_after(ops.kan_fused_gemm(tx, tc, grid, tw))
        torch.testing.assert_close(fused, F.kan_fused_gemm_reference(tx, tc, grid, tw),
                                   rtol=0, atol=1e-4)
        xq, cq, _ = (t.to(cuda_device) for t in _int8_case(grid, BS, K, N, i))
        want = I8.kan_int8_gemm_reference(xq, cq, grid)
        assert torch.equal(zero_after(ops.kan_sparse_int8_gemm(xq, lut, cq, grid)), want)
        assert torch.equal(zero_after(ops.kan_int8_gemm(xq, lut, cq, grid)), want)
        assert torch.equal(zero_after(ops.kan_sparse_gemm(tx[:BS], tc, grid, tw)), first)


@pytest.mark.cuda
@pytest.mark.parametrize("S_", [256, 4096])
@pytest.mark.parametrize("scale", [None, 192])
@pytest.mark.parametrize("G,P", [(2, 1), (3, 2), (10, 3)])
def test_int8_kernels_read_every_rom_address(cuda_device, G, P, scale, S_):
    """Under ``rom_probe``'s operands the accumulator rows are the bands the
    kernel built: every one of the S addresses, as ``build_lut_u8`` holds
    it (the plain version reads the table on the CPU)."""
    grid = SplineGrid(-1.0, 1.0, G, P)
    lut = torch.tensor(Q.build_lut_u8(P, S_, scale))
    x_q, qmax, coeff = I8.rom_probe(grid, S_)
    want = ops.kan_int8_gemm(x_q, lut, coeff, grid, qmax=qmax)
    for fn in INT8.values():
        got = fn(x_q.to(cuda_device), lut.to(cuda_device), coeff.to(cuda_device), grid,
                 qmax=qmax)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_sparse_kernels_share_a_workspace_across_shapes_and_dtypes(cuda_device):
    """The float and int8 sparse kernels share the workspace of a stream;
    calls of growing and shrinking shapes, alternating between them, each
    match their plain versions and repeat bit-equal."""
    grid = SplineGrid(-1.0, 1.0, 10, 3)
    lut = torch.tensor(Q.build_lut_u8(3, 256), device=cuda_device)
    for BS, K, N in [(1, 64, 128), (8, 784, 64), (3, 2810, 512), (2, 33, 17), (13, 100, 200),
                     (1, 5, 3)]:
        xq, cq, sc = (t.to(cuda_device) for t in _int8_case(grid, BS, K, N, BS * K + N))
        got = ops.kan_sparse_int8_gemm(xq, lut, cq, grid, scale=sc)
        assert torch.equal(got, ops.kan_sparse_int8_gemm(xq, lut, cq, grid, scale=sc))
        assert torch.equal(got, S.kan_sparse_int8_gemm_reference(xq, cq, grid, scale=sc))
        x, c, w = _inputs(grid, BS, K, N, BS + K, True)
        tx, tc, tw = (torch.tensor(a).to(cuda_device) for a in (x, c, w))
        y = ops.kan_sparse_gemm(tx, tc, grid, tw)
        torch.testing.assert_close(y, S.kan_sparse_gemm_reference(tx, tc, grid, tw),
                                   rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("S_", [256, 4096, 100])
@pytest.mark.parametrize("G,P", [(10, 3), (5, 3), (3, 2), (2, 1)])
@pytest.mark.parametrize("n", [1, 1000, 300_000])
def test_bspline_lut_kernel_equals_plain_version(cuda_device, G, P, S_, n):
    grid = SplineGrid(-1.0, 1.0, G, P)
    rs = np.random.RandomState(n + G)
    x = rs.uniform(-1.2, 1.2, n).astype(np.float32)
    plant = np.concatenate([[grid.x_min, grid.x_max], grid.knots(), [-3.0, 2.5]])
    x[: min(n, plant.size)] = plant[:n]
    tx = torch.tensor(x, device=cuda_device)
    lut = torch.tensor(build_lut(P, S_), device=cuda_device)
    ops.reset_launches()
    vals, k = ops.bspline_lut(tx, lut, grid)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["bspline_lut"] == 1
    want_v, want_k = L.bspline_lut_reference(tx, lut, grid)
    assert torch.equal(k, want_k) and torch.equal(vals, want_v)
    cpu_v, cpu_k = L.bspline_lut_reference(tx.cpu(), lut.cpu(), grid)
    assert torch.equal(k.cpu(), cpu_k) and torch.equal(vals.cpu(), cpu_v)


@pytest.mark.cuda
def test_int8_and_lut_kernels_raise_and_never_fall_back(cuda_device):
    ops.reset_launches()
    lut8 = torch.tensor(Q.build_lut_u8(3, 256), device=cuda_device)
    xq = torch.zeros(2, 8, dtype=torch.int32, device=cuda_device)
    wide = SplineGrid(-1.0, 1.0, 14, 3)                        # M = 17
    with pytest.raises(ValueError, match="M=G\\+P <= 16"):
        ops.kan_sparse_int8_gemm(xq, lut8, torch.zeros(8, 17, 4, dtype=torch.int8,
                                                       device=cuda_device), wide)
    p4 = SplineGrid(-1.0, 1.0, 5, 4)
    with pytest.raises(ValueError, match="compiled for P"):
        ops.kan_int8_gemm(xq, torch.tensor(Q.build_lut_u8(4, 256), device=cuda_device),
                          torch.zeros(8, 9, 4, dtype=torch.int8, device=cuda_device), p4)
    g = SplineGrid(-1.0, 1.0, 10, 3)
    with pytest.raises(ValueError, match="float32"):
        ops.bspline_lut(torch.zeros(8, dtype=torch.bfloat16, device=cuda_device),
                        torch.tensor(build_lut(3), device=cuda_device), g)
    with pytest.raises(ValueError, match="one device"):
        ops.kan_int8_gemm(xq, lut8, torch.zeros(8, 13, 4, dtype=torch.int8), g)
    assert all(v == 0 for v in ops.LAUNCHES.values())


@pytest.mark.cuda
def test_mnist_kan_int8_and_lut_paths_on_card_match_cpu(cuda_device):
    """A narrow MNIST-KAN ([96, 32, 10], G=10) quantised on the card and on
    the CPU: equal integers; each layer's fused int8 forward on the same
    input bit-equal to the CPU's (dense band at 40 rows, sparse at 8); the
    lut path within fp32 sums of the CPU's."""
    cfg = KL.KANNetConfig(layers=(96, 32, 10), G=10, P=3)
    params = KL.init_kan_net(cfg, seed=0, device="cpu")
    gpu = [{k: v.to(cuda_device) for k, v in p.items()} for p in params]
    x = torch.tensor(np.random.RandomState(0).uniform(-1.2, 1.2, (40, 96)).astype(np.float32))
    h = x
    for i, (p, pg) in enumerate(zip(params, gpu)):
        ql, qg = Q.quantize_kan_layer(p, cfg.grid()), Q.quantize_kan_layer(pg, cfg.grid())
        assert torch.equal(ql.coeff_q, qg.coeff_q.cpu())
        assert torch.equal(ql.base_w_q, qg.base_w_q.cpu())
        if i:
            h = torch.tanh(h)
        for rows in (40, 8):
            ops.reset_launches()
            got = Q.quantized_kan_forward_fused(qg, h[:rows].to(cuda_device))
            kernel = "kan_int8_gemm" if rows > 8 else "kan_sparse_int8_gemm"
            assert ops.LAUNCHES[kernel] == 1
            assert torch.equal(got.cpu(), Q.quantized_kan_forward_fused(ql, h[:rows]))
        h = Q.quantized_kan_forward(ql, h)
    got = KL.kan_net_apply(gpu, x.to(cuda_device), cfg, method="lut")
    want = KL.kan_net_apply(params, x, cfg, method="lut")
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


# ConvKAN at ResKAN18's depths (K = 27, 576, 4608), row counts that are not
# a multiple of the fused kernel's 128-row tile; the tolerance is
# chip_smoke.py's CONV_REL of max|y| (K = 4608: 5 x 4608 fp32 products per
# output in another order)
@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,k,stride,N", [(3, 11, 9, 3, 3, 1, 64),
                                                (2, 13, 13, 64, 3, 2, 128),
                                                (1, 5, 7, 512, 3, 1, 512),
                                                (3, 9, 9, 512, 3, 1, 512),
                                                (2, 9, 9, 256, 1, 2, 512)])
def test_conv_kan_auto_matches_plain_version(cuda_device, monkeypatch, B, H, W, C, k, stride,
                                             N):
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    from chip_smoke import CONV_REL

    grid = SplineGrid(-1.0, 1.0, 3, 3)
    g = torch.Generator(device="cuda").manual_seed(C + N)
    params = KL.init_kan_layer(KL.KANLayerConfig(C * k * k, N, grid), g)
    x = torch.rand(B, H, W, C, generator=g, device=cuda_device) * 2.2 - 1.1
    ops.reset_launches()
    y = KL.conv_kan_apply(params, x, grid, kh=k, kw=k, stride=stride, pad=k // 2, method="auto")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["kan_fused_gemm"] == 1 and sum(ops.LAUNCHES.values()) == 1
    patches = KL.im2col(x, k, k, stride, k // 2)
    rows = patches.shape[0] * patches.shape[1] * patches.shape[2]
    assert rows % 128 and y.shape == patches.shape[:3] + (N,)
    assert torch.equal(patches.cpu(), KL.im2col(x.cpu(), k, k, stride, k // 2))
    want = F.kan_fused_gemm_reference(patches.reshape(rows, -1), params["coeff"], grid,
                                      params["base_w"]).reshape(y.shape)
    scale = want.abs().max().item()
    assert (y - want).abs().max().item() <= CONV_REL * scale


@pytest.mark.cuda
def test_training_steps_on_card_match_the_cpu(cuda_device):
    """Three steps of ``examples/mnist_kan.adam_step`` at (64, 16, 10) on the
    card against the same steps on the CPU, from the same start and
    batches: Adam moments within 1e-5 of each leaf's max, parameters within
    1e-2 lr (a step near eps carries its gradient's rounding error, as
    tests/test_torch_apps.py sets out)."""
    from repro_torch.data import pipeline as dp
    from repro_torch.examples import mnist_kan as MK

    cfg, lr = KL.KANNetConfig(layers=(64, 16, 10), G=10, P=3), 3e-3
    X, Y = dp.mnist_like(1024, seed=1, noise=2.4, dim=64)
    idx = MK.batch_indices(3, 256, len(X))
    out = {}
    for dev in ("cpu", "cuda"):
        p = MK.init_kan_net_threefry(cfg, seed=0, device=dev)
        m = [{k: torch.zeros_like(a) for k, a in q.items()} for q in p]
        v = [{k: torch.zeros_like(a) for k, a in q.items()} for q in p]
        xt = torch.tensor(X, device=dev)
        yt = torch.tensor(Y, dtype=torch.int64, device=dev)
        for t, b in enumerate(idx):
            bt = torch.tensor(b, device=dev)
            p, m, v = MK.adam_step(p, m, v, t, xt[bt], yt[bt], cfg, lr)
        out[dev] = (p, m, v)
    for name, got, want in zip(("params", "m", "v"), out["cuda"], out["cpu"]):
        for gl, wl in zip(got, want):
            for k in wl:
                atol = 1e-2 * lr if name == "params" else 1e-5 * wl[k].abs().max().item()
                torch.testing.assert_close(gl[k].cpu(), wl[k], rtol=0, atol=atol)


@pytest.mark.cuda
def test_trained_int8_path_equals_plain_integer_path(cuda_device):
    """MNIST-KAN trained 30 steps on the card, quantised on the card: the
    int8 net through the kernels (2048 rows: the dense-band kernel; 8 rows:
    the sparse one) equals the plain integer path bit for bit, and the
    quantisation equals a CPU quantisation of the same weights."""
    from repro_torch.examples import mnist_kan as MK

    cfg, params, (Xte, _) = MK.train_mnist_kan(steps=30, device="cuda")
    q = MK.quantize_net(cfg, params)
    for ql, p in zip(q, params):
        cpu = Q.quantize_kan_layer({k: v.cpu() for k, v in p.items()}, cfg.grid())
        assert torch.equal(cpu.coeff_q, ql.coeff_q.cpu())
        assert torch.equal(cpu.base_w_q, ql.base_w_q.cpu())
    x = torch.as_tensor(Xte, device=cuda_device)
    for rows, kernel in ((2048, "kan_int8_gemm"), (8, "kan_sparse_int8_gemm")):
        ops.reset_launches()
        got = MK.int8_net_apply(q, x[:rows])
        torch.cuda.synchronize()
        assert ops.LAUNCHES[kernel] == 2 and sum(ops.LAUNCHES.values()) == 2
        assert torch.equal(got, MK.int8_net_apply(q, x[:rows], fused=False))
