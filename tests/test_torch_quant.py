"""The port's integer-only KAN inference against the JAX package, on the CPU.

``repro_torch.core.quantization`` and the int8 kernel wrappers (which run
their plain versions on CPU tensors) against ``repro.core.quantization``
and the interpret-mode Pallas kernels, on the same numpy inputs.

Tolerances: every integer exactly equal (``x_q``, ``addr``, ``k``, the ROM
values, ``coeff_q``, ``base_w_q``, the int32 accumulators), and the float
scales too (the same fp32 operations on both sides); float layer outputs
rtol = atol = 1e-6 (the same integer accumulator times the same fp32 scale,
plus a base term whose integer GEMM is exact on both sides: only the last
fp32 rounding of the sum may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.core.bspline import SplineGrid as JGrid
from repro.kernels import ops as jops
from repro_torch.core import quantization as tq
from repro_torch.core.bspline import SplineGrid, build_lut
from repro_torch.kernels import bspline_lut as L
from repro_torch.kernels import kan_int8_gemm as I8
from repro_torch.kernels import kan_sparse_gemm as S
from repro_torch.kernels import ops

OUT_TOL = 1e-6
# (G, P, BS, K, N): the JAX kernel tests' SHAPES (tests/test_kernels.py),
# which include ragged K/N, BS=1 and the MNIST-KAN basis (G=10)
SHAPES = [(5, 3, 64, 16, 32), (5, 3, 100, 37, 50), (10, 3, 64, 20, 10),
          (3, 2, 33, 5, 7), (2, 1, 17, 3, 4), (3, 3, 1, 22, 60)]
OUT_DTYPES = {"float32": (torch.float32, jnp.float32),
              "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _isolated_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("KAN_SAS_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))


def _grids(G, P):
    return SplineGrid(-1.0, 1.0, G, P), JGrid(-1.0, 1.0, G, P)


def _x(grid, BS, K, seed):
    """Uniform over [-1.2, 1.2] (past the domain on both sides) with x_min,
    x_max and every knot planted at the front."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1.2, 1.2, (BS, K)).astype(np.float32)
    plant = np.concatenate([[grid.x_min, grid.x_max], grid.knots()]).astype(np.float32)
    x.reshape(-1)[: min(plant.size, x.size)] = plant[: x.size]
    return x


def _params(grid, K, N, seed, base=True):
    rs = np.random.RandomState(seed)
    p = {"coeff": (0.1 * rs.randn(K, grid.n_basis, N)).astype(np.float32)}
    if base:
        p["base_w"] = (0.3 * rs.randn(K, N)).astype(np.float32)
    return p


def _both(params):
    return ({k: torch.tensor(v) for k, v in params.items()},
            {k: jnp.asarray(v) for k, v in params.items()})


def _jax_fused(jl, x, jdt):
    """The JAX package's ``quantized_kan_forward_fused`` with its kernel's
    oracle in place of the interpret-mode Pallas call (``ref_kan_gemm_int8``,
    which its own tests hold the kernel to exactly)."""
    from repro.kernels import ref as jref

    qg = jl.qg
    x = jnp.asarray(x, jdt)
    x_q = qg.x_quant.quantize(x)
    acc = jref.ref_kan_gemm_int8(x_q, jl.coeff_q.astype(jnp.int8), jl.lut_u8, qg.grid)
    scale = jl.coeff_scale.reshape(-1) / qg.lut_scale
    y = (acc.astype(jnp.float32) * scale[None, :]).astype(jdt)
    base = jq._quantized_base_term(jl, x_q, y.shape)
    return y + base.astype(y.dtype)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)


@pytest.mark.parametrize("lo,hi,bits", [(-1.6, 1.6, 8), (-2.0, 3.0, 8), (-1.0, 1.0, 4)])
def test_affine_quant_matches(lo, hi, bits):
    a, b = tq.affine_from_range(lo, hi, bits), jq.affine_from_range(lo, hi, bits)
    assert (a.scale, a.zero, a.qmax) == (b.scale, b.zero, b.qmax)
    x = np.random.RandomState(bits).uniform(lo - 1, hi + 1, 5000).astype(np.float32)
    x[:3] = [lo, hi, 0.0]
    q = a.quantize(torch.tensor(x))
    assert q.dtype == torch.int32
    _eq(b.quantize(jnp.asarray(x)), q)
    _eq(b.dequantize(jnp.asarray(q.numpy())), a.dequantize(q))


@pytest.mark.parametrize("axis", [None, (0, 1), 0])
def test_symmetric_scales_match(axis):
    w = np.random.RandomState(3).randn(9, 7, 5).astype(np.float32)
    w[:, :, 2] = 0.0                               # an all-zero channel: the 1e-12 floor
    _eq(jq.symmetric_scales(jnp.asarray(w), axis=axis),
        tq.symmetric_scales(torch.tensor(w), axis=axis))


@pytest.mark.parametrize("P", [1, 2, 3])
def test_lut_scale_and_u8_tables_match(P):
    assert tq.lut_value_scale(P) == jq.lut_value_scale(P)
    for S in (256, 4096):
        for scale in (None, 192):
            np.testing.assert_array_equal(tq.build_lut_u8(P, S, scale),
                                          jq.build_lut_u8(P, S, scale))


@pytest.mark.parametrize("G,P", [(10, 3), (5, 3), (3, 2), (2, 1)])
def test_int_address_and_lut_fetch_match(G, P):
    tg, jg = _grids(G, P)
    tqg, jqg = tq.QuantizedGrid.make(tg), jq.QuantizedGrid.make(jg)
    tx, jx = tqg.x_quant, jqg.x_quant
    assert (tqg.lut_scale, tqg.S, tx.scale, tx.zero, tx.bits) == (
        jqg.lut_scale, jqg.S, jx.scale, jx.zero, jx.bits)
    # every in-range code, 0 and qmax, and codes past both ends
    xq = np.concatenate([np.arange(0, 256), np.random.RandomState(G).randint(-600, 900, 500),
                         [-1, 256, -255, 511]]).astype(np.int32)
    addr, k = tq.int_address(tqg, torch.tensor(xq))
    jaddr, jk = jq.int_address(jqg, jnp.asarray(xq))
    _eq(jaddr, addr)
    _eq(jk, k)
    lut = tq.build_lut_u8(P, 256)
    _eq(jq.lut_fetch_u8(jqg, jnp.asarray(lut), jaddr),
        tq.lut_fetch_u8(tqg, torch.tensor(lut), addr))


@pytest.mark.parametrize("base", [True, False])
@pytest.mark.parametrize("G,P", [(10, 3), (2, 1)])
def test_quantize_kan_layer_matches(G, P, base):
    tg, jg = _grids(G, P)
    tp, jp = _both(_params(tg, 11, 6, G + P, base))
    t, j = tq.quantize_kan_layer(tp, tg), jq.quantize_kan_layer(jp, jg)
    assert t.coeff_q.dtype == torch.int32
    _eq(j.coeff_q, t.coeff_q)
    _eq(j.coeff_scale, t.coeff_scale)
    _eq(j.lut_u8, t.lut_u8)
    if base:
        _eq(j.base_w_q, t.base_w_q)
        _eq(j.base_w_scale, t.base_w_scale)
    else:
        assert t.base_w_q is None and t.base_w_scale is None


@pytest.mark.parametrize("G,P,BS,K,N", SHAPES)
def test_int8_accumulators_match(G, P, BS, K, N):
    """Both int8 kernels' plain versions give the JAX oracle's int32
    accumulator exactly, at scale 256 (or 128) and at the paper's 192."""
    from repro.kernels import ref as jref

    tg, jg = _grids(G, P)
    qg = tq.QuantizedGrid.make(tg)
    xq = qg.x_quant.quantize(torch.tensor(_x(tg, BS, K, BS + K)))
    cq = np.random.RandomState(N).randint(-127, 128, (K, tg.n_basis, N)).astype(np.int8)
    for scale in (None, 192):
        lut = tq.build_lut_u8(P, 256, scale)
        want = jref.ref_kan_gemm_int8(jnp.asarray(xq.numpy()), jnp.asarray(cq),
                                      jnp.asarray(lut), jg)
        for fn in (ops.kan_int8_gemm, ops.kan_sparse_int8_gemm):
            got = fn(xq, torch.tensor(lut), torch.tensor(cq), tg)
            assert got.dtype == torch.int32
            _eq(want, got)


@pytest.mark.parametrize("out", sorted(OUT_DTYPES))
@pytest.mark.parametrize("G,P,BS,K,N", SHAPES)
def test_quantized_forward_matches(G, P, BS, K, N, out):
    """``quantized_kan_forward`` and ``quantized_kan_forward_fused`` against
    the JAX package's (the fused one with the kernel's oracle)."""
    tdt, jdt = OUT_DTYPES[out]
    tg, jg = _grids(G, P)
    tp, jp = _both(_params(tg, K, N, G * K + N))
    tl, jl = tq.quantize_kan_layer(tp, tg), jq.quantize_kan_layer(jp, jg)
    x = _x(tg, BS, K, K + N)
    want = np.asarray(jq.quantized_kan_forward(jl, jnp.asarray(x)))
    got = tq.quantized_kan_forward(tl, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=OUT_TOL, atol=OUT_TOL)
    # the fused path emits x.dtype (quantising, dequantising and adding the
    # base term in it), as the reference's fused path does
    fused = tq.quantized_kan_forward_fused(tl, torch.tensor(x).to(tdt))
    assert fused.dtype == tdt and fused.shape == (BS, N)
    np.testing.assert_allclose(fused.float().numpy(),
                               np.asarray(_jax_fused(jl, x, jdt), np.float32),
                               rtol=OUT_TOL, atol=OUT_TOL)


def test_fused_and_plain_int8_paths_agree_exactly_in_fp32():
    tg, _ = _grids(10, 3)
    tp, _ = _both(_params(tg, 30, 12, 5))
    ql = tq.quantize_kan_layer(tp, tg)
    x = torch.tensor(_x(tg, 9, 30, 6))
    assert torch.equal(tq.quantized_kan_forward(ql, x), tq.quantized_kan_forward_fused(ql, x))


@pytest.mark.parametrize("G,P,BS,K,N", SHAPES[:3] + SHAPES[4:5])
def test_int8_coefficient_copy_is_made_once_and_keeps_the_integers(G, P, BS, K, N,
                                                                   monkeypatch):
    """``quantize_kan_layer`` keeps ``coeff_q`` (int32, compared with the JAX
    package) and its int8 copy; ``quantized_kan_forward_fused`` hands the
    kernel that copy itself, not a new cast, and its int32 accumulator is
    the one the int32 ``coeff_q`` gives."""
    from repro_torch.kernels import ops as kops

    tg, jg = _grids(G, P)
    tp, jp = _both(_params(tg, K, N, G + K * N))
    ql = tq.quantize_kan_layer(tp, tg)
    assert ql.coeff_i8.dtype == torch.int8 and ql.coeff_i8.is_contiguous()
    assert torch.equal(ql.coeff_i8.to(torch.int32), ql.coeff_q)
    _eq(jq.quantize_kan_layer(jp, jg).coeff_q.astype(jnp.int8), ql.coeff_i8)
    seen, accs = [], []
    gemm = kops.kan_int8_gemm

    def spy(x_q, lut_u8, coeff, grid, **kw):
        seen.append(coeff)
        accs.append(gemm(x_q, lut_u8, coeff, grid, lut_scale=kw["lut_scale"]))
        return gemm(x_q, lut_u8, coeff, grid, **kw)

    monkeypatch.setattr(kops, "kan_int8_gemm", spy)
    x = torch.tensor(_x(tg, BS, K, K + N))
    y = tq.quantized_kan_forward_fused(ql, x)
    assert len(seen) == 1 and seen[0] is ql.coeff_i8
    x_q = ql.qg.x_quant.quantize(x)
    want = I8.kan_int8_gemm_reference(x_q, ql.coeff_q, tg, lut_scale=ql.qg.lut_scale)
    assert torch.equal(accs[0], want)
    assert torch.equal(y, tq.quantized_kan_forward(ql, x))


def test_resolve_int8_method_takes_the_sparse_kernel_at_decode_rows(monkeypatch):
    r = tq.resolve_int8_method
    assert r(torch.device("cuda"), 8) == r(torch.device("cuda", 0), 1) == "sparse_int8"
    assert r(torch.device("cuda"), 9) == r(torch.device("cuda"), 2048) == "int8"
    assert r(torch.device("cpu"), 1) == r(torch.device("cpu"), 2048) == "int8"
    monkeypatch.setenv("KAN_SAS_SPARSE_MAX_ROWS", "16")
    assert r(torch.device("cuda"), 16) == "sparse_int8" and r(torch.device("cuda"), 17) == "int8"


def test_resolve_lut_scale_accepts_build_lut_u8_tables_and_rejects_others():
    g = SplineGrid(-1.0, 1.0, 10, 3)
    assert I8.resolve_lut_scale(torch.tensor(tq.build_lut_u8(3, 256)), g, 256) == 256
    assert I8.resolve_lut_scale(tq.build_lut_u8(3, 256, 192), g, 256) == 192
    assert I8.resolve_lut_scale(tq.build_lut_u8(3, 4096), g, 4096) == 256
    bad = tq.build_lut_u8(3, 256).copy()
    bad[17, 1] += 1
    with pytest.raises(ValueError, match="no integer value scale"):
        I8.resolve_lut_scale(bad, g, 256)
    with pytest.raises(ValueError, match="no integer value scale"):
        ops.kan_int8_gemm(torch.zeros(2, 4, dtype=torch.int32), torch.tensor(bad),
                          torch.zeros(4, 13, 3, dtype=torch.int8), g)
    # the reference agrees on both sides of the contract
    jg = JGrid(-1.0, 1.0, 10, 3)
    from repro.kernels import kan_int8_gemm as jI8
    assert jI8.resolve_lut_scale(jq.build_lut_u8(3, 256, 192), jg, 256) == 192
    with pytest.raises(ValueError):
        jI8.resolve_lut_scale(bad, jg, 256)


def test_scale_epilogue_rounds_once_into_bf16():
    """``acc·scale`` in fp32, then one round-to-nearest-even into bf16."""
    g = SplineGrid(-1.0, 1.0, 5, 3)
    xq = torch.tensor(np.random.RandomState(1).randint(0, 256, (7, 9)).astype(np.int32))
    cq = torch.tensor(np.random.RandomState(2).randint(-127, 128, (9, 8, 5)).astype(np.int8))
    lut = torch.tensor(tq.build_lut_u8(3, 256))
    sc = torch.tensor(np.random.RandomState(3).uniform(1e-5, 1e-3, 5).astype(np.float32))
    acc = ops.kan_int8_gemm(xq, lut, cq, g)
    for fn in (ops.kan_int8_gemm, ops.kan_sparse_int8_gemm):
        y = fn(xq, lut, cq, g, scale=sc, out_dtype=torch.bfloat16)
        assert torch.equal(y, (acc.float() * sc).to(torch.bfloat16))


def test_int8_pallas_kernels_match_the_port_on_a_small_case():
    """Kernels 3, 4 and 6 of the JAX package, in interpret mode, against the
    port's wrappers on the same inputs (29 rows)."""
    tg, jg = _grids(10, 3)
    qg = tq.QuantizedGrid.make(tg)
    x = _x(tg, 29, 21, 8)
    xq = qg.x_quant.quantize(torch.tensor(x))
    cq = np.random.RandomState(4).randint(-127, 128, (21, tg.n_basis, 11)).astype(np.int8)
    sc = np.random.RandomState(5).uniform(1e-4, 1e-3, 11).astype(np.float32)
    lut = tq.build_lut_u8(3, 256)
    jargs = (jnp.asarray(xq.numpy()), jnp.asarray(lut), jnp.asarray(cq), jg)
    targs = (xq, torch.tensor(lut), torch.tensor(cq), tg)
    tiles = dict(bb=8, bn=8, bk=8, interpret=True)
    for jfn, tfn in ((jops.kan_int8_gemm, ops.kan_int8_gemm),
                     (jops.kan_sparse_int8_gemm, ops.kan_sparse_int8_gemm)):
        _eq(jfn(*jargs, **tiles), tfn(*targs))
        y = tfn(*targs, scale=torch.tensor(sc))
        jy = jfn(*jargs, scale=jnp.asarray(sc), **tiles)
        _eq(jy, y)
    flut = build_lut(3, 256)
    from repro.core.bspline import build_lut as jbuild_lut
    jflut = jbuild_lut(3, 256)
    jvals, jk = jops.bspline_lut(jnp.asarray(x.reshape(-1)), jnp.asarray(jflut), jg,
                                 block=128, interpret=True)
    vals, k = ops.bspline_lut(torch.tensor(x.reshape(-1)), torch.tensor(jflut), tg)
    _eq(jk, k)
    _eq(jvals, vals)                               # exact on the reference's table
    vals, k = ops.bspline_lut(torch.tensor(x), torch.tensor(flut), tg)
    assert vals.shape == (29, 21, 4) and k.shape == (29, 21)
    np.testing.assert_allclose(vals.reshape(-1, 4).numpy(), np.asarray(jvals), rtol=0,
                               atol=1e-6)


def test_cpu_wrappers_count_no_launch_and_keep_leading_dims():
    g = SplineGrid(-1.0, 1.0, 10, 3)
    ops.reset_launches()
    xq = torch.randint(0, 256, (2, 3, 7), dtype=torch.int32)
    cq = torch.randint(-127, 128, (7, 13, 5), dtype=torch.int8)
    lut = torch.tensor(tq.build_lut_u8(3, 256))
    for fn in (ops.kan_int8_gemm, ops.kan_sparse_int8_gemm):
        assert fn(xq, lut, cq, g).shape == (2, 3, 5)
    vals, k = ops.bspline_lut(torch.rand(2, 3), torch.tensor(build_lut(3)), g)
    assert vals.shape == (2, 3, 4) and k.shape == (2, 3)
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_cuda_launchers_reject_what_the_kernels_do_not_take():
    """Checked before anything is built or launched."""
    g = SplineGrid(-1.0, 1.0, 10, 3)
    xq = torch.zeros(4, 16, dtype=torch.int32)
    cq = torch.zeros(16, 13, 8, dtype=torch.int8)
    for launcher, max_m in ((I8.kan_int8_gemm_cuda, I8.MAX_M),
                            (S.kan_sparse_int8_gemm_cuda, S.MAX_M)):
        with pytest.raises(ValueError, match="does not match"):
            launcher(xq, torch.zeros(15, 13, 8, dtype=torch.int8), g)
        with pytest.raises(ValueError, match="int32"):
            launcher(xq.long(), cq, g)
        with pytest.raises(ValueError, match="contiguous"):
            launcher(torch.zeros(16, 4, dtype=torch.int32).t(), cq, g)
        with pytest.raises(ValueError, match="float32 with 8"):
            launcher(xq, cq, g, scale=torch.zeros(7))
        with pytest.raises(ValueError, match="out_dtype"):
            launcher(xq, cq, g, scale=torch.zeros(8), out_dtype=torch.float16)
        with pytest.raises(ValueError, match="compiled for P"):
            launcher(xq, torch.zeros(16, 9, 8, dtype=torch.int8), SplineGrid(-1.0, 1.0, 5, 4))
        wide = SplineGrid(-1.0, 1.0, max_m + 1 - 3, 3)
        with pytest.raises(ValueError, match=f"M=G\\+P <= {max_m}"):
            launcher(xq, torch.zeros(16, wide.n_basis, 8, dtype=torch.int8), wide)
        with pytest.raises(ValueError, match="shared memory"):
            launcher(xq, cq, g, S=10000)
    with pytest.raises(ValueError, match="float32"):
        L.bspline_lut_cuda(torch.zeros(8, dtype=torch.bfloat16), torch.zeros(256, 2), g)
    with pytest.raises(ValueError, match="compiled for P"):
        L.bspline_lut_cuda(torch.zeros(8), torch.zeros(256, 3), g)


@pytest.mark.parametrize("scale", [None, 192])
@pytest.mark.parametrize("G,P", [(2, 1), (3, 2), (10, 3)])
def test_every_rom_address_reads_the_table(G, P, scale):
    """Under ``rom_probe``'s operands each int8 kernel's plain version
    returns, for every one of the S addresses, the ``build_lut_u8`` bytes
    the JAX oracle reads (direct and inverted-address fetch)."""
    from repro.kernels import ref as jref

    tg, jg = _grids(G, P)
    for S in (256, 4096):
        lut = tq.build_lut_u8(P, S, scale)
        x_q, qmax, coeff = I8.rom_probe(tg, S)
        want = jref.ref_kan_gemm_int8(jnp.asarray(x_q.numpy()), jnp.asarray(coeff.numpy()),
                                      jnp.asarray(lut), jg, qmax=qmax)
        for fn in (ops.kan_int8_gemm, ops.kan_sparse_int8_gemm):
            _eq(want, fn(x_q, torch.tensor(lut), coeff, tg, qmax=qmax))


def test_rom_probe_reaches_every_address():
    """``rom_probe`` reaches every address (checked with the reference's
    own address arithmetic at its ``qmax``)."""
    tg, jg = _grids(10, 3)
    x_q, qmax, _ = I8.rom_probe(tg, 256)
    u = (jg.G + 2 * jg.P) * np.asarray(x_q.numpy()[:, 0], np.int64)
    k = np.clip(u // qmax, jg.P, jg.n_basis - 1)
    addr = (np.clip(u - qmax * k, 0, qmax) * 255) // qmax
    assert set(addr.tolist()) == set(range(256))


def test_rom_values_are_the_tables_where_the_reference_kernels_round_a_half_down():
    """The reference's kernels evaluate the ROM from the float Cox-de Boor
    triangle; for P=2 at value scale 192 the entry at address 2 is exactly
    94.50002, which their float32 evaluation rounds to 94 where
    ``build_lut_u8`` (and the reference's oracle) hold 95.  The port reads
    the table; elsewhere it equals the reference's kernels."""
    from repro.kernels import common as jcommon
    from repro_torch.kernels import common as tcommon

    for G, P in ((2, 1), (3, 2), (10, 3)):
        tg, jg = _grids(G, P)
        for scale in (tq.lut_value_scale(P), 192):
            x_q = np.arange(-40, 300, dtype=np.int32)
            jv, jk = jcommon.int8_compact_values_inblock(jnp.asarray(x_q), jg, 256, 255, scale)
            tv, tk = tcommon.int8_compact_values_inblock(torch.tensor(x_q), tg, 256, 255, scale)
            _eq(jk, tk)
            diff = np.nonzero((np.asarray(jv) != tv.numpy()).any(-1))[0]
            if (P, scale) != (2, 192):
                assert diff.size == 0
                continue
            addr, _ = tq.int_address(tq.QuantizedGrid.make(tg), torch.tensor(x_q))
            fetched = tq.lut_fetch_u8(tq.QuantizedGrid.make(tg),
                                      torch.tensor(tq.build_lut_u8(2, 256, 192)), addr)
            assert torch.equal(tv, fetched)
            assert diff.size > 0 and set(addr[diff].tolist()) <= {2, 253}
            assert sorted(set(np.asarray(jv)[diff].reshape(-1).tolist())
                          - set(tv[diff].reshape(-1).tolist())) == [94]
