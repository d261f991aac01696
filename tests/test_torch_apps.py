"""The paper's KAN applications in the port against the JAX package, on the
CPU: the synthetic data sets, ConvKAN (``im2col``, ``conv_kan_apply``,
``kan_layer_flops``), the systolic-array model (``core/sa_model.py``),
MNIST-KAN training (``examples/mnist_kan.py``) and the three examples.

Tolerances: data sets and ``im2col`` byte-equal; ``conv_kan_apply`` atol
1e-5 (|y| ~ 2, fp32 sums over K·(P+1) or K·M terms in another order); the
SA model's numbers exactly equal (the same numpy code); after 3 steps of
the reference's training at full width the parameters within 5e-2 ``lr``
(Adam divides each gradient by its own scale, so every element moves by
about ``lr`` whatever its gradient's size; where |g| is near 1e-7 the eps
of 1e-8 is a tenth of the divisor and the step carries the gradient's
relative rounding error, which another summation order and a start a few
ulps of ``erfinv`` away make: 1.6e-2 ``lr`` seen, at any of steps 1-3; a
wrong batch order moves them by 7.8 ``lr``).  The reference's 250 steps
take 12 to 52 s on the CPU, too long for a tier-1 file: ``chip_smoke.py``
phase 9(a) holds the card's run to the reference's accuracy.
"""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kan_layer as jkl
from repro.core import sa_model as jsm
from repro.core.bspline import SplineGrid as JGrid
from repro.data import pipeline as jdp
from repro_torch import convert
from repro_torch.core import kan_layer as tkl
from repro_torch.core import sa_model as tsm
from repro_torch.core.bspline import SplineGrid as TGrid
from repro_torch.data import pipeline as tdp
from repro_torch.examples import mnist_kan as tmk
from repro_torch.examples import quickstart as tqs
from repro_torch.examples import serve_kan as tsk


CONV_ATOL = 1e-5
STEP_LR = 5e-2


@pytest.mark.parametrize("kw", [dict(n=64), dict(n=100, seed=3, noise=2.4),
                                dict(n=50, seed=1, dim=64, n_classes=4, proto_seed=7)])
def test_mnist_like_is_byte_equal(kw):
    (tx, ty), (jx, jy) = tdp.mnist_like(**kw), jdp.mnist_like(**kw)
    assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
    assert tx.tobytes() == jx.tobytes() and ty.tobytes() == jy.tobytes()


@pytest.mark.parametrize("n,seed", [(100, 0), (33, 5)])
def test_regression_set_is_byte_equal(n, seed):
    for t, j in zip(tdp.regression_set(n, seed), jdp.regression_set(n, seed)):
        assert t.dtype == j.dtype and t.shape == j.shape and t.tobytes() == j.tobytes()


@pytest.mark.parametrize("kh,kw,stride,pad,C", [(3, 3, 1, 1, 4), (3, 3, 2, 1, 4),
                                                (1, 1, 2, 0, 4), (3, 2, 2, 0, 4),
                                                (3, 3, 1, 1, 1)])
def test_im2col_is_bit_equal(kh, kw, stride, pad, C):
    x = np.random.RandomState(C).uniform(-1, 1, (2, 9, 8, C)).astype(np.float32)
    want = np.asarray(jkl.im2col(jnp.asarray(x), kh, kw, stride, pad))
    got = tkl.im2col(torch.tensor(x), kh, kw, stride, pad)
    assert got.is_contiguous() and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ["dense", "compact", "lut", "fused", "sparse", "auto"])
def test_conv_kan_apply_matches_reference(method):
    """A 3 x 3 stride-2 ConvKAN (C = 3, as ResKAN18's conv1) on 2 x 7 x 7
    images: 32 rows of K = 27, a K that is not a multiple of the fused
    kernel's K step.  The reference runs its Pallas kernels in interpret
    mode; the port's wrappers run their plain versions on the CPU."""
    jg, tg = JGrid(-1.0, 1.0, 3, 3), TGrid(-1.0, 1.0, 3, 3)
    jp = jkl.init_kan_layer(jax.random.PRNGKey(5), jkl.KANLayerConfig(27, 5, jg))
    x = np.random.RandomState(6).uniform(-1.1, 1.1, (2, 7, 7, 3)).astype(np.float32)
    run = functools.partial(jkl.conv_kan_apply, grid=jg, stride=2, method=method)
    if method != "lut":                  # the reference builds its table in numpy
        run = jax.jit(run)
    want = np.asarray(run(jp, jnp.asarray(x)))
    tp = convert.params_from_jax(jax.device_get(jp), device="cpu")
    got = tkl.conv_kan_apply(tp, torch.tensor(x), tg, stride=2, method=method)
    assert got.shape == want.shape == (2, 4, 4, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CONV_ATOL)


@pytest.mark.parametrize("BS,K,N,G,P", [(64, 784, 64, 10, 3), (7, 27, 64, 3, 3),
                                        (1, 200, 16, 2, 1)])
def test_kan_layer_flops_equal(BS, K, N, G, P):
    assert tkl.kan_layer_flops(BS, K, N, TGrid(-1.0, 1.0, G, P)) == \
        jkl.kan_layer_flops(BS, K, N, JGrid(-1.0, 1.0, G, P))


def _arrays(sm, ws):
    """``benchmarks/workloads.py``'s two arrays for an application."""
    M, N = max(w.M for w in ws), max(w.N for w in ws)
    return sm.SAConfig(32, 32, "scalar"), sm.SAConfig(16, 16, "nm", N=N, M=M)


@pytest.mark.parametrize("fixed_gp", [None, (5, 3)])
def test_sa_model_suite_equals_reference(fixed_gp):
    """``run_suite`` cycles, MACs and utilization over ``paper_workloads(64)``
    on both arrays of ``benchmarks/workloads.py``, with and without
    fill/drain, equal to the reference's; the workloads themselves too."""
    japps, tapps = jsm.paper_workloads(64, fixed_gp), tsm.paper_workloads(64, fixed_gp)
    assert list(japps) == list(tapps)
    for name in japps:
        assert [dataclasses.astuple(w) for w in tapps[name]] == \
            [dataclasses.astuple(w) for w in japps[name]]
        for ta, ja in zip(_arrays(tsm, tapps[name]), _arrays(jsm, japps[name])):
            assert (ta.area_mm2(), ta.power_mw()) == (ja.area_mm2(), ja.power_mw())
            for fd in (False, True):
                t, j = tsm.run_suite(ta, tapps[name], fd), jsm.run_suite(ja, japps[name], fd)
                assert (t.cycles, t.useful_macs, t.mac_slots, t.utilization) == \
                    (j.cycles, j.useful_macs, j.mac_slots, j.utilization), (name, fd)


def test_sa_model_helpers_equal_reference():
    """Power, delay, area and energy of every Table I pattern and two fitted
    ones, the ArKANe comparison, and ResKAN18's 20 GEMMs at two sizes."""
    for N, M in list(jsm.TABLE_I) + [(3, 5), (4, 13)]:
        for f in ("pe_power_mw", "pe_delay_ns", "pe_area_um2", "normalized_energy"):
            assert getattr(tsm, f)(N, M) == getattr(jsm, f)(N, M), (f, N, M)
    for n, G, P in [(784, 10, 3), (22, 3, 3), (200, 2, 1)]:
        assert tsm.arkane_cycles(n, G, P) == jsm.arkane_cycles(n, G, P)
        assert tsm.kansas_bspline_cycles(n, 72) == jsm.kansas_bspline_cycles(n, 72)
    assert tsm.arkane_equiv_units(3) == jsm.arkane_equiv_units(3)
    for kw in (dict(), dict(G=5, P=2, img=64, BS=2)):
        t, j = tsm.resnet18_convkan_gemms(**kw), jsm.resnet18_convkan_gemms(**kw)
        assert len(t) == 20 and [dataclasses.astuple(w) for w in t] == \
            [dataclasses.astuple(w) for w in j]


def test_adam_steps_match_reference(monkeypatch):
    """The port's ``train_mnist_kan`` against the reference's own
    (``benchmarks/quant_accuracy.train_mnist_kan``) at its defaults, cut to
    3 steps: the same start, data and batch order, so the parameters agree
    within ``STEP_LR`` lr and the test sets are equal."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    from benchmarks import quant_accuracy

    steps, lr = 3, 3e-3
    _, jp, (jXte, jYte) = quant_accuracy.train_mnist_kan(steps=steps, lr=lr)
    _, p, (Xte, Yte) = tmk.train_mnist_kan(steps=steps, lr=lr, device="cpu")
    assert Xte.tobytes() == jXte.tobytes() and Yte.tobytes() == jYte.tobytes()
    for gl, wl in zip(p, jax.device_get(jp)):
        assert set(gl) == set(wl)
        for k in gl:
            np.testing.assert_allclose(gl[k].numpy(), np.asarray(wl[k]), rtol=0,
                                       atol=STEP_LR * lr, err_msg=k)


def test_init_kan_net_threefry_is_the_reference_start():
    """The port's threefry start equals ``init_kan_net(PRNGKey(seed))``
    within a few ulps of ``erfinv`` (relative 1e-5 of each leaf's max)."""
    cfg = jkl.KANNetConfig(layers=(64, 16, 10), G=10, P=3)
    want = jax.device_get(jkl.init_kan_net(jax.random.PRNGKey(3), cfg))
    got = tmk.init_kan_net_threefry(tkl.KANNetConfig(layers=(64, 16, 10), G=10, P=3), 3,
                                    device="cpu")
    for gl, wl in zip(got, want):
        for k in wl:
            np.testing.assert_allclose(gl[k].numpy(), np.asarray(wl[k]), rtol=0,
                                       atol=1e-5 * np.abs(wl[k]).max())


def test_mnist_kan_example_runs_on_the_cpu(capsys):
    assert tmk.main(["--steps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "fp32 accuracy" in out and "int8 accuracy" in out and "drop" in out


def test_quickstart_example_runs_on_the_cpu(capsys):
    assert tqs.main(["--steps", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    mse = {ln.split()[0]: float(ln.split()[1]) for ln in out
           if ln.strip().split(" ")[0] in ("dense", "compact", "lut", "fused", "int8")}
    assert set(mse) == {"dense", "compact", "lut", "fused", "int8"}
    assert all(np.isfinite(v) for v in mse.values())
    assert abs(mse["compact"] - mse["dense"]) < 1e-4 and abs(mse["fused"] - mse["dense"]) < 1e-4


@pytest.mark.parametrize("flags", [[], ["--engine", "continuous"],
                                   ["--engine", "continuous", "--shared-prefix"],
                                   ["--engine", "continuous", "--spec-k", "2"]])
def test_serve_kan_example_runs_on_the_cpu(flags, capsys):
    assert tsk.main(flags + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 12 requests / 192 new tokens" in out
    if "--shared-prefix" in flags:
        assert "prefill_tokens_saved=" in out and "prefix_hit_blocks=0 " not in out
    if "--spec-k" in flags:
        assert "speculative: k=2" in out


@pytest.mark.parametrize("flags", [["--mesh", "1x2"], ["--spec-k", "2"], ["--shared-prefix"]])
def test_serve_kan_example_refuses_with_rc_2(flags, capsys):
    with pytest.raises(SystemExit) as e:
        tsk.main(flags + ["--device", "cpu"])
    assert e.value.code == 2
    if "--mesh" in flags:
        assert "--mesh is not ported yet (ROADMAP queue 1, item 9)" in capsys.readouterr().err


def test_chip_smoke_apps_phase_rehearses_on_the_cpu(monkeypatch):
    """Phase 9's checks on the kernels' plain versions (every launch count
    0): MNIST-KAN trained at a narrow width for a few steps, then ResKAN18's
    20 layers at a batch of 2 of 8 x 8 images."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    out = chip_smoke.mnist_train_path(torch, np, device="cpu", layers=(64, 16, 10), steps=5)
    assert set(out["runs"]) == {"train", "dense", "auto", "lut", "int8"}
    assert out["auto_vs_dense_err"] <= chip_smoke.FP32_ATOL
    out = chip_smoke.reskan_path(torch, device="cpu", batch=2, img=8)
    assert out["im2col_kinds_equal"] == 4 and len(out["layers"]) == 20
    assert out["max_rel_err"] <= chip_smoke.CONV_REL
    assert [ly["rows"] for ly in out["layers"]][:6] == [128] * 6
