"""The port's trainer against the JAX package, fp32 on the CPU.

* ``threefry.randint`` and ``data/pipeline.lm_batch`` against
  ``jax.random.randint`` and ``repro.data.pipeline.lm_batch``: equal
  integers, over seeds, steps and spans that are not powers of two.
* ``optim/adamw.py``: ``lr_at`` for each schedule (rtol 1e-6: numpy's and
  XLA's float32 ``cos`` may differ by an ulp), ``apply_updates`` with and
  without master weights and clipping (``UPDATE_ATOL``).
* ``train/step.py``: 3 steps of ``make_train_step`` on the reduced
  kanformer from the same parameters, accumulation 1 and 2, compression
  None / bf16 / int8: losses within ``LOSS_RTOL``, parameters and first
  moments within ``STEP_ATOL`` and ``STEP_BULK`` (see there).
* ``lm_loss``'s gradients against ``jax.grad``, one case per registered
  architecture at T = 8: each leaf within ``GRAD_REL`` of its largest
  gradient.

Parameters are drawn with numpy from a seed in the shapes and scales of
``lm.param_shapes`` and go to both packages, so no JAX initialisation runs;
every JAX random call sits inside ``jax.threefry_partitionable(True)``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jdp
from repro.dist import compression as jcomp
from repro.models import lm as jlm
from repro.optim import adamw as jadam
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.convert import (flatten_with_paths, params_from_jax, train_state_from_jax,
                                 unflatten_paths)
from repro_torch.data import pipeline as tdp
from repro_torch.dist import compression as tcomp
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadam
from repro_torch.serve import threefry
from repro_torch.train import step as tstep

LOSS_RTOL = 1e-5
# Adam normalises each element's step, so an element whose gradient is near
# zero (eps 1e-8 is then a visible share of the divisor), or whose bf16 or
# int8 code flips at a rounding boundary, moves by a different fraction of
# lr.  On the reduced kanformer at lr 2e-3, after 3 steps from two seeds, the
# largest gap is 2.8e-2 lr (1 or 2 of 287,040 elements above 1e-2 lr) and
# 99.9 % of the elements are within 4.6e-4 lr.  A wrong batch, bias
# correction or schedule moves most elements by O(lr).
STEP_ATOL = 1e-1                    # every element, times lr
STEP_BULK = (0.999, 1e-3)           # this share of the elements within this, times lr
UPDATE_ATOL = 1e-6                  # apply_updates on O(1) values
GRAD_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops; one thread each keeps them
    from contending for the cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(fn, *args, **kw):
    with jax.threefry_partitionable(True):
        return fn(*args, **kw)


def numpy_params(tmodel, seed: int) -> dict:
    """A parameter tree of numpy float32 arrays: ``lm.param_shapes``'
    shapes, init kinds and scales (``1/sqrt(fan_in)`` per layer by
    default), drawn from ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    flat = {}
    for key, spec in flatten_with_paths(tlm.param_shapes(tmodel)).items():
        if spec.init in ("zeros", "ones"):
            flat[key] = np.full(spec.shape, spec.init == "ones", np.float32)
            continue
        per_layer = spec.shape[1:] if key.startswith("['unit']") else spec.shape
        scale = spec.scale or 1.0 / math.sqrt(max(1, math.prod(per_layer[:-1])))
        flat[key] = (rs.normal(size=spec.shape) * scale).astype(np.float32)
    return unflatten_paths(flat)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_same_tree(a_tree, b_tree):
    a, b = flatten_with_paths(a_tree), flatten_with_paths(b_tree)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _max_err(a_tree, b_tree) -> float:
    a, b = flatten_with_paths(a_tree), flatten_with_paths(b_tree)
    assert set(a) == set(b)
    return max(float(np.abs(np.asarray(a[k], np.float32) - b[k].float().numpy()).max())
               for k in a)


# ---------------------------------------------------------------------------
# the token stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 7])
@pytest.mark.parametrize("lo,hi", [(0, 7), (0, 512), (0, 32000), (0, 257216), (-5, 1000003),
                                   (3, 3), (-(2 ** 31), 2 ** 31 - 1)])
def test_randint_equals_jax(seed, lo, hi):
    want = np.asarray(_ref(lambda: jax.random.randint(
        jax.random.fold_in(jax.random.PRNGKey(seed), 11), (6, 37), lo, hi)))
    got = threefry.randint(threefry.fold_in(threefry.prng_key(seed), 11), (6, 37), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_refuses_bounds_outside_int32():
    with pytest.raises(ValueError, match="int32 bounds"):
        threefry.randint(threefry.prng_key(0), (2,), 0, 2 ** 31)


@pytest.mark.parametrize("seed,step,vocab,T,B", [(0, 0, 512, 64, 8),
                                                 (7, 2 ** 20 + 3, 257216, 33, 3)])
def test_lm_batch_equals_reference(seed, step, vocab, T, B):
    want = _ref(jdp.lm_batch, jdp.LMDataConfig(vocab, T, B, seed), step)
    got = tdp.lm_batch(tdp.LMDataConfig(vocab, T, B, seed), step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert (got["labels"][:, -1] == -100).all()


# ---------------------------------------------------------------------------
# AdamW and the wire formats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_equals_reference(schedule):
    cfg = dict(lr=2e-3, warmup_steps=7, total_steps=60, schedule=schedule)
    steps = list(range(0, 70, 3)) + [6, 7, 8, 59, 60, 61]
    want = [float(jadam.lr_at(jadam.AdamWConfig(**cfg), jnp.asarray(s, jnp.int32)))
            for s in steps]
    got = [tadam.lr_at(tadam.AdamWConfig(**cfg), s) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _small_tree(rs):
    return {"a": rs.normal(size=(3, 5)).astype(np.float32),
            "b": [rs.normal(size=(7,)).astype(np.float32),
                  rs.normal(size=(2, 2, 2)).astype(np.float32)]}


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("clip", [0.1, 100.0])
def test_apply_updates_equals_reference(master, clip):
    """Three updates of a small tree (bf16 parameters with an fp32 master
    copy when ``master``), from the reference's state carried across by
    ``train_state_from_jax`` (equal to the port's ``init_state`` leaf for
    leaf): parameters, both moments and the master within
    ``UPDATE_ATOL`` (bf16 parameters within one bf16 ulp), the same step,
    grad_norm and lr; ``clip`` = 0.1 clips every step, 100 none."""
    rs = np.random.RandomState(3)
    p_np = _small_tree(rs)
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=10, grad_clip=clip, master_weights=master)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16 if master else jnp.float32), p_np)
    js = jadam.init_state(jp, master_weights=master)
    tdt = torch.bfloat16 if master else torch.float32
    tp, ts = train_state_from_jax(jax.device_get(jp), jax.device_get(js), device="cpu")
    fresh = tadam.init_state(tp, master_weights=master)
    _assert_same_tree(fresh, ts)
    for i in range(3):
        g = _small_tree(rs)
        jp, js, jm = jadam.apply_updates(jp, _jax(g), js, jadam.AdamWConfig(**cfg))
        tp, ts, tm = tadam.apply_updates(tp, params_from_jax(g, device="cpu"), ts,
                                         tadam.AdamWConfig(**cfg))
        assert (float(jm["grad_norm"]) > clip) == (clip < 1)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == i + 1 and ts["step"].dtype == torch.int32
        for name in ("m", "v") + (("master",) if master else ()):
            assert _max_err(jax.device_get(js[name]), ts[name]) <= UPDATE_ATOL
        jf, tf = flatten_with_paths(jax.device_get(jp)), flatten_with_paths(tp)
        for k in jf:
            assert tf[k].dtype == tdt
            want = np.asarray(jf[k], np.float32)
            tol = 2.0 ** -8 * np.abs(want) + UPDATE_ATOL if master else UPDATE_ATOL
            assert (np.abs(tf[k].float().numpy() - want) <= tol).all(), k


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_compression_round_trips_equal_reference(kind):
    g = _small_tree(np.random.RandomState(9))
    g["a"][1, 2] = 0.0
    want = jax.device_get(jcomp.compress_tree(_jax(g), kind))
    got = tcomp.compress_tree(params_from_jax(g, device="cpu"), kind)
    assert _max_err(want, got) <= 1e-7
    with pytest.raises(ValueError, match="unknown compression kind"):
        tcomp.compress_leaf(torch.zeros(2), "fp8")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kanformer():
    jm = jconfigs.get_reduced("kanformer-100m").model
    tm = tconfigs.get_reduced("kanformer-100m").model
    return jm, tm, numpy_params(tm, seed=0)


@pytest.mark.parametrize("accum,compression", [(1, None), (2, "bf16"), (1, "int8")])
def test_train_steps_equal_reference(kanformer, accum, compression):
    """3 steps of ``make_train_step`` from the same parameters on
    ``lm_batch``'s stream (batch 4, T 16): loss and grad_norm within
    ``LOSS_RTOL``, lr within an ulp, parameters and first moments within
    ``STEP_ATOL`` x lr, most of them within ``STEP_BULK``."""
    jm, tm, p_np = kanformer
    cfg = dict(lr=2e-3, total_steps=10, warmup_steps=2)
    jstep_fn = jax.jit(jstep.make_train_step(
        jm, jadam.AdamWConfig(**cfg), compute_dtype=jnp.float32, accum_steps=accum,
        grad_compression=compression))
    tstep_fn = tstep.make_train_step(tm, tadam.AdamWConfig(**cfg), compute_dtype=torch.float32,
                                     accum_steps=accum, grad_compression=compression)
    jp = _jax(p_np)
    js = jadam.init_state(jp)
    tp, ts = train_state_from_jax(p_np, jax.device_get(js), device="cpu")
    for i in range(3):
        jp, js, jmet = jstep_fn(jp, js, _ref(jdp.lm_batch, jdp.LMDataConfig(jm.vocab, 16, 4), i))
        tp, ts, tmet = tstep_fn(tp, ts, tdp.lm_batch(tdp.LMDataConfig(tm.vocab, 16, 4), i))
        assert set(tmet) == set(jmet)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(tmet["lr"], float(jmet["lr"]), rtol=1e-6)
    for want, got in ((jp, tp), (js["m"], ts["m"])):
        a, b = flatten_with_paths(jax.device_get(want)), flatten_with_paths(got)
        gap = np.concatenate([np.abs(np.asarray(a[k]) - b[k].numpy()).ravel() for k in a])
        gap /= cfg["lr"]
        assert gap.max() <= STEP_ATOL
        assert (gap <= STEP_BULK[1]).mean() >= STEP_BULK[0]
    assert int(ts["step"]) == 3


def test_accumulated_step_averages_the_microbatches(kanformer):
    """``accum_steps = 2`` on a batch takes the mean of its two halves'
    gradients and losses, in order."""
    _, tm, p_np = kanformer
    batch = tdp.lm_batch(tdp.LMDataConfig(tm.vocab, 16, 4), 5)
    tp = params_from_jax(p_np, device="cpu")
    halves = [tstep.loss_and_grads(tp, tm, {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()})
              for i in range(2)]
    mean = {k: (a + b) / 2 for (k, a), b in zip(flatten_with_paths(halves[0][2]).items(),
                                                flatten_with_paths(halves[1][2]).values())}
    step = tstep.make_train_step(tm, tadam.AdamWConfig(), accum_steps=2)
    _, _, met = step(tp, tadam.init_state(tp), batch)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(tadam.global_norm(unflatten_paths(mean))), rtol=1e-6)
    np.testing.assert_allclose(float(met["loss"]),
                               (float(halves[0][0]) + float(halves[1][0])) / 2, rtol=1e-6)


# ---------------------------------------------------------------------------
# lm_loss gradients, every registered architecture
# ---------------------------------------------------------------------------


def _loss_batch(model, seed: int, B: int = 2, T: int = 8) -> dict:
    rs = np.random.RandomState(seed)
    batch = {}
    if model.input_kind == "embeddings":
        batch["embeddings"] = rs.normal(size=(B, T, model.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rs.randint(0, model.vocab, (B, T)).astype(np.int32)
    if model.input_kind == "mixed":
        batch["prefix_embeddings"] = rs.normal(size=(B, model.n_prefix,
                                                     model.d_model)).astype(np.float32)
    labels = rs.randint(0, model.vocab, (B, T)).astype(np.int32)
    labels[:, -1] = -100
    labels[0, 1] = -100
    batch["labels"] = labels
    return batch


@pytest.fixture(scope="module", params=tconfigs.list_configs())
def reference_grads(request):
    """The reference's loss, metrics and ``jax.grad`` of one architecture's
    reduced config, computed once."""
    arch = request.param
    jm = jconfigs.get_reduced(arch).model
    tm = tconfigs.get_reduced(arch).model
    p_np = numpy_params(tm, seed=1)
    batch = _loss_batch(tm, seed=2)
    fn = jax.jit(jax.value_and_grad(
        functools.partial(jlm.lm_loss, cfg=jm, compute_dtype=jnp.float32), has_aux=True))
    (loss, metrics), grads = fn(_jax(p_np), batch=_jax(batch))
    return arch, tm, p_np, batch, float(loss), jax.device_get(metrics), jax.device_get(grads)


def test_lm_loss_gradients_equal_jax_grad(reference_grads):
    arch, tm, p_np, batch, loss, metrics, grads = reference_grads
    tl, tmet, tg = tstep.loss_and_grads(params_from_jax(p_np, device="cpu"), tm,
                                        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), loss, rtol=LOSS_RTOL)
    assert set(tmet) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(tmet[k]), float(v), rtol=LOSS_RTOL, atol=1e-7)
    assert float(tmet["ntokens"]) == (batch["labels"] >= 0).sum() == 2 * 8 - 3
    want, got = flatten_with_paths(grads), flatten_with_paths(tg)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= GRAD_REL * scale + 1e-9, (arch, k, err, scale)
    assert any(float(np.abs(np.asarray(w)).max()) > 0 for w in want.values())
