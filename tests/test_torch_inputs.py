"""Non-token inputs: paligemma-3b (``input_kind="mixed"``: ``n_prefix``
patch embeddings before the text) and musicgen-large (``"embeddings"``:
frame embeddings) against the JAX package, fp32 on the CPU.

* ``config()`` and ``reduced()`` equal the reference's field by field, and
  the parameter trees ``abstract_params``' shapes;
* ``forward``, ``prefill`` (logits and K/V caches) and ``decode_step`` of
  the reduced configs equal the reference's on the same inputs; musicgen
  decodes ``(B, 1, d)`` rows and ``(B, d)`` rows alike, as the reference
  does, and teacher-forced decode reproduces ``forward``;
* ``lm_loss`` and its metrics, paligemma's prefix masked (``ntokens`` counts
  the text labels alone);
* the serving CLI (rc=2) and ``Engine`` refuse both models, and the
  trainer trains both (``launch.train --reduced --device cpu``) on the
  reference launcher's ``RandomState(step)`` embeddings.

Tolerances: logits atol 1e-4 and K/V atol 1e-5, as ``test_torch_dense.py``
(fp32 sums over d = 64 and d_ff = 128 in another order); losses rtol 1e-5.
Parameters come from numpy (``test_torch_train.numpy_params``); JAX calls
are jitted.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.store import _flatten_with_paths
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.convert import flatten_with_paths, params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import Engine, ServeConfig
from test_torch_train import numpy_params

ARCHS = ("paligemma-3b", "musicgen-large")
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5
LOSS_RTOL = 1e-5
MAX_SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops; one thread each keeps them
    from contending for the cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference_field_by_field(arch, which):
    want = getattr(jconfigs, f"get_{which}")(arch)
    got = getattr(tconfigs, f"get_{which}")(arch)
    for f in ("family", "sub_quadratic", "source", "notes"):
        assert getattr(got, f) == getattr(want, f), f
    gm, wm = got.model, want.model
    for name, v in _fields(gm).items():
        if name == "unit":
            assert len(v) == len(wm.unit) == 1
            for bn, bv in _fields(v[0]).items():
                if bn == "attn":
                    assert _fields(bv) == {k: getattr(wm.unit[0].attn, k) for k in _fields(bv)}
                else:
                    assert bv == getattr(wm.unit[0], bn), bn
        else:
            assert v == getattr(wm, name), name
    assert gm.input_kind == ("mixed" if arch == "paligemma-3b" else "embeddings")


@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_abstract_params(arch, which):
    jmodel = getattr(jconfigs, f"get_{which}")(arch).model
    tmodel = getattr(tconfigs, f"get_{which}")(arch).model
    want = {k: tuple(v.shape) for k, v in
            _flatten_with_paths(jlm.abstract_params(jmodel))[0].items()}
    assert {k: s.shape for k, s in flatten_with_paths(tlm.param_shapes(tmodel)).items()} == want


def _inputs(model, seed: int, B: int, T: int) -> dict:
    """``T`` text tokens (after a paligemma's prefix) or ``T`` frames."""
    rs = np.random.RandomState(seed)
    if model.input_kind == "embeddings":
        return {"embeddings": rs.normal(size=(B, T, model.d_model)).astype(np.float32)}
    return {"prefix_embeddings": rs.normal(size=(B, model.n_prefix,
                                                 model.d_model)).astype(np.float32),
            "tokens": rs.randint(0, model.vocab, (B, T)).astype(np.int32)}


def _torch(d: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jm = jconfigs.get_reduced(request.param).model
    tm = tconfigs.get_reduced(request.param).model
    p = numpy_params(tm, seed=4)
    return jm, tm, jax.tree.map(jnp.asarray, p), params_from_jax(p, device="cpu")


def test_forward_and_prefill_equal_reference(model):
    jm, tm, jp, tp = model
    x = _inputs(tm, 1, 2, 9)
    jlog, jaux = jax.jit(functools.partial(jlm.forward, cfg=jm, compute_dtype=jnp.float32))(
        jp, inputs=x)
    tlog, taux = tlm.forward(tp, tm, _torch(x))
    T = 9 + tm.n_prefix
    assert tlog.shape == (2, T, tm.vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    assert {k: float(v) for k, v in taux.items()} == {k: float(v) for k, v in jaux.items()}
    jplog, jc = jax.jit(functools.partial(jlm.prefill, cfg=jm, max_seq=MAX_SEQ,
                                          compute_dtype=jnp.float32))(jp, inputs=x)
    tplog, tc = tlm.prefill(tp, tm, _torch(x), MAX_SEQ)
    np.testing.assert_allclose(tplog.numpy(), np.asarray(jplog), atol=LOGIT_ATOL)
    for n in ("k", "v"):
        assert tc["unit"][0][n].shape == jc["unit"][0][n].shape
        np.testing.assert_allclose(tc["unit"][0][n].numpy(), np.asarray(jc["unit"][0][n]),
                                   atol=KV_ATOL)


def test_decode_steps_equal_reference_and_forward(model):
    """5 decode steps after a prefill of 7 positions (paligemma: 7 text
    tokens after the prefix; musicgen: 7 frames) against the reference's,
    then the same logits teacher-forced against the port's ``forward`` over
    the whole sequence.  musicgen's ``(B, d)`` rows give the ``(B, 1, d)``
    rows' logits exactly."""
    jm, tm, jp, tp = model
    B, T, n = 2, 7, 5
    full = _inputs(tm, 2, B, T + n)
    first = {k: v[:, :T] if k != "prefix_embeddings" else v for k, v in full.items()}
    _, jc = jlm.prefill(jp, jm, first, MAX_SEQ, jnp.float32)
    _, tc = tlm.prefill(tp, tm, _torch(first), MAX_SEQ)
    step = jax.jit(functools.partial(jlm.decode_step, cfg=jm, compute_dtype=jnp.float32))
    key = "embeddings" if tm.input_kind == "embeddings" else "tokens"
    start = T + tm.n_prefix
    got = []
    for j in range(n):
        row = full[key][:, T + j:T + j + 1]
        jlog, jc = step(jp, tokens=jnp.asarray(row), caches=jc, pos=jnp.int32(start + j))
        tlog, tc = tlm.decode_step(tp, tm, torch.from_numpy(row), tc, torch.tensor(start + j))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
        if key == "embeddings":              # the same step on (B, d) rows
            jflat, _ = step(jp, tokens=jnp.asarray(row[:, 0]), caches=jc,
                            pos=jnp.int32(start + j))
            flat = tlm.decode_step(tp, tm, torch.from_numpy(row[:, 0]),
                                   {p: [{k: v.clone() for k, v in c.items()} for c in cs]
                                    for p, cs in tc.items()}, torch.tensor(start + j))[0]
            assert torch.equal(flat, tlog)
            np.testing.assert_allclose(flat.numpy(), np.asarray(jflat), atol=LOGIT_ATOL)
        got.append(tlog)
    whole, _ = tlm.forward(tp, tm, _torch(full))
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), whole[:, start:start + n].numpy(),
                               atol=LOGIT_ATOL)


def test_lm_loss_equals_reference(model):
    jm, tm, jp, tp = model
    B, T = 2, 8
    batch = _inputs(tm, 3, B, T)
    labels = np.random.RandomState(5).randint(0, tm.vocab, (B, T)).astype(np.int32)
    labels[:, -1] = -100
    batch["labels"] = labels
    total, jmet = jax.jit(functools.partial(jlm.lm_loss, cfg=jm, compute_dtype=jnp.float32))(
        jp, batch=batch)
    ttotal, tmet = tlm.lm_loss(tp, tm, _torch(batch))
    np.testing.assert_allclose(float(ttotal), float(total), rtol=LOSS_RTOL)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=LOSS_RTOL)
    assert float(tmet["ntokens"]) == B * (T - 1)      # the prefix carries no label


def test_inputs_of_the_wrong_kind_are_refused(model):
    _, tm, _, tp = model
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(KeyError, match=f"input_kind '{tm.input_kind}' takes"):
        tlm.forward(tp, tm, toks)                     # a bare tensor means {"tokens"}
    assert not tlm.model_supports_speculative(tm)


def test_token_models_take_a_bare_tensor_or_a_dict():
    tm = tconfigs.get_reduced("qwen1.5-0.5b").model
    tp = tlm.init_params(tm, seed=0, device="cpu")
    toks = torch.randint(0, tm.vocab, (2, 5))
    a, _ = tlm.forward(tp, tm, toks)
    b, _ = tlm.forward(tp, tm, {"tokens": toks})
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="input_kind 'audio' is not one of"):
        tlm.check_supported(dataclasses.replace(tm, input_kind="audio"))


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_refuses_non_token_models(arch, capsys):
    """The reference's engine prefills ``{"tokens": ...}`` and its CLI dies
    on these models with a ``KeyError``; the port's says why, rc=2."""
    assert tserve.main(["--arch", arch, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "serves token prompts only" in err and "KeyError" in err
    tm = tconfigs.get_reduced(arch).model
    with pytest.raises(NotImplementedError, match="serves token prompts only"):
        Engine(tlm.init_params(tm, seed=0, device="cpu"), tm, ServeConfig(), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_trains_non_token_models(arch):
    out = ttrain.run(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "4",
                      "--batch", "2", "--seq", "8", "--log-every", "2"])
    assert out["steps"] == 4 and len(out["losses"]) == 4
    assert np.isfinite(out["losses"]).all()
    tm = tconfigs.get_reduced(arch).model
    batch = ttrain.make_batch(tm, ttrain.dp.LMDataConfig(tm.vocab, 8, 2), 3, "cpu")
    key = "embeddings" if arch == "musicgen-large" else "prefix_embeddings"
    want = np.random.RandomState(3).normal(
        size=(2, 8 if key == "embeddings" else tm.n_prefix, tm.d_model)).astype(np.float32)
    np.testing.assert_array_equal(batch[key].numpy(), want)
    assert int(out["opt_state"]["step"]) == 4
