"""The port's dense models against the JAX package, fp32 on the CPU.

qwen1.5-0.5b ``reduced()`` (attn_mlp blocks: SwiGLU MLP, QKV bias) is
built once in JAX (``lm.init_params``), carried across with
``params_from_jax``, and both sides run the same tokens.  What must hold:

* ``config()`` and ``reduced()`` of qwen1.5-0.5b, qwen2.5-3b, qwen1.5-32b and
  gemma3-12b equal the reference's field by field, and the parameter trees
  the reference's shapes;
* prefill logits and KV caches, decode steps (scalar and per-row ``pos``),
  ``forward`` and ``verify_window`` within the stated tolerances;
* greedy streams of ``serve_requests`` and of ``serve_continuous`` (dense,
  paged shadow, paged step, ``spec_k = 2``) EQUAL to the JAX engine's, and
  so are the counters of ``last_serve_stats``;
* ``--arch qwen1.5-0.5b --device cpu`` runs through the CLI.

Tolerances: logits atol 1e-4 (fp32 sums over d = 64 and d_ff = 128 taken
in another order by XLA and by torch; 1.2e-5 seen), K/V caches atol 1e-5.
JAX calls are jitted (eager JAX compiles every op).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_jax_subprocess
from repro import configs as jconfigs
from repro.checkpoint.store import _flatten_with_paths
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.convert import flatten_with_paths, params_from_jax
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "qwen1.5-0.5b"
DENSE_ARCHS = ("qwen1.5-0.5b", "qwen2.5-3b", "qwen1.5-32b", "gemma3-12b")
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5
MAX_SEQ = 32
BLOCK = 4
SLOTS, CHUNK = 3, 3
# the reference's keys that describe its wall clock, JAX tracing or meshes
NOT_COMPARED = {"wall_s", "request_latency_s", "compiles", "mesh_shape", "paged"}
MODES = {
    "dense": {},
    "paged_shadow": {"paged": True},
    "paged_step": {"paged": True, "paged_read": "step"},
    "spec_k2": {"spec_k": 2},
}


@pytest.fixture(scope="module")
def setup():
    jmodel = jconfigs.get_reduced(ARCH).model
    tmodel = tconfigs.get_reduced(ARCH).model
    jparams = jlm.init_params(jax.random.PRNGKey(0), jmodel)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    base = dict(max_seq=MAX_SEQ, max_new_tokens=8, block_size=BLOCK, spec_k=2)
    rs = np.random.RandomState(0)
    common = rs.randint(1, jmodel.vocab, 2 * BLOCK).astype(np.int32)
    reqs = []
    for i in range(8):
        r = rs.randint(1, jmodel.vocab, int(rs.randint(3, 14))).astype(np.int32)
        reqs.append(np.concatenate([common, r]) if i % 2 else r)
    budgets = [int(b) for b in rs.randint(1, 9, len(reqs))]
    return {"jmodel": jmodel, "tmodel": tmodel, "jparams": jparams, "tparams": tparams,
            "jeng": JEngine(jparams, jmodel, JServeConfig(**base)),
            "teng": Engine(tparams, tmodel, ServeConfig(**base), device="cpu"),
            "reqs": reqs, "budgets": budgets}


def _tok(seed, B, T, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, T)).astype(np.int32)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_configs_equal_reference_field_by_field(arch, which):
    want = getattr(jconfigs, f"get_{which}")(arch)
    got = getattr(tconfigs, f"get_{which}")(arch)
    for f in ("family", "sub_quadratic", "source", "notes"):
        assert getattr(got, f) == getattr(want, f), f
    gm, wm = got.model, want.model
    for name, v in _fields(gm).items():
        if name in ("unit", "prologue", "epilogue", "shared"):
            assert len(v) == len(getattr(wm, name))
            for gb, wb in zip(v, getattr(wm, name)):
                for bn, bv in _fields(gb).items():
                    if bn == "attn":
                        assert _fields(bv) == {k: getattr(wb.attn, k) for k in _fields(bv)}
                    else:
                        assert bv == getattr(wb, bn), (name, bn)
        else:
            assert v == getattr(wm, name), name
    assert gm.n_layers == wm.n_layers


@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_param_tree_matches_abstract_params(arch, which):
    jmodel = getattr(jconfigs, f"get_{which}")(arch).model
    tmodel = getattr(tconfigs, f"get_{which}")(arch).model
    want = {k: tuple(v.shape) for k, v in
            _flatten_with_paths(jlm.abstract_params(jmodel))[0].items()}
    got = {k: spec.shape for k, spec in flatten_with_paths(tlm.param_shapes(tmodel)).items()}
    assert got == want


def test_init_params_scales_of_the_mlp():
    """The MLP's normal leaves carry the reference's 1/sqrt(fan_in) scale;
    the QKV biases start at zero."""
    tmodel = tconfigs.get_reduced(ARCH).model
    p = tlm.init_params(tmodel, seed=0, device="cpu")
    d, ff = tmodel.d_model, tmodel.unit[0].d_ff
    mlp = p["unit"][0]["mlp"]
    for name, fan_in in (("wi", d), ("wg", d), ("wo", ff)):
        assert abs(mlp[name].std().item() - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
    assert not p["unit"][0]["attn"]["bq"].any()


def test_prefill_logits_and_caches_match_reference(setup):
    s = setup
    toks = _tok(1, 3, 11, s["jmodel"].vocab)
    jlog, jc = jlm.prefill(s["jparams"], s["jmodel"], {"tokens": jnp.asarray(toks)},
                           MAX_SEQ, jnp.float32)
    tlog, tc = tlm.prefill(s["tparams"], s["tmodel"], torch.tensor(toks), MAX_SEQ, torch.float32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    for n in ("k", "v"):
        assert tc["unit"][0][n].shape == jc["unit"][0][n].shape
        np.testing.assert_allclose(tc["unit"][0][n].numpy(), np.asarray(jc["unit"][0][n]),
                                   atol=KV_ATOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_steps_match_reference(setup, ragged):
    """5 decode steps after prefill: scalar pos (every row at T) or per-row
    pos (right-padded rows starting at their own lengths)."""
    s = setup
    B, T = 3, 9
    toks = _tok(2, B, T, s["jmodel"].vocab)
    _, jc = jlm.prefill(s["jparams"], s["jmodel"], {"tokens": jnp.asarray(toks)},
                        MAX_SEQ, jnp.float32)
    _, tc = tlm.prefill(s["tparams"], s["tmodel"], torch.tensor(toks), MAX_SEQ, torch.float32)
    step = jax.jit(functools.partial(jlm.decode_step, cfg=s["jmodel"],
                                     compute_dtype=jnp.float32))
    lens = np.array([9, 4, 6])
    step_toks = _tok(3, 5, B, s["jmodel"].vocab)
    for k in range(5):
        p = lens + k if ragged else np.int32(T + k)
        tok = step_toks[k][:, None]
        jlog, jc = step(s["jparams"], tokens=jnp.asarray(tok), caches=jc,
                        pos=jnp.asarray(p, jnp.int32))
        tlog, tc = tlm.decode_step(s["tparams"], s["tmodel"], torch.tensor(tok), tc,
                                   torch.tensor(p), torch.float32)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc["unit"][0][n].numpy(), np.asarray(jc["unit"][0][n]),
                                   atol=KV_ATOL)


def test_forward_matches_reference_and_teacher_forced_decode(setup):
    """``lm.forward`` equals the reference's, its aux too; and (the reference's
    ``test_decode_matches_prefill_qwen``) decode steps fed every token from
    position 0 reproduce it, atol 2e-4 as there."""
    s = setup
    toks = _tok(4, 2, 10, s["jmodel"].vocab)
    jlog, jaux = jlm.forward(s["jparams"], s["jmodel"], {"tokens": jnp.asarray(toks)},
                             jnp.float32)
    tlog, taux = tlm.forward(s["tparams"], s["tmodel"], torch.tensor(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    assert set(taux) == set(jaux)                    # the MoE losses, zero without MoE
    for k, v in jaux.items():
        assert float(taux[k]) == float(v) == 0.0
    caches = tlm.init_caches(s["tmodel"], 2, 10, torch.float32, "cpu")
    dec = []
    for t in range(10):
        lg, caches = tlm.decode_step(s["tparams"], s["tmodel"], torch.tensor(toks[:, t:t + 1]),
                                     caches, torch.full((2,), t), torch.float32)
        dec.append(lg)
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), tlog.numpy(), atol=2e-4)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_window_matches_reference(setup, paged):
    """A 3-token verify window per row after a prefill, dense cache or pool
    (identity tables): logits and the written caches."""
    s = setup
    B, T, W = 2, 7, 3
    toks = _tok(5, B, T, s["jmodel"].vocab)
    win = _tok(6, B, W, s["jmodel"].vocab)
    pos = np.array([7, 5], np.int32)
    _, jc = jlm.prefill(s["jparams"], s["jmodel"], {"tokens": jnp.asarray(toks)},
                        MAX_SEQ, jnp.float32)
    _, tc = tlm.prefill(s["tparams"], s["tmodel"], torch.tensor(toks), MAX_SEQ, torch.float32)
    table = None
    if paged:
        nl = MAX_SEQ // BLOCK
        ids = np.arange(1, B * nl + 1, dtype=np.int32).reshape(B, nl)
        table = torch.tensor(ids)
        pools = tlm.init_paged_caches(s["tmodel"], B * nl + 1, BLOCK, torch.float32, "cpu")
        for pool, dense in zip(pools["unit"], tc["unit"]):
            for n in pool:
                pool[n][:, 1:] = dense[n].reshape(pool[n][:, 1:].shape)
        tc = pools
    jlog, jc = jlm.verify_window(s["jparams"], s["jmodel"], jnp.asarray(win), jc,
                                 jnp.asarray(pos), jnp.float32)
    tlog, tc = tlm.verify_window(s["tparams"], s["tmodel"], torch.tensor(win), tc,
                                 torch.tensor(pos, dtype=torch.int64), torch.float32, table)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    for n in ("k", "v"):
        got = tc["unit"][0][n]
        if paged:
            got = got[:, 1:].reshape(jc["unit"][0][n].shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(jc["unit"][0][n]), atol=KV_ATOL)


@pytest.mark.parametrize("quant", [False, True])
def test_drafter_from_target_on_mlp_trees_equals_reference(setup, quant):
    """``DraftModel.from_target`` on an attn_mlp tree (QKV biases, MLP
    weights, norms): the same leaves as the reference's drafter, the
    int8 fake-quantised ones (every leaf of two or more axes, biases and
    stacked norms included) equal to the reference's bit for bit."""
    from repro.serve import speculative as jsp
    from repro_torch.serve import speculative as tsp

    s = setup
    jp = jax.tree.map(lambda a: a, s["jparams"])
    rs = np.random.RandomState(9)
    for n in ("bq", "bk", "bv"):                     # biases start at zero: give them values
        jp["unit"][0]["attn"][n] = jnp.asarray(rs.randn(*jp["unit"][0]["attn"][n].shape),
                                               jnp.float32)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    want = jsp.DraftModel.from_target(jp, s["jmodel"], 1, quant=quant)
    got = tsp.DraftModel.from_target(tp, s["tmodel"], 1, quant=quant)
    assert got.cfg.n_repeats == want.cfg.n_repeats == 1 and got.cfg.name == want.cfg.name
    wflat = _flatten_with_paths(jax.device_get(want.params))[0]
    gflat = flatten_with_paths(got.params)
    assert list(gflat) == list(wflat)
    for k, w in wflat.items():
        np.testing.assert_array_equal(gflat[k].numpy(), np.asarray(w), err_msg=k)
    bq = gflat["['unit']/[0]/['attn']/['bq']"]
    assert bq.shape[0] == 1
    assert torch.equal(bq, tp["unit"][0]["attn"]["bq"][:1]) != quant   # quantised: changed


def test_serve_requests_equals_reference(setup):
    s = setup
    for eng in (s["jeng"], s["teng"]):
        eng.cfg = dataclasses.replace(eng.cfg, paged=False, spec_k=0)
    want = s["jeng"].serve_requests(s["reqs"], batch_size=3, seed=0)
    got = s["teng"].serve_requests(s["reqs"], batch_size=3, seed=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_continuous_equals_reference(setup, mode):
    s = setup
    cfg = {"paged": False, "paged_read": "shadow", "spec_k": 0, **MODES[mode]}
    res = []
    for eng in (s["jeng"], s["teng"]):
        eng.cfg = dataclasses.replace(eng.cfg, **cfg)
        outs = eng.serve_continuous(s["reqs"], slots=SLOTS, chunk_steps=CHUNK,
                                    max_new=s["budgets"])
        res.append((outs, eng.last_serve_stats))
    (want, wstats), (got, gstats) = res
    for g, w, m in zip(got, want, s["budgets"]):
        assert g.dtype == np.int32 and g.shape == (m,)
        np.testing.assert_array_equal(g, w)
    counters = {k: v for k, v in wstats.items() if k not in NOT_COMPARED}
    assert {k: gstats[k] for k in counters} == counters
    assert ("paged" in gstats) == ("paged" in wstats)
    if cfg["paged"]:
        assert gstats["paged"] == wstats["paged"]
        assert gstats["paged"]["prefill_tokens_saved"] > 0


def test_cli_qwen_runs_on_cpu():
    r = run_jax_subprocess(argv=[
        "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
        "--engine", "continuous", "--paged", "--requests", "4", "--batch", "2",
        "--prompt-len", "8", "--max-new", "4", "--block-size", "4"], timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[serve:continuous] 4 requests, 16 tokens" in r.stdout
    assert "served=4/4" in r.stdout

