"""The port's MLA attention and deepseek-v2-lite against the JAX package,
fp32 on the CPU.

deepseek-v2-lite ``reduced()`` (MLA with a 16-dim latent and an 8-dim rope
key; one dense attn_mlp prologue block, then 2 attn_moe blocks of 8 routed
experts top-2 and one shared expert) is built once in JAX
(``lm.init_params``), carried across with ``params_from_jax``, and both
sides run the same tokens.  What must hold:

* MLA ``attn_forward``'s output and cache (the unnormalised latent beside
  the rotated rope key), and ``mla_decode_step`` with a scalar and a
  per-row ``pos``: outputs within atol 1e-5, caches within 1e-6; a per-row
  write at ``max_seq`` is dropped (that row's cache is unchanged);
* ``forward`` (logits and aux), ``prefill`` (logits and the prologue's and
  the unit's latent caches) and decode steps within atol 1e-4;
* greedy streams of ``serve_requests`` and of ``serve_continuous`` (dense)
  EQUAL to the JAX engine's, and so are the counters of
  ``last_serve_stats``;
* paging and speculative decoding refused as the reference refuses them,
  through the model functions, the engine and the CLI.

JAX calls are jitted (eager JAX compiles every op).
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
from repro.launch import serve as jserve
from repro.models import attention as JA
from repro.models import lm as jlm
from repro.serve import speculative as jsp
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.convert import flatten_with_paths, params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm
from repro_torch.serve import speculative as tsp
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "deepseek-v2-lite"
Y_ATOL = 1e-5
CKV_ATOL = 1e-6
LOGIT_ATOL = 1e-4
AUX_RTOL = 1e-6
MAX_SEQ = 24
SLOTS, CHUNK = 3, 3
NOT_COMPARED = {"wall_s", "request_latency_s", "compiles", "mesh_shape", "paged"}


@pytest.fixture(scope="module")
def setup():
    jmodel = jconfigs.get_reduced(ARCH).model
    tmodel = tconfigs.get_reduced(ARCH).model
    jparams = jlm.init_params(jax.random.PRNGKey(0), jmodel)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    base = dict(max_seq=MAX_SEQ, max_new_tokens=5)
    rs = np.random.RandomState(0)
    reqs = [rs.randint(1, jmodel.vocab, int(rs.randint(3, 9))).astype(np.int32)
            for _ in range(5)]
    budgets = [int(b) for b in rs.randint(1, 6, len(reqs))]
    return {"jmodel": jmodel, "tmodel": tmodel, "jparams": jparams, "tparams": tparams,
            "jeng": JEngine(jparams, jmodel, JServeConfig(**base)),
            "teng": Engine(tparams, tmodel, ServeConfig(**base), device="cpu"),
            "reqs": reqs, "budgets": budgets}


def _jprefill(s, toks):
    return jax.jit(functools.partial(jlm.prefill, cfg=s["jmodel"], max_seq=MAX_SEQ,
                                     compute_dtype=jnp.float32))(
        s["jparams"], inputs={"tokens": jnp.asarray(toks)})


def _tok(seed, B, T, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, T)).astype(np.int32)


def _attn(s):
    """The first unit layer's MLA parameters and configs, both sides."""
    jp = jax.tree.map(lambda a: a[0], s["jparams"]["unit"][0]["attn"])
    tp = {k: v[0] for k, v in s["tparams"]["unit"][0]["attn"].items()}
    return jp, tp, s["jmodel"].unit[0].attn, s["tmodel"].unit[0].attn


def test_mla_attn_forward_and_cache_match_reference(setup):
    jp, tp, jcfg, tcfg = _attn(setup)
    x = np.random.RandomState(1).randn(2, 9, jcfg.d_model).astype(np.float32)
    fwd = jax.jit(functools.partial(JA.attn_forward, cfg=jcfg, return_cache=True))
    jy, jc = fwd(jp, x=jnp.asarray(x))
    ty, tc = TA.attn_forward(tp, tcfg, torch.tensor(x), return_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL)
    assert list(tc) == list(jc) == ["ckv"]
    assert tc["ckv"].shape == (2, 9, tcfg.kv_lora_rank + tcfg.qk_rope_dim)
    np.testing.assert_allclose(tc["ckv"].numpy(), np.asarray(jc["ckv"]), atol=CKV_ATOL)


@pytest.mark.parametrize("ragged", [False, True])
def test_mla_decode_step_matches_reference(setup, ragged):
    """Three steps on a random latent cache: one shared position, or a
    position per row with one row at ``max_seq`` (its write dropped)."""
    jp, tp, jcfg, tcfg = _attn(setup)
    B, S = 3, 10
    rs = np.random.RandomState(2)
    ckv = rs.randn(B, S, tcfg.kv_lora_rank + tcfg.qk_rope_dim).astype(np.float32)
    step = jax.jit(functools.partial(JA.mla_decode_step, cfg=jcfg))
    jc, tc = jnp.asarray(ckv), torch.tensor(ckv)
    for k in range(3):
        x = rs.randn(B, 1, jcfg.d_model).astype(np.float32)
        pos = np.array([4 + k, S, 7 + k]) if ragged else np.array(5 + k)
        jy, jc = step(jp, x=jnp.asarray(x), cache_ckv=jc, pos=jnp.asarray(pos, jnp.int32))
        ty, tc = TA.mla_decode_step(tp, tcfg, torch.tensor(x), tc, torch.tensor(pos))
        live = [0, 2] if ragged else [0, 1, 2]
        np.testing.assert_allclose(ty.numpy()[live], np.asarray(jy)[live], atol=Y_ATOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=CKV_ATOL)
    if ragged:
        np.testing.assert_array_equal(tc[1].numpy(), ckv[1])


def test_forward_prefill_and_decode_match_reference(setup):
    """The whole model, prologue first: ``forward`` with its aux,
    ``prefill`` with every cache leaf, then 4 per-row decode steps."""
    s = setup
    B, T = 3, 8
    toks = _tok(3, B, T, s["jmodel"].vocab)
    jlog, jaux = jax.jit(functools.partial(jlm.forward, cfg=s["jmodel"],
                                           compute_dtype=jnp.float32))(
        s["jparams"], inputs={"tokens": jnp.asarray(toks)})
    tlog, taux = tlm.forward(s["tparams"], s["tmodel"], torch.tensor(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    rows = toks.size * s["jmodel"].unit[0].moe.top_k
    assert round(float(taux["moe_drop_frac"]) * rows) == round(float(jaux["moe_drop_frac"]) * rows)
    for name in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=AUX_RTOL)
    jlog, jc = _jprefill(s, toks)
    tlog, tc = tlm.prefill(s["tparams"], s["tmodel"], torch.tensor(toks), MAX_SEQ,
                           torch.float32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    wflat, gflat = _flatten_with_paths(jax.device_get(jc))[0], flatten_with_paths(tc)
    assert list(gflat) == list(wflat) == ["['prologue']/[0]/['ckv']", "['unit']/[0]/['ckv']"]
    for k, w in wflat.items():
        assert gflat[k].shape == w.shape
        np.testing.assert_allclose(gflat[k].numpy(), np.asarray(w), atol=CKV_ATOL)
    step = jax.jit(functools.partial(jlm.decode_step, cfg=s["jmodel"],
                                     compute_dtype=jnp.float32))
    lens = np.array([8, 5, 7], np.int32)
    for k in range(4):
        tok = _tok(10 + k, B, 1, s["jmodel"].vocab)
        jlog, jc = step(s["jparams"], tokens=jnp.asarray(tok), caches=jc,
                        pos=jnp.asarray(lens + k))
        tlog, tc = tlm.decode_step(s["tparams"], s["tmodel"], torch.tensor(tok), tc,
                                   torch.tensor(lens + k), torch.float32)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    for k, w in _flatten_with_paths(jax.device_get(jc))[0].items():
        np.testing.assert_allclose(flatten_with_paths(tc)[k].numpy(), np.asarray(w),
                                   atol=CKV_ATOL)


def test_latent_cache_is_smaller_than_the_gqa_cache_it_replaces():
    """The MLA cache holds ``r + rope`` floats per token and layer where a
    GQA cache of the same heads holds ``2·H·head_dim`` (the reference's
    7.1x cut at full width: 576 against 4096)."""
    for get in (tconfigs.get_config, tconfigs.get_reduced):
        m = get(ARCH).model
        gqa = dataclasses.replace(m, prologue=(), unit=tuple(
            dataclasses.replace(b, attn=dataclasses.replace(b.attn, kv_lora_rank=None))
            for b in m.unit), n_repeats=m.n_layers)
        a = m.unit[0].attn
        mla = tlm.init_caches(m, 2, 16, torch.float32, "meta")
        full = tlm.init_caches(gqa, 2, 16, torch.float32, "meta")
        n = [sum(t.numel() for t in flatten_with_paths(c).values()) for c in (mla, full)]
        assert n[1] * (a.kv_lora_rank + a.qk_rope_dim) == n[0] * 2 * a.n_heads * a.head_dim
    assert (512 + 64, 2 * 16 * 128) == (576, 4096)


def test_serve_requests_equals_reference(setup):
    s = setup
    want = s["jeng"].serve_requests(s["reqs"], batch_size=5, seed=0)
    got = s["teng"].serve_requests(s["reqs"], batch_size=5, seed=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_serve_continuous_dense_equals_reference(setup):
    s = setup
    res = []
    for eng in (s["jeng"], s["teng"]):
        outs = eng.serve_continuous(s["reqs"], slots=SLOTS, chunk_steps=CHUNK,
                                    max_new=s["budgets"])
        res.append((outs, eng.last_serve_stats))
    (want, wstats), (got, gstats) = res
    for g, w, m in zip(got, want, s["budgets"]):
        assert g.shape == (m,)
        np.testing.assert_array_equal(g, w)
    counters = {k: v for k, v in wstats.items() if k not in NOT_COMPARED}
    assert {k: gstats[k] for k in counters} == counters


def test_paging_and_speculation_refused_as_the_reference(setup):
    s = setup
    assert not tlm.model_supports_paging(s["tmodel"])
    assert not tlm.model_supports_speculative(s["tmodel"])
    with pytest.raises(NotImplementedError) as want:
        jlm.init_paged_caches(s["jmodel"], 9, 4, jnp.float32)
    with pytest.raises(NotImplementedError) as got:
        tlm.init_paged_caches(s["tmodel"], 9, 4, torch.float32, "cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError) as want:
        jsp.DraftModel.from_target(s["jparams"], s["jmodel"], 1)
    with pytest.raises(NotImplementedError) as got:
        tsp.DraftModel.from_target(s["tparams"], s["tmodel"], 1)
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="speculative verify needs"):
        tlm.verify_window(s["tparams"], s["tmodel"], torch.zeros((1, 2), dtype=torch.long),
                          tlm.init_caches(s["tmodel"], 1, 8, torch.float32, "cpu"),
                          torch.zeros(1, dtype=torch.long))
    _, tp, _, tcfg = _attn(s)
    x = torch.zeros((1, 2, tcfg.d_model))
    with pytest.raises(NotImplementedError, match="full-attention GQA layers only"):
        TA.attn_verify_window(tp, tcfg, x, {}, torch.zeros(1, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="full-attention GQA layers only"):
        TA.attn_decode_step_paged(tp, tcfg, x[:, :1], {}, torch.zeros((1, 2), dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.long))
    eng = Engine(s["tparams"], s["tmodel"], ServeConfig(max_seq=16, paged=True, block_size=4),
                 device="cpu")
    with pytest.raises(NotImplementedError, match="paged KV needs full-attention"):
        eng.serve_continuous([np.ones(3, np.int32)], slots=1, max_new=2)


@pytest.mark.parametrize("flag", ["--spec-k", "--paged"])
def test_cli_refuses_as_the_reference(flag, capsys):
    """``--spec-k`` exits rc=2 with the reference's message; ``--paged``
    raises the reference's ``NotImplementedError``."""
    argv = ["--arch", ARCH, "--engine", "continuous", "--requests", "2", "--batch", "1",
            "--prompt-len", "4", "--max-new", "2"] + (["--spec-k", "2"] if flag == "--spec-k"
                                                      else ["--paged", "--block-size", "4"])
    if flag == "--spec-k":
        assert jserve.main(argv) == 2
        want = capsys.readouterr().err
        assert tserve.main(argv + ["--device", "cpu"]) == 2
        assert capsys.readouterr().err == want and "does not support speculative" in want
    else:
        with pytest.raises(NotImplementedError) as want:
            jserve.main(argv)
        with pytest.raises(NotImplementedError) as got:
            tserve.main(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value)


def test_cli_deepseek_runs_on_cpu(capsys):
    argv = ["--arch", ARCH, "--device", "cpu", "--engine", "continuous", "--requests", "3",
            "--batch", "2", "--prompt-len", "6", "--max-new", "3"]
    assert tserve.main(argv) == 0
    out = capsys.readouterr().out
    assert "[serve:continuous] 3 requests, 9 tokens" in out and "served=3/3" in out
