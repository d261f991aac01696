"""The port's int8 KV cache against the JAX package, fp32 on the CPU.

``enable_kv_quant`` of qwen1.5-0.5b ``reduced()`` (and of kanformer-100m
``reduced()`` for the KAN FFN), parameters made in JAX and carried across
with ``params_from_jax``.  What must hold:

* ``_kv_quantize`` BIT-EQUAL to the reference's on identical inputs
  (half-way quotients included: both round half to even);
* through the model, the cached int8 values within 1 of the reference's
  (a quotient within an ulp of .5 may round either way once the K/V
  themselves differ in the last bits) and the scales within 1e-6 relative;
* the port's paged int8 decode BIT-EQUAL to its dense int8 decode, and the
  int8 logits within the reference's bounds of fp32's (``rel < 0.1``,
  top-1 agreement ``> 0.9``);
* greedy streams and the counters of ``last_serve_stats`` EQUAL to the JAX
  engine's: ``serve_requests``, ``serve_continuous`` dense, paged shadow,
  paged step and ``spec_k = 2``; prefix reuse stays off
  (``prefill_tokens_saved == 0``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.common import enable_kv_quant as jquant
from repro.models import attention as JA
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.configs.common import enable_kv_quant as tquant
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "qwen1.5-0.5b"
LOGIT_ATOL = 1e-4
SCALE_RTOL = 1e-6
MAX_SEQ = 32
BLOCK = 4
SLOTS, CHUNK = 3, 3
NOT_COMPARED = {"wall_s", "request_latency_s", "compiles", "mesh_shape", "paged"}
MODES = {
    "dense": {},
    "paged_shadow": {"paged": True},
    "paged_step": {"paged": True, "paged_read": "step"},
    "spec_k2": {"spec_k": 2},
}


def _requests(vocab):
    rs = np.random.RandomState(0)
    common = rs.randint(1, vocab, 2 * BLOCK).astype(np.int32)
    reqs = []
    for i in range(8):
        r = rs.randint(1, vocab, int(rs.randint(3, 14))).astype(np.int32)
        reqs.append(np.concatenate([common, r]) if i % 2 else r)
    return reqs, [int(b) for b in rs.randint(1, 9, len(reqs))]


def _engines(arch):
    jmodel = jquant(jconfigs.get_reduced(arch)).model
    tmodel = tquant(tconfigs.get_reduced(arch)).model
    jparams = jlm.init_params(jax.random.PRNGKey(0), jmodel)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    base = dict(max_seq=MAX_SEQ, max_new_tokens=8, block_size=BLOCK, spec_k=2)
    return {"jmodel": jmodel, "tmodel": tmodel, "jparams": jparams, "tparams": tparams,
            "jeng": JEngine(jparams, jmodel, JServeConfig(**base)),
            "teng": Engine(tparams, tmodel, ServeConfig(**base), device="cpu")}


@pytest.fixture(scope="module")
def setup():
    s = _engines(ARCH)
    s["reqs"], s["budgets"] = _requests(s["jmodel"].vocab)
    return s


def _serve_both(s, cfg: dict):
    res = []
    for eng in (s["jeng"], s["teng"]):
        eng.cfg = dataclasses.replace(eng.cfg, **cfg)
        outs = eng.serve_continuous(s["reqs"], slots=SLOTS, chunk_steps=CHUNK,
                                    max_new=s["budgets"])
        res.append((outs, eng.last_serve_stats))
    return res


def _assert_same_run(res, budgets):
    (want, wstats), (got, gstats) = res
    for g, w, m in zip(got, want, budgets):
        assert g.dtype == np.int32 and g.shape == (m,)
        np.testing.assert_array_equal(g, w)
    counters = {k: v for k, v in wstats.items() if k not in NOT_COMPARED}
    assert {k: gstats[k] for k in counters} == counters
    assert ("paged" in gstats) == ("paged" in wstats)
    if "paged" in wstats:
        assert gstats["paged"] == wstats["paged"]
        assert gstats["paged"]["prefill_tokens_saved"] == 0
        assert gstats["paged"]["prefix_caching"] is False


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_quantize_bit_equal_reference(seed):
    rs = np.random.RandomState(seed)
    k = (rs.randn(3, 5, 4, 16) * 10 ** rs.uniform(-3, 2)).astype(np.float32)
    k[0, 0] = 0.0                                     # an all-zero row: the 1e-6 floor
    k[1, 1, :, :3] = [127.0, 63.5, -0.5]              # quotients at .5: half to even
    k[1, 1, :, 3:] = 0.0
    jq, js = JA._kv_quantize(jnp.asarray(k))
    tq, ts = TA._kv_quantize(torch.tensor(k))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.numpy()[1, 1, 0, 1] == 64 and tq.numpy()[1, 1, 0, 2] == 0


def test_prefill_and_decode_caches_match_reference(setup):
    """Prefill (slots past T hold the quantised zero pad, as the
    reference's) and 3 per-row decode steps: int8 values within 1, scales
    within 1e-6 relative, logits atol 1e-4."""
    s = setup
    toks = np.random.RandomState(1).randint(0, 512, (2, 9)).astype(np.int32)
    jlog, jc = jlm.prefill(s["jparams"], s["jmodel"], {"tokens": jnp.asarray(toks)},
                           MAX_SEQ, jnp.float32)
    tlog, tc = tlm.prefill(s["tparams"], s["tmodel"], torch.tensor(toks), MAX_SEQ, torch.float32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    pos = np.array([9, 6])
    for k in range(3):
        tok = toks[:, k:k + 1]
        jlog, jc = jlm.decode_step(s["jparams"], s["jmodel"], jnp.asarray(tok), jc,
                                   jnp.asarray(pos + k, jnp.int32), jnp.float32)
        tlog, tc = tlm.decode_step(s["tparams"], s["tmodel"], torch.tensor(tok), tc,
                                   torch.tensor(pos + k), torch.float32)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    got, want = tc["unit"][0], jc["unit"][0]
    assert sorted(got) == sorted(want) == ["k", "k_scale", "v", "v_scale"]
    for n in ("k", "v"):
        assert got[n].dtype == torch.int8
        diff = np.abs(got[n].numpy().astype(np.int32) - np.asarray(want[n]).astype(np.int32))
        assert diff.max() <= 1
        np.testing.assert_allclose(got[n + "_scale"].numpy(), np.asarray(want[n + "_scale"]),
                                   rtol=SCALE_RTOL, atol=0)


def test_paged_int8_decode_bit_equal_dense_int8(setup):
    """The pool holds the int8 values and scales the dense cache holds (the
    dense prefill's cache scattered into a random permutation of blocks),
    the gather moves them unchanged, and the chunked dequantising read runs
    on the gathered view: 4 paged int8 decode steps give logits and cache
    writes EQUAL to the dense int8 ones.  Paged prefill's own logits are
    within atol 1e-4 of dense prefill's (its attention sweeps the
    ``max_seq`` view, not T keys)."""
    s = setup
    model, params = s["tmodel"], s["tparams"]
    B, T, nl = 2, 6, MAX_SEQ // BLOCK
    rs = np.random.RandomState(7)
    toks = torch.tensor(rs.randint(0, model.vocab, (B, T)))
    logits_d, dense = tlm.prefill(params, model, toks, MAX_SEQ, torch.float32)
    n_blocks = 2 * B * nl + 1
    tables = torch.tensor(rs.permutation(np.arange(1, n_blocks))[:B * nl]
                          .reshape(B, nl).astype(np.int32))
    fresh = tlm.init_paged_caches(model, n_blocks, BLOCK, torch.float32, "cpu")
    last_p, _ = tlm.prefill_into_pages(params, model, toks, torch.full((B,), T), tables,
                                       fresh, 0, torch.float32)
    np.testing.assert_allclose(last_p.numpy(), logits_d[:, T - 1].numpy(), atol=LOGIT_ATOL)
    pools = tlm.init_paged_caches(model, n_blocks, BLOCK, torch.float32, "cpu")
    assert len(pools["unit"][0]) == 4 and pools["unit"][0]["k"].dtype == torch.int8
    for pool, rows in zip(pools["unit"], dense["unit"]):
        for n, p in pool.items():
            blocks = rows[n].reshape((p.shape[0], B, nl, BLOCK) + p.shape[3:])
            p[:, tables.reshape(-1).long()] = blocks.reshape((p.shape[0], B * nl, BLOCK)
                                                             + p.shape[3:])
    tok = logits_d[:, T - 1].argmax(-1)[:, None]
    pos = torch.full((B,), T)
    for _ in range(4):
        lg_d, dense = tlm.decode_step(params, model, tok, dense, pos, torch.float32)
        lg_p, pools = tlm.decode_step(params, model, tok, pools, pos, torch.float32, tables)
        assert torch.equal(lg_d, lg_p)
        tok = lg_p.argmax(-1)[:, None]
        pos = pos + 1
    view = tlm.paged_views(pools, tables)
    for n in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(view["unit"][0][n], dense["unit"][0][n])


def test_int8_decode_close_to_fp32(setup):
    """The reference's ``test_kv_quant_decode_close_to_fp`` on the port:
    12 tokens teacher-forced through decode steps, int8 against fp32 KV."""
    s = setup
    fp_model = tconfigs.get_reduced(ARCH).model
    toks = torch.tensor(np.random.RandomState(0).randint(0, 512, (2, 12)))

    def teacher_force(model):
        caches = tlm.init_caches(model, 2, 12, torch.float32, "cpu")
        outs = []
        for t in range(12):
            lg, caches = tlm.decode_step(s["tparams"], model, toks[:, t:t + 1], caches,
                                         torch.tensor(t), torch.float32)
            outs.append(lg)
        return torch.stack(outs, 1)

    fp, q8 = teacher_force(fp_model), teacher_force(s["tmodel"])
    rel = ((fp - q8).abs().max() / fp.abs().max()).item()
    agree = (fp.argmax(-1) == q8.argmax(-1)).float().mean().item()
    assert rel < 0.1 and agree > 0.9, (rel, agree)


@pytest.mark.parametrize("paged", [False, True])
def test_verify_window_int8_matches_reference(setup, paged):
    """A 3-token verify window over an int8 cache (quantised span writes,
    the chunked dequantising sweep): logits atol 1e-4, dense and paged."""
    s = setup
    B, T, W = 2, 7, 3
    rs = np.random.RandomState(5)
    toks = rs.randint(0, 512, (B, T)).astype(np.int32)
    win = rs.randint(0, 512, (B, W)).astype(np.int32)
    pos = np.array([7, 5], np.int32)
    _, jc = jlm.prefill(s["jparams"], s["jmodel"], {"tokens": jnp.asarray(toks)},
                        MAX_SEQ, jnp.float32)
    jlog, _ = jlm.verify_window(s["jparams"], s["jmodel"], jnp.asarray(win), jc,
                                jnp.asarray(pos), jnp.float32)
    _, tc = tlm.prefill(s["tparams"], s["tmodel"], torch.tensor(toks), MAX_SEQ, torch.float32)
    table = None
    if paged:
        nl = MAX_SEQ // BLOCK
        table = torch.tensor(np.arange(1, B * nl + 1, dtype=np.int32).reshape(B, nl))
        pools = tlm.init_paged_caches(s["tmodel"], B * nl + 1, BLOCK, torch.float32, "cpu")
        for pool, dense in zip(pools["unit"], tc["unit"]):
            for n in pool:
                pool[n][:, 1:] = dense[n].reshape(pool[n][:, 1:].shape)
        tc = pools
    tlog, _ = tlm.verify_window(s["tparams"], s["tmodel"], torch.tensor(win), tc,
                                torch.tensor(pos, dtype=torch.int64), torch.float32, table)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)


def test_serve_requests_int8_equals_reference(setup):
    s = setup
    for eng in (s["jeng"], s["teng"]):
        eng.cfg = dataclasses.replace(eng.cfg, paged=False, spec_k=0)
    want = s["jeng"].serve_requests(s["reqs"], batch_size=3, seed=0)
    got = s["teng"].serve_requests(s["reqs"], batch_size=3, seed=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_continuous_int8_equals_reference(setup, mode):
    s = setup
    cfg = {"paged": False, "paged_read": "shadow", "spec_k": 0, **MODES[mode]}
    _assert_same_run(_serve_both(s, cfg), s["budgets"])


def test_kanformer_int8_kv_paged_serving_equals_reference():
    """An int8 KV cache on the KAN model: paged ``serve_continuous`` streams
    and counters equal the JAX engine's."""
    s = _engines("kanformer-100m")
    s["reqs"], s["budgets"] = _requests(s["jmodel"].vocab)
    _assert_same_run(_serve_both(s, {"paged": True, "spec_k": 0}), s["budgets"])
