"""The port's greedy speculative decoding against the JAX package, on the CPU.

Reduced kanformer-100m, parameters made in JAX and carried across with
``params_from_jax``, fp32.  What must be EQUAL to the reference:

* the integers of ``accept_window`` and ``complete_spec_window``, on
  hypothesis-drawn windows (EOS inside the window, latched rows, budgets
  the window overshoots);
* ``DraftModel.from_target``'s structure and errors, and ``_fake_quant_int8``'s
  values (the target's weights untouched);
* ``copy_paged_blocks``' pools;
* ``serve_continuous`` with ``spec_k`` in {1, 2, 3} (dense, paged with shadow
  and step reads, prefix caching off, EOS, a pool that preempts): every
  stream, every counter the reference exports (``last_serve_stats["spec"]``
  included), and the streams of the port's own ``spec_k = 0`` engine; a
  full-depth drafter (acceptance 1.0) and one with an all-zero embedding
  (acceptance 0.0, streams exact).

Floats are allclose: verify-window attention outputs and caches at atol
1e-5, logits at atol 1e-4 (fp32; the reference's own verify and decode
logits differ by ~8e-6 on this jax).  Blocks other than the sentinel are
compared; the sentinel takes every redirected write in no defined order.
"""

import dataclasses

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_jax_subprocess
from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import lm as jlm
from repro.serve import scheduler as jsched
from repro.serve import speculative as jsp
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm
from repro_torch.serve import scheduler as tsched
from repro_torch.serve import speculative as tsp
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "kanformer-100m"
MAX_SEQ = 32
BLOCK = 4
SLOTS, CHUNK = 3, 3
ATTN_ATOL, LOGIT_ATOL = 1e-5, 1e-4
# the reference's keys that describe its wall clock, JAX tracing or meshes
NOT_COMPARED = {"wall_s", "request_latency_s", "compiles", "mesh_shape", "paged"}
MODES = {
    "dense": {},
    "paged_shadow": {"paged": True},
    "paged_step": {"paged": True, "paged_read": "step"},
    "prefix_off": {"paged": True, "prefix_caching": False},
    "eos": {"paged": True},
    "tight_pool": {"paged": True, "pool_blocks": 10},
}


@pytest.fixture(scope="module")
def setup():
    jmodel = jconfigs.get_reduced(ARCH).model
    tmodel = tconfigs.get_reduced(ARCH).model
    jparams = jlm.init_params(jax.random.PRNGKey(0), jmodel)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    base = dict(max_seq=MAX_SEQ, max_new_tokens=8, block_size=BLOCK, spec_k=1)
    jeng = JEngine(jparams, jmodel, JServeConfig(**base))
    teng = Engine(tparams, tmodel, ServeConfig(**base), device="cpu")
    rs = np.random.RandomState(0)
    common = rs.randint(1, jmodel.vocab, 2 * BLOCK).astype(np.int32)
    reqs = []
    for i in range(10):
        r = rs.randint(1, jmodel.vocab, int(rs.randint(3, 14))).astype(np.int32)
        reqs.append(np.concatenate([common, r]) if i % 2 else r)
    budgets = [int(b) for b in rs.randint(1, 9, len(reqs))]
    return {"jeng": jeng, "teng": teng, "reqs": reqs, "budgets": budgets,
            "jparams": jparams, "tparams": tparams, "jmodel": jmodel, "tmodel": tmodel,
            "base": base, "eos": {}}


def _serve(eng, cfg: dict, reqs, budgets):
    eng.cfg = dataclasses.replace(eng.cfg, **cfg)
    outs = eng.serve_continuous(reqs, slots=SLOTS, chunk_steps=CHUNK, max_new=budgets)
    return outs, eng.last_serve_stats


def _assert_same_run(got, gstats, want, wstats, budgets):
    assert len(got) == len(want)
    for g, w, m in zip(got, want, budgets):
        assert g.dtype == np.int32 and g.shape == (m,)
        np.testing.assert_array_equal(g, w)
    counters = {k: v for k, v in wstats.items() if k not in NOT_COMPARED}
    assert {k: gstats[k] for k in counters} == counters
    assert ("paged" in gstats) == ("paged" in wstats)
    if "paged" in wstats:
        assert gstats["paged"] == wstats["paged"]


def _eos_token(s) -> int:
    """A token that request 0's greedy stream emits at its second step."""
    if "tok" not in s["eos"]:
        probe, _ = _serve(s["jeng"], {"paged": False, "eos_id": -1, "spec_k": 0},
                          s["reqs"], s["budgets"])
        s["eos"]["tok"] = int(probe[0][1])
    return s["eos"]["tok"]


# ---------------------------------------------------------------------------
# serve_continuous: streams and counters equal to the JAX engine's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec_k", [1, 2, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_speculative_serving_equals_reference(setup, mode, spec_k):
    s = setup
    reqs, budgets = s["reqs"], s["budgets"]
    cfg = {"paged": False, "paged_read": "shadow", "prefix_caching": True,
           "pool_blocks": None, "eos_id": -1, **MODES[mode], "spec_k": spec_k}
    if mode == "eos":
        cfg["eos_id"] = _eos_token(s)
    want, wstats = _serve(s["jeng"], cfg, reqs, budgets)
    got, gstats = _serve(s["teng"], cfg, reqs, budgets)
    _assert_same_run(got, gstats, want, wstats, budgets)
    assert gstats["spec"]["spec_k"] == spec_k and gstats["spec"]["windows"] == gstats["chunks_run"]
    assert len(gstats["draft_prefill_groups"]) == len(gstats["prefill_groups"])
    # the port's own non-speculative streams
    plain, _ = _serve(s["teng"], {**cfg, "spec_k": 0}, reqs, budgets)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)
    if mode == "eos":
        first = int(np.nonzero(got[0] == cfg["eos_id"])[0][0])
        assert first < budgets[0] - 1 and (got[0][first + 1:] == 0).all()
    if mode == "tight_pool":
        assert gstats["n_preemptions"] >= 1


def _drafter_engines(s, jdraft, tdraft):
    cfg = dict(s["base"], spec_k=2)
    jeng = JEngine(s["jparams"], s["jmodel"], JServeConfig(**cfg, draft=jdraft))
    teng = Engine(s["tparams"], s["tmodel"], ServeConfig(**cfg, draft=tdraft), device="cpu")
    return jeng, teng


def test_full_depth_drafter_accepts_everything(setup):
    s = setup
    n = s["tmodel"].n_repeats
    jeng, teng = _drafter_engines(
        s, jsp.DraftModel.from_target(s["jparams"], s["jmodel"], n_layers=n),
        tsp.DraftModel.from_target(s["tparams"], s["tmodel"], n_layers=n))
    want, wstats = _serve(jeng, {"paged": False}, s["reqs"], s["budgets"])
    got, gstats = _serve(teng, {"paged": False}, s["reqs"], s["budgets"])
    _assert_same_run(got, gstats, want, wstats, s["budgets"])
    assert gstats["spec"]["acceptance_rate"] == 1.0
    assert gstats["spec"]["draft_layers"] == n


def test_zero_embedding_drafter_rejects_everything_and_stays_exact(setup):
    s = setup
    jd = jsp.DraftModel.from_target(s["jparams"], s["jmodel"], n_layers=1)
    jd = jsp.DraftModel(params={**jd.params, "embed": {
        "table": jnp.zeros_like(s["jparams"]["embed"]["table"])}}, cfg=jd.cfg, n_layers=1)
    td = tsp.DraftModel.from_target(s["tparams"], s["tmodel"], n_layers=1)
    td = tsp.DraftModel(params={**td.params, "embed": {
        "table": torch.zeros_like(s["tparams"]["embed"]["table"])}}, cfg=td.cfg, n_layers=1)
    jeng, teng = _drafter_engines(s, jd, td)
    for paged in (False, True):
        want, wstats = _serve(jeng, {"paged": paged}, s["reqs"], s["budgets"])
        got, gstats = _serve(teng, {"paged": paged}, s["reqs"], s["budgets"])
        _assert_same_run(got, gstats, want, wstats, s["budgets"])
        assert gstats["spec"]["acceptance_rate"] == 0.0
    assert s["tparams"]["embed"]["table"].abs().sum() > 0      # the target's untouched


# ---------------------------------------------------------------------------
# accept_window and complete_spec_window: integers equal
# ---------------------------------------------------------------------------


@hypothesis.settings(max_examples=25, deadline=None)
@hypothesis.given(seed=st.integers(0, 10_000), B=st.integers(1, 4), k=st.integers(1, 4),
                  eos_id=st.sampled_from([-1, 0, 1, 2]), pad_id=st.sampled_from([0, 7]))
def test_accept_window_equals_reference(seed, B, k, eos_id, pad_id):
    rs = np.random.RandomState(seed)
    target = rs.randint(0, 4, (B, k + 1)).astype(np.int32)
    draft = np.where(rs.rand(B, k) < 0.7, target[:, :k], rs.randint(0, 4, (B, k))).astype(np.int32)
    eos_hit = rs.rand(B) < 0.25
    want = jsp.accept_window(jnp.asarray(draft), jnp.asarray(target), jnp.asarray(eos_hit),
                             jnp.int32(eos_id), jnp.int32(pad_id))
    got = tsp.accept_window(torch.tensor(draft), torch.tensor(target), torch.tensor(eos_hit),
                            eos_id, pad_id)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32


@hypothesis.settings(max_examples=25, deadline=None)
@hypothesis.given(seed=st.integers(0, 10_000), slots=st.integers(1, 4), k=st.integers(1, 4))
def test_complete_spec_window_equals_reference(seed, slots, k):
    """Both schedulers through the same admissions and windows: emitted
    counts up to W (budgets overshot), EOS hits, latched and empty rows."""
    rs = np.random.RandomState(seed)
    n = 2 * slots + 1
    ref, port = jsched.ContinuousScheduler(slots, range(n)), tsched.ContinuousScheduler(slots, range(n))
    W = k + 1
    for _ in range(12):
        ready = ref.admit_ready()
        assert port.admit_ready() == ready
        for b, rid in ready:
            args = (b, rid, int(rs.randint(1, 20)), int(rs.randint(0, 9)), bool(rs.rand() < 0.1))
            assert port.confirm_admit(*args) == ref.confirm_admit(*args)
        if not ref.can_run_chunk():
            break
        m = rs.randint(0, W + 1, slots)
        hits = rs.rand(slots) < 0.2
        steps = rs.randint(0, W + 1, slots) if rs.rand() < 0.5 else None
        out = ref.complete_spec_window(W, m, hits, steps)
        assert port.complete_spec_window(W, m, hits, steps) == out
        for b, _, _, finished in out:
            if finished:
                assert port.retire(b) == ref.retire(b)
        assert port.stats() == ref.stats()
    port.check_invariants()


# ---------------------------------------------------------------------------
# DraftModel
# ---------------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_draft_model_slices_are_views_and_the_rest_is_aliased(setup):
    s = setup
    tp, tm = s["tparams"], s["tmodel"]
    d = tsp.DraftModel.from_target(tp, tm, n_layers=1)
    jd = jsp.DraftModel.from_target(s["jparams"], s["jmodel"], n_layers=1)
    assert d.cfg == dataclasses.replace(tm, name=jd.cfg.name, n_repeats=1)
    assert d.cfg.name == jd.cfg.name == f"{tm.name}-draft1" and not d.quant
    assert d.params["embed"] is tp["embed"] and d.params["final_ln"] is tp["final_ln"]
    full, sliced = _leaves(tp["unit"]), _leaves(d.params["unit"])
    assert len(full) == len(sliced) == len(jax.tree.leaves(jd.params["unit"]))
    for a, b in zip(full, sliced):
        assert b._base is a and b.data_ptr() == a.data_ptr()       # a view, no copy
        assert b.shape == (1,) + a.shape[1:]


@pytest.mark.parametrize("n_layers", [0, 3])
def test_draft_model_refuses_what_the_reference_refuses(setup, n_layers):
    s = setup
    with pytest.raises(ValueError) as want:
        jsp.DraftModel.from_target(s["jparams"], s["jmodel"], n_layers=n_layers)
    with pytest.raises(ValueError) as got:
        tsp.DraftModel.from_target(s["tparams"], s["tmodel"], n_layers=n_layers)
    assert str(got.value) == str(want.value)


def test_engine_validates_spec_k(setup):
    s = setup
    with pytest.raises(ValueError, match="spec_k must be >= 0, got -1"):
        Engine(s["tparams"], s["tmodel"], ServeConfig(max_seq=MAX_SEQ, spec_k=-1), device="cpu")
    sampled = Engine(s["tparams"], s["tmodel"],
                     ServeConfig(max_seq=MAX_SEQ, spec_k=2, temperature=0.7), device="cpu")
    assert sampled.draft is not None and sampled.draft.n_layers == 1
    eng = Engine(s["tparams"], s["tmodel"], ServeConfig(max_seq=MAX_SEQ), device="cpu")
    assert eng.draft is None
    eng.cfg = dataclasses.replace(eng.cfg, spec_k=2)
    with pytest.raises(ValueError, match="needs the drafter"):
        eng.serve_continuous(s["reqs"][:2], slots=2, max_new=4)


def test_draft_model_refuses_a_model_without_token_inputs(setup):
    s = setup
    jm = dataclasses.replace(s["jmodel"], input_kind="embeddings")
    tm = dataclasses.replace(s["tmodel"], input_kind="embeddings")
    assert not jlm.model_supports_speculative(jm) and not tlm.model_supports_speculative(tm)
    assert tlm.model_supports_speculative(s["tmodel"])
    with pytest.raises(NotImplementedError) as want:
        jsp.DraftModel.from_target(s["jparams"], jm)
    with pytest.raises(NotImplementedError) as got:
        tsp.DraftModel.from_target(s["tparams"], tm)
    assert str(got.value) == str(want.value)


def test_fake_quant_drafter_equals_reference_and_leaves_the_target(setup):
    s = setup
    before = [a.clone() for a in _leaves(s["tparams"]["unit"])]
    d = tsp.DraftModel.from_target(s["tparams"], s["tmodel"], n_layers=1, quant=True)
    jd = jsp.DraftModel.from_target(s["jparams"], s["jmodel"], n_layers=1, quant=True)
    assert d.quant and jd.quant
    got = _leaves(d.params["unit"])
    want = _leaves(jax.device_get(jd.params["unit"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for a, b in zip(before, _leaves(s["tparams"]["unit"])):
        assert torch.equal(a, b)
    for g, a in zip(got, before):
        if g.dim() >= 2:
            assert g.data_ptr() != a.data_ptr()                 # a new tensor


# ---------------------------------------------------------------------------
# attention, the whole model and the block copies
# ---------------------------------------------------------------------------


def _attn_case(setup, seed, B=3, W=4, S=MAX_SEQ):
    s = setup
    rs = np.random.RandomState(seed)
    jcfg, tcfg = s["jmodel"].unit[0].attn, s["tmodel"].unit[0].attn
    jp = jax.tree.map(lambda a: a[0], s["jparams"]["unit"][0]["attn"])
    tp = {k: v[0] for k, v in s["tparams"]["unit"][0]["attn"].items()}
    x = rs.randn(B, W, s["tmodel"].d_model).astype(np.float32)
    kv = {n: rs.randn(B, S, tcfg.n_kv_heads, tcfg.head_dim).astype(np.float32)
          for n in ("k", "v")}
    return jcfg, tcfg, jp, tp, x, kv


def test_attn_verify_window_equals_reference_and_drops_past_the_cache(setup):
    """Row 2 starts 2 slots before the end of the cache: its last 2 window
    positions are dropped on both sides."""
    jcfg, tcfg, jp, tp, x, kv = _attn_case(setup, 1)
    pos = np.array([5, 11, MAX_SEQ - 2])
    jy, jc = JA.attn_verify_window(jp, jcfg, jnp.asarray(x), {n: jnp.asarray(a) for n, a in kv.items()},
                                   jnp.asarray(pos, jnp.int32))
    tc = {n: torch.tensor(a) for n, a in kv.items()}
    ty, tc = TA.attn_verify_window(tp, tcfg, torch.tensor(x), tc, torch.tensor(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATTN_ATOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), atol=ATTN_ATOL)
        np.testing.assert_array_equal(tc[n][:, :5].numpy(), kv[n][:, :5])   # untouched slots
        np.testing.assert_array_equal(tc[n][2, :MAX_SEQ - 2].numpy(), kv[n][2, :MAX_SEQ - 2])


def test_attn_verify_window_paged_equals_reference(setup):
    jcfg, tcfg, jp, tp, x, kv = _attn_case(setup, 2)
    rs = np.random.RandomState(3)
    n_blocks, L = 40, MAX_SEQ // BLOCK
    pools = {n: rs.randn(n_blocks, BLOCK, tcfg.n_kv_heads, tcfg.head_dim).astype(np.float32)
             for n in ("k", "v")}
    table = rs.permutation(np.arange(1, n_blocks))[: 3 * L].reshape(3, L).astype(np.int32)
    table[0, 4:] = 0                                   # beyond coverage: the sentinel
    pos = np.array([13, 3, MAX_SEQ - 3])
    jy, jc = JA.attn_verify_window_paged(jp, jcfg, jnp.asarray(x),
                                         {n: jnp.asarray(a) for n, a in pools.items()},
                                         jnp.asarray(table), jnp.asarray(pos, jnp.int32))
    tc = {n: torch.tensor(a) for n, a in pools.items()}
    ty, tc = TA.attn_verify_window_paged(tp, tcfg, torch.tensor(x), tc, torch.tensor(table),
                                         torch.tensor(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATTN_ATOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n][1:].numpy(), np.asarray(jc[n])[1:], atol=ATTN_ATOL)


@pytest.mark.parametrize("paged", [False, True])
def test_lm_verify_window_equals_reference_and_sequential_decode(setup, paged):
    """Three rows, W = 4, from caches holding random K/V; the port's verify
    logits against the reference's, and against the port's own W sequential
    decode steps on a copy of the same caches."""
    s = setup
    tm, jm = s["tmodel"], s["jmodel"]
    rs = np.random.RandomState(4)
    a = tm.unit[0].attn
    B, W, L = 3, 4, MAX_SEQ // BLOCK
    if paged:
        n_blocks = B * L + 1
        shape = (tm.n_repeats, n_blocks, BLOCK, a.n_kv_heads, a.head_dim)
        table = (1 + np.arange(B * L)).reshape(B, L).astype(np.int32)
    else:
        shape, table = (tm.n_repeats, B, MAX_SEQ, a.n_kv_heads, a.head_dim), None
    caches = {"unit": [{n: rs.randn(*shape).astype(np.float32) for n in ("k", "v")}]}
    toks = rs.randint(1, tm.vocab, (B, W)).astype(np.int32)
    pos = np.array([9, 17, MAX_SEQ - 6])
    jl, jc = jlm.verify_window(s["jparams"], jm, jnp.asarray(toks),
                               jax.tree.map(jnp.asarray, caches), jnp.asarray(pos, jnp.int32),
                               jnp.float32, None if table is None else jnp.asarray(table))
    tt = None if table is None else torch.tensor(table)

    def fresh():
        return {"unit": [{n: torch.tensor(v) for n, v in caches["unit"][0].items()}]}

    tl, tc = tlm.verify_window(s["tparams"], tm, torch.tensor(toks), fresh(), torch.tensor(pos),
                               torch.float32, tt)
    assert tl.shape == (B, W, tm.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    for n in ("k", "v"):
        got, want = tc["unit"][0][n].numpy(), np.asarray(jc["unit"][0][n])
        if paged:
            got, want = got[:, 1:], want[:, 1:]
        np.testing.assert_allclose(got, want, atol=ATTN_ATOL)
    seq, p = fresh(), torch.tensor(pos)
    for j in range(W):
        lg, seq = tlm.decode_step(s["tparams"], tm, torch.tensor(toks[:, j:j + 1]), seq, p,
                                  torch.float32, tt)
        np.testing.assert_allclose(lg.numpy(), tl[:, j].numpy(), atol=LOGIT_ATOL)
        p = p + 1


def test_copy_paged_blocks_equals_reference(setup):
    tm = setup["tmodel"]
    rs = np.random.RandomState(5)
    a = tm.unit[0].attn
    shape = (tm.n_repeats, 12, BLOCK, a.n_kv_heads, a.head_dim)
    caches = {"unit": [{n: rs.randn(*shape).astype(np.float32) for n in ("k", "v")}]}
    srcs, dsts = np.array([3, 7, 1, 9]), np.array([5, 3, 11, 2])   # a dst that is a src
    want = jlm.copy_paged_blocks(jax.tree.map(jnp.asarray, caches), srcs, dsts)
    tc = {"unit": [{n: torch.tensor(v) for n, v in caches["unit"][0].items()}]}
    got = tlm.copy_paged_blocks(tc, srcs, dsts)
    one = tlm.copy_paged_block({"unit": [{n: torch.tensor(v) for n, v in caches["unit"][0].items()}]},
                               4, 6)
    want_one = jlm.copy_paged_block(jax.tree.map(jnp.asarray, caches), 4, 6)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got["unit"][0][n].numpy(), np.asarray(want["unit"][0][n]))
        np.testing.assert_array_equal(one["unit"][0][n].numpy(), np.asarray(want_one["unit"][0][n]))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_speculative_paged_serves_on_cpu():
    r = run_jax_subprocess(argv=[
        "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
        "--engine", "continuous", "--paged", "--spec-k", "2", "--requests", "5",
        "--batch", "2", "--prompt-len", "8", "--max-new", "4", "--block-size", "4"],
        timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[serve:continuous] 5 requests, 20 tokens" in r.stdout
    assert "served=5/5" in r.stdout and "[serve:spec] k=2 draft_layers=1" in r.stdout


@pytest.mark.parametrize("flags,message", [
    (["--spec-k", "2"], "--spec-k requires --engine continuous"),
    (["--engine", "continuous", "--spec-k", "2", "--draft-layers", "3"],
     "--draft-layers must be in [1, 2] for kanformer-100m, got 3"),
])
def test_cli_refuses_speculation_as_the_reference(flags, message, capsys):
    assert tserve.main(["--arch", ARCH, "--device", "cpu", *flags]) == 2
    assert f"[serve] {message}" in capsys.readouterr().err
