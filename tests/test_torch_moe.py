"""The port's MoE models against the JAX package, fp32 on the CPU.

``models/moe.py`` is held against ``repro/models/moe.py`` under both
dispatches, gated, with and without shared experts, at the published
capacity factor and at one that drops (0.5, as ``tests/test_substrates.py``
drops); then olmoe-1b-7b ``reduced()`` (2 x attn_moe, 8 experts top-2, q/k
norm) is built once in JAX (``lm.init_params``), carried across with
``params_from_jax``, and both sides run the same tokens.  What must hold:

* ``config()`` and ``reduced()`` of olmoe-1b-7b and deepseek-v2-lite equal
  the reference's field by field, and the parameter trees the reference's
  shapes;
* the routing decisions (``top_e``, queue positions, ``keep``, drop counts)
  EQUAL to the reference's; the k-th vs (k+1)-th router probability gap of
  every routed token of these seeds is checked to be above 1e-6 (a gap
  under one fp32 ulp of the router logits could flip between frameworks);
* the capacity depends on the companions: a pad row changes which real
  token drops, in the reference as in the port;
* ``y`` and the logits within atol 1e-5 / 1e-4 (fp32 sums in another
  order), ``moe_lb_loss`` and ``moe_z_loss`` within rtol 1e-6,
  ``moe_drop_frac`` to its integer drop count;
* greedy streams of ``serve_requests``, and of ``serve_continuous`` dense,
  paged shadow, paged step, a pool that preempts and speculative
  (``spec_k = 2``, dense and paged shadow), greedy and sampled at
  ``SAMPLE_T``, EQUAL to the JAX engine's, and so are the counters of
  ``last_serve_stats``; the CLI serves ``--arch olmoe-1b-7b`` on the CPU;
* a model with a GQA prologue and epilogue block served paged (shadow and
  step reads) EQUAL to the JAX engine's, with the gathers that
  ``chip_smoke.expected_launches`` counts.

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
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.convert import flatten_with_paths, params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "olmoe-1b-7b"
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite")
Y_ATOL = 1e-5
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5
AUX_RTOL = 1e-6
MIN_GAP = 1e-6
MAX_SEQ = 32
BLOCK = 4
SLOTS, CHUNK = 3, 3
# the reduced model's median top-2 logit lead is ~39: at T = 20 about 0.96
# of the draws are expected off the argmax, so at least half of the
# streams' first tokens leave the greedy ones
SAMPLE_T = 20.0
# the reference's keys that describe its wall clock, JAX tracing or meshes
NOT_COMPARED = {"wall_s", "request_latency_s", "compiles", "mesh_shape", "paged"}
MODES = {
    "dense": {},
    "paged_shadow": {"paged": True},
    "paged_step": {"paged": True, "paged_read": "step"},
    "spec_k2": {"spec_k": 2},
    "spec_k2_shadow": {"spec_k": 2, "paged": True},
    "tight_pool": {"paged": True, "pool_blocks": 8},
}
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    jmodel = jconfigs.get_reduced(ARCH).model
    tmodel = tconfigs.get_reduced(ARCH).model
    jparams = jlm.init_params(jax.random.PRNGKey(0), jmodel)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    base = dict(max_seq=MAX_SEQ, max_new_tokens=6, block_size=BLOCK, spec_k=2)
    rs = np.random.RandomState(0)
    common = rs.randint(1, jmodel.vocab, 2 * BLOCK).astype(np.int32)
    reqs = []
    for i in range(6):
        r = rs.randint(1, jmodel.vocab, int(rs.randint(3, 9))).astype(np.int32)
        reqs.append(np.concatenate([common, r]) if i % 2 else r)
    budgets = [int(b) for b in rs.randint(1, 7, len(reqs))]
    hot = dict(base, temperature=SAMPLE_T)
    return {"jmodel": jmodel, "tmodel": tmodel, "jparams": jparams, "tparams": tparams,
            "jeng": JEngine(jparams, jmodel, JServeConfig(**base)),
            "teng": Engine(tparams, tmodel, ServeConfig(**base), device="cpu"),
            # the JAX engine's compiled programs read the temperature when traced
            "jeng_hot": JEngine(jparams, jmodel, JServeConfig(**hot)),
            "teng_hot": Engine(tparams, tmodel, ServeConfig(**hot), device="cpu"),
            "reqs": reqs, "budgets": budgets}


def _jprefill(s, toks):
    return jax.jit(functools.partial(jlm.prefill, cfg=s["jmodel"], max_seq=MAX_SEQ,
                                     compute_dtype=jnp.float32))(
        s["jparams"], inputs={"tokens": jnp.asarray(toks)})


def _tok(seed, B, T, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, T)).astype(np.int32)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
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
                    if bn in ("attn", "moe") and bv is not None:
                        assert _fields(bv) == {k: getattr(getattr(wb, bn), k)
                                               for k in _fields(bv)}, (name, bn)
                    else:
                        assert bv == getattr(wb, bn), (name, bn)
        else:
            assert v == getattr(wm, name), name
    assert gm.n_layers == wm.n_layers


@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_tree_matches_abstract_params(arch, which):
    jmodel = getattr(jconfigs, f"get_{which}")(arch).model
    tmodel = getattr(tconfigs, f"get_{which}")(arch).model
    want = {k: tuple(v.shape) for k, v in
            _flatten_with_paths(jlm.abstract_params(jmodel))[0].items()}
    got = {k: spec.shape for k, spec in flatten_with_paths(tlm.param_shapes(tmodel)).items()}
    assert got == want


def test_init_params_scales_of_the_experts():
    """The expert leaves carry the reference's fan-in scale over every
    axis but the last (``(E, d, f)``: ``1/sqrt(E·d)``), the router 0.02."""
    tmodel = tconfigs.get_reduced(ARCH).model
    moe = tlm.init_params(tmodel, seed=0, device="cpu")["unit"][0]["moe"]
    m = tmodel.unit[0].moe
    for name, fan_in in (("wi", m.n_experts * m.d_model), ("wg", m.n_experts * m.d_model),
                         ("wo", m.n_experts * m.d_ff), ("router", None)):
        want = 0.02 if fan_in is None else fan_in ** -0.5
        assert abs(moe[name].std().item() - want) < 0.1 * want, name


def _ref_route(p, cfg, xf):
    """The reference's routing decisions, as ``moe_forward`` computes them:
    ``(top_e, pos, keep, cap, the least k-th vs (k+1)-th probability gap)``."""
    cap = int(max(cfg.top_k, cfg.capacity_factor * xf.shape[0] * cfg.top_k / cfg.n_experts))
    top_e, pos, gap = jax.jit(functools.partial(_ref_route_arrays, cfg=cfg))(p["router"], xf)
    return np.asarray(top_e), np.asarray(pos), np.asarray(pos) < cap, cap, float(gap)


def _ref_route_arrays(router, xf, cfg):
    logits = xf @ router
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, cfg.top_k)
    S, E = xf.shape[0], cfg.n_experts
    onehot = jax.nn.one_hot(top_e, E, dtype=jnp.int32)
    flat = onehot.reshape(S * cfg.top_k, E)
    pos = ((jnp.cumsum(flat, axis=0) - flat).reshape(S, cfg.top_k, E) * onehot).sum(-1)
    srt = jnp.sort(probs, axis=-1)[:, ::-1]
    return top_e, pos, (srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]).min()


def _moe_case(dispatch, n_shared, capacity, seed=0, B=2, T=7):
    jcfg = jmoe.MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=2, n_shared=n_shared,
                          capacity_factor=capacity, dispatch=dispatch)
    tcfg = tmoe.MoEConfig(**_fields(jcfg))
    from repro.models.layers import ParamCtx
    jp = jmoe.moe_init(ParamCtx("init", jax.random.PRNGKey(seed)), jcfg)
    # a router of 1/sqrt(d) spreads the choices (the 0.02 init routes near-uniformly)
    jp["router"] = jp["router"] * (50.0 / 8.0)
    x = np.random.RandomState(seed + 1).randn(B, T, 64).astype(np.float32)
    return jcfg, tcfg, jp, params_from_jax(jax.device_get(jp), device="cpu"), x


@pytest.mark.parametrize("capacity", [1.25, 0.5])
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_moe_forward_matches_reference(dispatch, n_shared, capacity):
    jcfg, tcfg, jp, tp, x = _moe_case(dispatch, n_shared, capacity)
    fwd = jax.jit(functools.partial(jmoe.moe_forward, cfg=jcfg))
    jy, jaux = fwd(jp, x=jnp.asarray(x))
    ty, taux = tmoe.moe_forward(tp, tcfg, torch.tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL)
    S, k = x.shape[0] * x.shape[1], jcfg.top_k
    top_e, pos, keep, cap, gap = _ref_route(jp, jcfg, jnp.asarray(x.reshape(S, -1)))
    assert gap > MIN_GAP, f"a near-tie in the router ({gap:.2e}): pick another seed"
    _, _, _, t_top_e, t_pos, t_keep, t_cap = tmoe.route(tp, tcfg, torch.tensor(x.reshape(S, -1)))
    assert t_cap == cap
    np.testing.assert_array_equal(t_top_e.numpy(), top_e)
    np.testing.assert_array_equal(t_pos.numpy(), pos)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    drops = int((~keep).sum())
    assert drops > 0 or capacity > 1                          # 0.5 must drop
    assert round(float(taux["moe_drop_frac"]) * S * k) == drops
    assert round(float(jaux["moe_drop_frac"]) * S * k) == drops
    for name in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=AUX_RTOL)


def test_pad_row_changes_which_token_drops():
    """Reference semantics, reproduced: the queue positions run over the
    flattened ``(B·T, k)`` choices, so right-padding row 0 (as a bucket
    pads it) puts the pad ahead of row 1's tokens and changes which of
    row 1's choices are kept, in both frameworks alike."""
    jcfg, tcfg, jp, tp, x = _moe_case("scatter", 0, 0.5, seed=3, B=2, T=6)
    # each row padded by 2 rows that route as row 1's first token does
    padded = np.concatenate([x, np.broadcast_to(x[1, 0], (2, 2, 64))], axis=1)
    keeps = []
    for a in (x, padded):
        xf = a.reshape(-1, 64)
        _, _, keep, _, _ = _ref_route(jp, jcfg, jnp.asarray(xf))
        t_keep = tmoe.route(tp, tcfg, torch.tensor(xf))[5].numpy()
        np.testing.assert_array_equal(t_keep, keep)
        keeps.append(keep.reshape(2, a.shape[1], -1)[1, :x.shape[1]])   # row 1's real tokens
    assert not np.array_equal(keeps[0], keeps[1])


def test_attn_moe_block_matches_reference(setup):
    """One attn_moe block (q/k norm): ``block_apply``'s output and aux."""
    s = setup
    blk_j, blk_t = s["jmodel"].unit[0], s["tmodel"].unit[0]
    jp = jax.tree.map(lambda a: a[0], s["jparams"]["unit"][0])
    tp = tlm._layer(s["tparams"]["unit"][0], 0)
    x = np.random.RandomState(4).randn(2, 9, s["jmodel"].d_model).astype(np.float32)
    jy, jaux = jax.jit(functools.partial(jblocks.block_apply, blk=blk_j))(jp, x=jnp.asarray(x))
    ty, taux = tblocks.block_apply(tp, blk_t, torch.tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL)
    assert set(taux) == set(jaux)
    assert round(float(taux["moe_drop_frac"]) * 36) == round(float(jaux["moe_drop_frac"]) * 36)
    for name in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=AUX_RTOL)


def test_forward_and_aux_match_reference(setup):
    """``lm.forward``'s logits and aux (summed over the 2 layers), and the
    teacher-forced decode with ``capacity_factor = E / top_k`` (no drop at
    any S) reproducing it."""
    s = setup
    toks = _tok(4, 2, 10, s["jmodel"].vocab)
    jlog, jaux = jax.jit(functools.partial(jlm.forward, cfg=s["jmodel"],
                                           compute_dtype=jnp.float32))(
        s["jparams"], inputs={"tokens": jnp.asarray(toks)})
    tlog, taux = tlm.forward(s["tparams"], s["tmodel"], torch.tensor(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    assert set(taux) == set(jaux) == set(tlm.AUX_KEYS)
    rows = toks.size * s["jmodel"].unit[0].moe.top_k
    assert round(float(taux["moe_drop_frac"]) * rows) == round(float(jaux["moe_drop_frac"]) * rows)
    for name in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), rtol=AUX_RTOL)
    m = s["tmodel"].unit[0].moe
    nodrop = dataclasses.replace(s["tmodel"], unit=(dataclasses.replace(
        s["tmodel"].unit[0], moe=dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k)),))
    full, faux = tlm.forward(s["tparams"], nodrop, torch.tensor(toks))
    assert float(faux["moe_drop_frac"]) == 0.0
    caches = tlm.init_caches(nodrop, 2, 10, torch.float32, "cpu")
    dec = []
    for t in range(10):
        lg, caches = tlm.decode_step(s["tparams"], nodrop, torch.tensor(toks[:, t:t + 1]),
                                     caches, torch.full((2,), t), torch.float32)
        dec.append(lg)
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), full.numpy(), atol=2e-4)


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_and_decode_steps_match_reference(setup, ragged):
    """Prefill (logits and K/V caches) then 4 decode steps: scalar pos
    (every row at T) or per-row pos (right-padded rows at their lengths)."""
    s = setup
    B, T = 3, 9
    toks = _tok(1, B, T, s["jmodel"].vocab)
    lens = np.array([9, 6, 8], np.int32)
    jlog, jc = _jprefill(s, toks)
    tlog, tc = tlm.prefill(s["tparams"], s["tmodel"], torch.tensor(toks), MAX_SEQ,
                           torch.float32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    step = jax.jit(functools.partial(jlm.decode_step, cfg=s["jmodel"],
                                     compute_dtype=jnp.float32))
    step_toks = _tok(2, 4, B, s["jmodel"].vocab)
    for k in range(4):
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


@pytest.mark.parametrize("paged", [False, True])
def test_verify_window_matches_reference(setup, paged):
    """A 3-token verify window per row after a prefill (its 6 tokens routed
    together), dense cache or pool (identity tables): logits and caches."""
    s = setup
    B, T, W = 2, 7, 3
    toks = _tok(5, B, T, s["jmodel"].vocab)
    win = _tok(6, B, W, s["jmodel"].vocab)
    pos = np.array([7, 5], np.int32)
    _, jc = _jprefill(s, toks)
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


def test_drafter_from_target_on_moe_trees_equals_reference(setup):
    """``DraftModel.from_target`` on an attn_moe tree: the same leaves as
    the reference's drafter, the unit's cut to one layer, the rest aliased."""
    from repro.serve import speculative as jsp
    from repro_torch.serve import speculative as tsp

    s = setup
    want = jsp.DraftModel.from_target(s["jparams"], s["jmodel"], 1)
    got = tsp.DraftModel.from_target(s["tparams"], s["tmodel"], 1)
    wflat = _flatten_with_paths(jax.device_get(want.params))[0]
    gflat = flatten_with_paths(got.params)
    assert list(gflat) == list(wflat)
    for k, w in wflat.items():
        np.testing.assert_array_equal(gflat[k].numpy(), np.asarray(w), err_msg=k)
    assert got.params["embed"] is s["tparams"]["embed"]
    wi = got.params["unit"][0]["moe"]["wi"]
    assert wi.untyped_storage().data_ptr() == \
        s["tparams"]["unit"][0]["moe"]["wi"].untyped_storage().data_ptr()


def test_serve_requests_equals_reference(setup):
    s = setup
    for eng in (s["jeng"], s["teng"]):
        eng.cfg = dataclasses.replace(eng.cfg, paged=False, spec_k=0)
    want = s["jeng"].serve_requests(s["reqs"], batch_size=6, seed=0)
    got = s["teng"].serve_requests(s["reqs"], batch_size=6, seed=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _serve_both(jeng, teng, reqs, budgets, cfg: dict):
    """The same continuous run on the JAX engine and the port's; their
    streams and counters equal.  Returns the port's ``(streams, stats)``."""
    res = []
    for eng in (jeng, teng):
        eng.cfg = dataclasses.replace(eng.cfg, **cfg)
        with jax.threefry_partitionable(True):      # the key chains the port derives
            outs = eng.serve_continuous(reqs, slots=SLOTS, chunk_steps=CHUNK, max_new=budgets)
        res.append((outs, eng.last_serve_stats))
    (want, wstats), (got, gstats) = res
    for g, w, m in zip(got, want, budgets):
        assert g.dtype == np.int32 and g.shape == (m,)
        np.testing.assert_array_equal(g, w)
    counters = {k: v for k, v in wstats.items() if k not in NOT_COMPARED}
    assert {k: gstats[k] for k in counters} == counters
    assert ("paged" in gstats) == ("paged" in wstats)
    if cfg.get("paged"):
        assert gstats["paged"] == wstats["paged"]
        assert gstats["paged"]["prefill_tokens_saved"] > 0
    if cfg.get("pool_blocks"):
        assert gstats["n_preemptions"] >= 1
    return got, gstats


def _mode(mode: str) -> dict:
    return {"paged": False, "paged_read": "shadow", "spec_k": 0, "pool_blocks": None,
            **MODES[mode]}


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_continuous_equals_reference(setup, mode):
    s = setup
    _serve_both(s["jeng"], s["teng"], s["reqs"], s["budgets"], _mode(mode))


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_continuous_sampled_equals_reference(setup, mode):
    """At ``SAMPLE_T`` the streams and counters equal the JAX engine's on
    every path, and the draws are not the argmax: at least half of the
    first tokens (drawn from the prompt alone) leave the greedy ones."""
    s = setup
    got, _ = _serve_both(s["jeng_hot"], s["teng_hot"], s["reqs"], s["budgets"], _mode(mode))
    s["teng"].cfg = dataclasses.replace(s["teng"].cfg, **_mode(mode))
    greedy = s["teng"].serve_continuous(s["reqs"], slots=SLOTS, chunk_steps=CHUNK,
                                        max_new=s["budgets"])
    assert sum(int(g[0] != w[0]) for g, w in zip(got, greedy)) >= len(got) / 2


@pytest.fixture(scope="module")
def framed():
    """The reduced olmoe between a GQA ``attn_mlp`` prologue block and an
    epilogue block (unstacked paged pools), in both frameworks."""
    def frame(model, block_cls):
        dense = block_cls("attn_mlp", attn=model.unit[0].attn, d_ff=48)
        return dataclasses.replace(model, prologue=(dense,), epilogue=(dense,))

    jmodel = frame(jconfigs.get_reduced(ARCH).model, jblocks.BlockCfg)
    tmodel = frame(tconfigs.get_reduced(ARCH).model, tblocks.BlockCfg)
    jparams = jlm.init_params(jax.random.PRNGKey(1), jmodel)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    base = dict(max_seq=MAX_SEQ, max_new_tokens=6, block_size=BLOCK, paged=True)
    return {"tmodel": tmodel, "jeng": JEngine(jparams, jmodel, JServeConfig(**base)),
            "teng": Engine(tparams, tmodel, ServeConfig(**base), device="cpu")}


@pytest.mark.parametrize("read", ["shadow", "step"])
def test_paged_prologue_and_epilogue_equal_reference(setup, framed, read, monkeypatch):
    """Prologue and epilogue pools are unstacked (blocks on axis 0): written
    back, copied on a prefix hit and gathered as the reference's are; the
    gathers are as many as ``chip_smoke.expected_launches`` counts."""
    from repro_torch.kernels import ops

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    calls, real = [], ops.gather_views

    def spy(cache, table, stacked=False):
        calls.append(stacked)
        return real(cache, table, stacked)

    monkeypatch.setattr(ops, "gather_views", spy)
    cfg = {"paged": True, "paged_read": read}
    _, stats = _serve_both(framed["jeng"], framed["teng"], setup["reqs"], setup["budgets"], cfg)
    want = chip_smoke.expected_launches(framed["tmodel"], stats, cfg, slots=SLOTS,
                                        chunk_steps=CHUNK)["gather_blocks"]
    assert len(calls) == want and calls.count(False) > 0


def test_cli_olmoe_runs_on_cpu(capsys):
    argv = ["--arch", ARCH, "--device", "cpu", "--engine", "continuous", "--paged",
            "--requests", "3", "--batch", "2", "--prompt-len", "6", "--max-new", "3",
            "--block-size", "4"]
    assert tserve.main(argv) == 0
    out = capsys.readouterr().out
    assert "[serve:continuous] 3 requests, 9 tokens" in out and "served=3/3" in out
