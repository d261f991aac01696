"""The port's mLSTM and sLSTM blocks and xlstm-1.3b against the JAX
package, fp32 on the CPU.

xlstm-1.3b ``reduced()`` (one unit of 2 mLSTM blocks and 1 sLSTM block;
d_model 64, 2 heads: mLSTM head_dim 64, sLSTM head_dim 32) is built once in
JAX (``lm.init_params``), carried across with ``params_from_jax``, and both
sides run the same inputs.  What must hold:

* the recurrent and the chunked mLSTM cores, ``mlstm_forward`` under both
  impls with its decode state, ``mlstm_decode_step``, ``slstm_forward``
  with its state and ``slstm_decode_step``: outputs and states within
  ``Y_ATOL``; the port's chunked core within ``Y_ATOL`` of its recurrent
  one;
* the parameter tree leaf for leaf the reference's ``abstract_params``,
  with its init kinds and scales;
* ``forward``, ``prefill`` and decode steps within ``LOGIT_ATOL`` (states
  ``Y_ATOL``);
* token streams and engine counters EQUAL to the JAX engine's: ragged
  ``serve_requests`` and dense ``serve_continuous``, greedy and sampled;
* paging and speculative decoding refused as the reference refuses them.

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
from repro.models import lm as jlm
from repro.models import xlstm as JX
from repro.serve import speculative as jsp
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.convert import flatten_with_paths, params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import xlstm as TX
from repro_torch.serve import speculative as tsp
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "xlstm-1.3b"
Y_ATOL = 1e-5
LOGIT_ATOL = 1e-4
MAX_SEQ = 24
SLOTS, CHUNK = 3, 3
TEMPS = {"greedy": 0.0, "sampled": 20.0}
NOT_COMPARED = {"wall_s", "request_latency_s", "compiles", "mesh_shape"}


@pytest.fixture(scope="module")
def setup():
    jmodel = jconfigs.get_reduced(ARCH).model
    tmodel = tconfigs.get_reduced(ARCH).model
    jparams = jlm.init_params(jax.random.PRNGKey(0), jmodel)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    rs = np.random.RandomState(0)
    reqs = [rs.randint(1, jmodel.vocab, L).astype(np.int32) for L in (5, 11, 3, 9)]
    budgets = [5, 2, 4, 3]
    return {"jmodel": jmodel, "tmodel": tmodel, "jparams": jparams, "tparams": tparams,
            "reqs": reqs, "budgets": budgets, "engines": {}}


def _engines(s, mode):
    """The JAX engine and the port's at ``TEMPS[mode]``, built once."""
    if mode not in s["engines"]:
        base = dict(max_seq=MAX_SEQ, max_new_tokens=5, temperature=TEMPS[mode])
        s["engines"][mode] = (JEngine(s["jparams"], s["jmodel"], JServeConfig(**base)),
                              Engine(s["tparams"], s["tmodel"], ServeConfig(**base),
                                     device="cpu"))
    return s["engines"][mode]


def _block(s, i, key):
    """Unit block ``i``'s ``key`` parameters (layer 0) and config, both sides."""
    jp = jax.tree.map(lambda a: a[0], s["jparams"]["unit"][i][key])
    tp = {k: v[0] for k, v in s["tparams"]["unit"][i][key].items()}
    return jp, tp, s["jmodel"].unit[i].xlstm, s["tmodel"].unit[i].xlstm


def _close(got, want, atol):
    got, want = dict(got), dict(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), atol=atol, err_msg=k)


def _core_inputs(seed, B=2, T=32, H=2, D=16):
    """q, k, v at half scale, as the model's projections give them (at unit
    scale a small ``|n.q|`` makes ``|y|`` ~ 40, where ``Y_ATOL`` is one ulp)."""
    rs = np.random.RandomState(seed)
    q, k, v = ((0.5 * rs.randn(B, T, H, D)).astype(np.float32) for _ in range(3))
    i_pre = (2.0 * rs.randn(B, T, H)).astype(np.float32)
    f_pre = (2.0 * rs.randn(B, T, H) + 1.0).astype(np.float32)
    return q, k, v, i_pre, f_pre


def test_mlstm_cores_match_reference():
    """The recurrent core and the chunked one (4 chunks of 8) against the
    reference's, outputs and final ``(C, n, m)``; the port's chunked core
    against its recurrent one."""
    ins = _core_inputs(1)
    jr = jax.jit(JX._mlstm_core)(*(jnp.asarray(a) for a in ins))
    jc = jax.jit(functools.partial(JX._mlstm_core_chunked, chunk=8))(
        *(jnp.asarray(a) for a in ins))
    tr = TX._mlstm_core(*(torch.tensor(a) for a in ins))
    tc = TX._mlstm_core_chunked(*(torch.tensor(a) for a in ins), 8)
    for (ty, tst), (jy, jst) in ((tr, jr), (tc, jc)):
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL)
        for t, j in zip(tst, jst):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=Y_ATOL)
    np.testing.assert_allclose(tc[0].numpy(), tr[0].numpy(), atol=Y_ATOL)
    for a, b in zip(tc[1], tr[1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=Y_ATOL)


@pytest.mark.parametrize("impl,T", [("recurrent", 2), ("recurrent", 12), ("chunked", 192)])
def test_mlstm_forward_and_state_match_reference(setup, impl, T):
    """Chunked takes 3 chunks of 64 (``T % chunk == 0`` and ``T > chunk``);
    ``T`` below the conv width zero-pads the conv row on the left."""
    jp, tp, jcfg, tcfg = _block(setup, 0, "mlstm")
    jcfg, tcfg = (dataclasses.replace(c, mlstm_impl=impl) for c in (jcfg, tcfg))
    x = np.random.RandomState(2).randn(2, T, jcfg.d_model).astype(np.float32)
    fwd = jax.jit(functools.partial(JX.mlstm_forward, cfg=jcfg, return_state=True))
    jy, jst = fwd(jp, x=jnp.asarray(x))
    ty, tst = TX.mlstm_forward(tp, tcfg, torch.tensor(x), return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL)
    _close(tst, jst, Y_ATOL)


def test_mlstm_decode_step_matches_reference(setup):
    """Three steps from a prefill's state, updated in place."""
    jp, tp, jcfg, tcfg = _block(setup, 0, "mlstm")
    rs = np.random.RandomState(3)
    x = rs.randn(3, 7, jcfg.d_model).astype(np.float32)
    _, jst = jax.jit(functools.partial(JX.mlstm_forward, cfg=jcfg, return_state=True))(
        jp, x=jnp.asarray(x))
    tst = {k: torch.tensor(np.asarray(v)) for k, v in jst.items()}
    step = jax.jit(functools.partial(JX.mlstm_decode_step, cfg=jcfg))
    for _ in range(3):
        x = rs.randn(3, 1, jcfg.d_model).astype(np.float32)
        jy, jst = step(jp, x=jnp.asarray(x), state=jst)
        ty, got = TX.mlstm_decode_step(tp, tcfg, torch.tensor(x), tst)
        assert got is tst
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL)
        _close(tst, jst, Y_ATOL)


def test_slstm_forward_state_and_decode_match_reference(setup):
    """``slstm_forward`` with its state (head width ``d_model / H``), then
    three decode steps from it, updated in place."""
    jp, tp, jcfg, tcfg = _block(setup, 2, "slstm")
    rs = np.random.RandomState(4)
    x = rs.randn(2, 9, jcfg.d_model).astype(np.float32)
    jy, jst = jax.jit(functools.partial(JX.slstm_forward, cfg=jcfg, return_state=True))(
        jp, x=jnp.asarray(x))
    ty, tst = TX.slstm_forward(tp, tcfg, torch.tensor(x), return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL)
    _close(tst, jst, Y_ATOL)
    assert tst["h"].shape == (2, tcfg.n_heads, tcfg.d_model // tcfg.n_heads)
    step = jax.jit(functools.partial(JX.slstm_decode_step, cfg=jcfg))
    for _ in range(3):
        x = rs.randn(2, 1, jcfg.d_model).astype(np.float32)
        jy, jst = step(jp, x=jnp.asarray(x), state=jst)
        ty, got = TX.slstm_decode_step(tp, tcfg, torch.tensor(x), tst)
        assert got is tst
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL)
        _close(tst, jst, Y_ATOL)


def test_param_tree_matches_reference(setup):
    """Leaf for leaf ``abstract_params``; ones/zeros leaves equal to the
    reference's init (``b_f`` ones), normal leaves at its scale (``w_i``,
    ``w_f``, the sLSTM ``w_*``/``r_*`` 0.02, ``conv_w`` 0.5)."""
    s = setup
    spec = flatten_with_paths(tlm.param_shapes(s["tmodel"]))
    abstract = _flatten_with_paths(jlm.abstract_params(s["jmodel"]))[0]
    assert list(spec) == list(abstract)
    jflat = _flatten_with_paths(jax.device_get(s["jparams"]))[0]
    assert list(flatten_with_paths(s["tparams"])) == list(jflat)
    for k, w in abstract.items():
        assert spec[k].shape == w.shape, k
        a = np.asarray(jflat[k])
        if spec[k].init in ("ones", "zeros"):
            np.testing.assert_array_equal(a, float(spec[k].init == "ones"), err_msg=k)
        elif a.size >= 1000:
            want = spec[k].scale or 1 / np.sqrt(np.prod(w.shape[1:-1]))
            assert abs(a.std() / want - 1) < 0.1, (k, a.std(), want)


def test_forward_prefill_and_decode_match_reference(setup):
    s = setup
    B, T = 2, 10
    toks = np.random.RandomState(7).randint(0, s["jmodel"].vocab, (B, T)).astype(np.int32)
    jlog, _ = jax.jit(functools.partial(jlm.forward, cfg=s["jmodel"],
                                        compute_dtype=jnp.float32))(
        s["jparams"], inputs={"tokens": jnp.asarray(toks)})
    tlog, _ = tlm.forward(s["tparams"], s["tmodel"], torch.tensor(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    jlog, jc = jax.jit(functools.partial(jlm.prefill, cfg=s["jmodel"], max_seq=MAX_SEQ,
                                         compute_dtype=jnp.float32))(
        s["jparams"], inputs={"tokens": jnp.asarray(toks)})
    tlog, tc = tlm.prefill(s["tparams"], s["tmodel"], torch.tensor(toks), MAX_SEQ,
                           torch.float32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    _close(flatten_with_paths(tc), _flatten_with_paths(jax.device_get(jc))[0], Y_ATOL)
    step = jax.jit(functools.partial(jlm.decode_step, cfg=s["jmodel"],
                                     compute_dtype=jnp.float32))
    lens = np.array([T, 6], np.int32)
    for k in range(3):
        tok = np.random.RandomState(10 + k).randint(0, s["jmodel"].vocab, (B, 1))
        jlog, jc = step(s["jparams"], tokens=jnp.asarray(tok, jnp.int32), caches=jc,
                        pos=jnp.asarray(lens + k))
        tlog, tc = tlm.decode_step(s["tparams"], s["tmodel"], torch.tensor(tok), tc,
                                   torch.tensor(lens + k), torch.float32)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    _close(flatten_with_paths(tc), _flatten_with_paths(jax.device_get(jc))[0], Y_ATOL)


@pytest.mark.parametrize("mode", list(TEMPS))
def test_serve_requests_ragged_equals_reference(setup, mode):
    s = setup
    jeng, teng = _engines(s, mode)
    with jax.threefry_partitionable(True):
        want = jeng.serve_requests(s["reqs"], batch_size=4, seed=3)
    got = teng.serve_requests(s["reqs"], batch_size=4, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", list(TEMPS))
def test_serve_continuous_dense_equals_reference(setup, mode):
    s = setup
    res = []
    for eng in _engines(s, mode):
        with jax.threefry_partitionable(True):
            outs = eng.serve_continuous(s["reqs"], slots=SLOTS, chunk_steps=CHUNK,
                                        max_new=s["budgets"], seed=1)
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
    for jfn, tfn in (
            (lambda: jlm.init_paged_caches(s["jmodel"], 9, 4, jnp.float32),
             lambda: tlm.init_paged_caches(s["tmodel"], 9, 4, torch.float32, "cpu")),
            (lambda: jsp.DraftModel.from_target(s["jparams"], s["jmodel"], 1),
             lambda: tsp.DraftModel.from_target(s["tparams"], s["tmodel"], 1))):
        with pytest.raises(NotImplementedError) as want:
            jfn()
        with pytest.raises(NotImplementedError) as got:
            tfn()
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="speculative verify needs"):
        tlm.verify_window(s["tparams"], s["tmodel"], torch.zeros((1, 2), dtype=torch.long),
                          tlm.init_caches(s["tmodel"], 1, 8, torch.float32, "cpu"),
                          torch.zeros(1, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="speculative drafter needs"):
        Engine(s["tparams"], s["tmodel"], ServeConfig(spec_k=2), device="cpu")
    argv = ["--arch", ARCH, "--engine", "continuous", "--requests", "2", "--batch", "1",
            "--prompt-len", "4", "--max-new", "2", "--spec-k", "2"]
    assert tserve.main(argv + ["--device", "cpu"]) == 2
    with pytest.raises(NotImplementedError, match="paged KV needs full-attention"):
        tserve.main(argv[:-2] + ["--paged", "--block-size", "4", "--device", "cpu"])
    assert jserve.main(argv) == 2


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("which", ["config", "reduced"])
def test_config_matches_reference(which):
    """``config()`` and ``reduced()`` equal the reference's field by field
    (the xLSTM config with its derived sizes); the full config's matrix
    memory is 705 MB per request."""
    want = getattr(jconfigs, f"get_{which}")(ARCH)
    got = getattr(tconfigs, f"get_{which}")(ARCH)
    for f in ("family", "sub_quadratic", "source", "notes"):
        assert getattr(got, f) == getattr(want, f), f
    gm, wm = got.model, want.model
    for name, v in _fields(gm).items():
        if name not in ("unit", "prologue", "epilogue", "shared"):
            assert v == getattr(wm, name), name
            continue
        for gb, wb in zip(v, getattr(wm, name), strict=True):
            for bn, bv in _fields(gb).items():
                if dataclasses.is_dataclass(bv):
                    assert _fields(bv) == {k: getattr(getattr(wb, bn), k) for k in _fields(bv)}
                else:
                    assert bv == getattr(wb, bn), (name, bn)
            x, w = gb.xlstm, wb.xlstm
            assert (x.d_inner, x.head_dim) == (w.d_inner, w.head_dim)
    assert gm.n_layers == wm.n_layers
    if which == "config":
        c = flatten_with_paths(tlm.init_caches(gm, 1, 1, torch.float32, "meta"))
        assert sum(v.numel() * 4 for k, v in c.items() if "['C']" in k) == 42 * 4 * 1024 ** 2 * 4
