"""The port's Mamba2 (SSD) blocks and zamba2-1.2b against the JAX package,
fp32 on the CPU.

zamba2-1.2b ``reduced()`` (one unit of 2 mamba2 blocks and the shared
attention block, then 1 mamba2 block; d_model 64, d_state 16, chunk 128)
is built once in JAX (``lm.init_params``), carried across with
``params_from_jax``, and both sides run the same inputs.  What must hold:

* ``_causal_conv``, ``_ssd_chunked`` across 3 chunks with 1 and 2 B/C
  groups (at decays where ``exp()`` overflows above the diagonal),
  ``mamba2_forward`` with its decode state and ``mamba2_decode_step``:
  outputs and states within ``Y_ATOL``;
* the parameter tree leaf for leaf the reference's ``abstract_params``,
  ``shared`` and the unit's unread copy of the shared block included, with
  the reference's init kinds and scales;
* ``forward``, ``prefill`` (logits and every state and K/V leaf) and decode
  steps within ``LOGIT_ATOL`` (states ``Y_ATOL``);
* token streams and engine counters EQUAL to the JAX engine's: ragged
  ``serve_requests`` (``generate`` with per-row lengths) and dense
  ``serve_continuous``, greedy and sampled, so the pads a right-padded
  prompt feeds through the recurrence give the reference's streams;
* paging, speculative decoding and a prompt longer than the SSD chunk but
  not a multiple of it refused, as the reference refuses them.

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
from repro.models import ssm as JS
from repro.serve import speculative as jsp
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.convert import flatten_with_paths, params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as TS
from repro_torch.serve import speculative as tsp
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "zamba2-1.2b"
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
    # one ragged static bucket of 4; pad multiples 8 and 16 under continuous
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


def _mamba(s):
    """The first unit layer's Mamba2 parameters and config, both sides."""
    jp = jax.tree.map(lambda a: a[0], s["jparams"]["unit"][0]["mamba"])
    tp = {k: v[0] for k, v in s["tparams"]["unit"][0]["mamba"].items()}
    return jp, tp, s["jmodel"].unit[0].mamba, s["tmodel"].unit[0].mamba


def _close(got: dict, want: dict, atol):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), atol=atol, err_msg=k)


def test_causal_conv_matches_reference():
    rs = np.random.RandomState(1)
    x, w, b = rs.randn(2, 9, 12), rs.randn(4, 12), rs.randn(12)
    want = jax.jit(JS._causal_conv)(*(jnp.asarray(a, jnp.float32) for a in (x, w, b)))
    got = TS._causal_conv(*(torch.tensor(a, dtype=torch.float32) for a in (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=Y_ATOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_reference(groups):
    """3 chunks of 16; ``dt`` ~ 3 and ``A`` ~ -e make the in-chunk
    cumulative sums reach past -89, so ``exp(seg)`` is inf above the
    diagonal: the output must stay finite and equal the reference's.  Such
    steps make ``|y|`` ~ 30, so ``x`` is drawn at half scale to keep
    ``Y_ATOL`` a few fp32 ulps of it."""
    B, T, H, P, N, Q = 2, 48, 4, 8, 6, 16
    rs = np.random.RandomState(2 + groups)
    xh = (0.5 * rs.randn(B, T, H, P)).astype(np.float32)
    Bm, Cm = (rs.randn(B, T, groups, N).astype(np.float32) for _ in range(2))
    dt = (4.0 * rs.rand(B, T, H) + 1.0).astype(np.float32)
    A = -np.exp(rs.rand(H) + 0.5).astype(np.float32)
    assert float(np.max(np.abs(np.cumsum(dt[:, :Q] * A, axis=1)))) > 89   # exp overflows
    ssd = jax.jit(functools.partial(JS._ssd_chunked, chunk=Q, return_final=True))
    jy, jS = ssd(*(jnp.asarray(a) for a in (xh, Bm, Cm, dt, A)))
    ty, tS = TS._ssd_chunked(*(torch.tensor(a) for a in (xh, Bm, Cm, dt, A)), Q,
                             return_final=True)
    assert bool(torch.isfinite(ty).all())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL)
    np.testing.assert_allclose(tS.numpy(), np.asarray(jS), atol=Y_ATOL)


@pytest.mark.parametrize("T", [2, 12])
def test_mamba2_forward_and_state_match_reference(setup, T):
    """With ``T`` below the conv width the conv row is zero-padded on the
    left, as the reference's."""
    jp, tp, jcfg, tcfg = _mamba(setup)
    x = np.random.RandomState(4).randn(2, T, jcfg.d_model).astype(np.float32)
    fwd = jax.jit(functools.partial(JS.mamba2_forward, cfg=jcfg, return_state=True))
    jy, jst = fwd(jp, x=jnp.asarray(x))
    ty, tst = TS.mamba2_forward(tp, tcfg, torch.tensor(x), return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL)
    _close(tst, jst, Y_ATOL)


def test_mamba2_decode_step_matches_reference(setup):
    """Three steps from a random state, updated in place."""
    jp, tp, jcfg, tcfg = _mamba(setup)
    rs = np.random.RandomState(5)
    st = {"ssm": rs.randn(3, tcfg.n_heads, tcfg.d_state, tcfg.head_dim),
          "conv": rs.randn(3, tcfg.conv_width - 1, tcfg.conv_dim)}
    jst = {k: jnp.asarray(v, jnp.float32) for k, v in st.items()}
    tst = {k: torch.tensor(v, dtype=torch.float32) for k, v in st.items()}
    step = jax.jit(functools.partial(JS.mamba2_decode_step, cfg=jcfg))
    for _ in range(3):
        x = rs.randn(3, 1, jcfg.d_model).astype(np.float32)
        jy, jst = step(jp, x=jnp.asarray(x), state=jst)
        ty, got = TS.mamba2_decode_step(tp, tcfg, torch.tensor(x), tst)
        assert got is tst
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL)
        _close(tst, jst, Y_ATOL)


def test_param_tree_matches_reference(setup):
    """Leaf for leaf ``abstract_params``: the ``shared`` list and the unit's
    stacked copy of the shared block, which nothing reads (zeroing it
    leaves the logits as they were); ones/zeros leaves equal to the
    reference's init and normal leaves at its scale."""
    s = setup
    spec = flatten_with_paths(tlm.param_shapes(s["tmodel"]))
    abstract = _flatten_with_paths(jlm.abstract_params(s["jmodel"]))[0]
    assert list(spec) == list(abstract)
    assert "['shared']/[0]/['mlp']/['wi']" in spec and "['unit']/[2]/['attn']/['wq']" in spec
    jflat = _flatten_with_paths(jax.device_get(s["jparams"]))[0]
    assert list(flatten_with_paths(s["tparams"])) == list(jflat)
    for k, w in abstract.items():
        assert spec[k].shape == w.shape, k
        a = np.asarray(jflat[k])
        if spec[k].init in ("ones", "zeros"):
            np.testing.assert_array_equal(a, float(spec[k].init == "ones"), err_msg=k)
        elif a.size >= 1000:
            shape = w.shape[1:] if k.startswith("['unit']") else w.shape
            want = spec[k].scale or 1 / np.sqrt(np.prod(shape[:-1]))
            assert abs(a.std() / want - 1) < 0.1, (k, a.std(), want)
    toks = torch.tensor(np.random.RandomState(6).randint(0, 512, (1, 6)))
    before, _ = tlm.forward(s["tparams"], s["tmodel"], toks)
    unread = {**s["tparams"], "unit": list(s["tparams"]["unit"])}
    unread["unit"][2] = {k: {n: torch.zeros_like(t) for n, t in v.items()}
                         for k, v in unread["unit"][2].items()}
    after, _ = tlm.forward(unread, s["tmodel"], toks)
    assert torch.equal(before, after)


def test_forward_prefill_and_decode_match_reference(setup):
    """``forward``, ``prefill`` with every cache leaf (the Mamba2 states and
    the shared block's own K/V per repeat), then 3 per-row decode steps."""
    s = setup
    B, T = 2, 10
    toks = np.random.RandomState(7).randint(0, s["jmodel"].vocab, (B, T)).astype(np.int32)
    jlog, _ = jax.jit(functools.partial(jlm.forward, cfg=s["jmodel"],
                                        compute_dtype=jnp.float32))(
        s["jparams"], inputs={"tokens": jnp.asarray(toks)})
    tlog, taux = tlm.forward(s["tparams"], s["tmodel"], torch.tensor(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    jlog, jc = jax.jit(functools.partial(jlm.prefill, cfg=s["jmodel"], max_seq=MAX_SEQ,
                                         compute_dtype=jnp.float32))(
        s["jparams"], inputs={"tokens": jnp.asarray(toks)})
    tlog, tc = tlm.prefill(s["tparams"], s["tmodel"], torch.tensor(toks), MAX_SEQ,
                           torch.float32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    _close(flatten_with_paths(tc), _flatten_with_paths(jax.device_get(jc))[0], Y_ATOL)
    assert "['unit']/[0]/['ssm']" in flatten_with_paths(tc)
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
    """One right-padded bucket: the pads run through the recurrence on both
    sides, so the streams agree only if the port pads as the reference."""
    s = setup
    jeng, teng = _engines(s, mode)
    with jax.threefry_partitionable(True):
        want = jeng.serve_requests(s["reqs"], batch_size=4, seed=3)
    got = teng.serve_requests(s["reqs"], batch_size=4, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [b["prompt_len"] for b in teng.last_serve_stats["buckets"]] == [11]


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
    if mode == "sampled":       # the draws leave the greedy tokens
        greedy = _engines(s, "greedy")[1].serve_continuous(
            s["reqs"], slots=SLOTS, chunk_steps=CHUNK, max_new=s["budgets"])
        assert sum(int((a != b).sum()) for a, b in zip(got, greedy)) > 0


def test_paging_speculation_and_ragged_chunks_refused_as_the_reference(setup):
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
    eng = Engine(s["tparams"], s["tmodel"], ServeConfig(max_seq=16, paged=True, block_size=4),
                 device="cpu")
    with pytest.raises(NotImplementedError, match="paged KV needs full-attention"):
        eng.serve_continuous([np.ones(3, np.int32)], slots=1, max_new=2)
    # a sequence past the chunk (128) that is not a multiple of it: the
    # reference's reshape fails, the port says why
    jp, tp, jcfg, tcfg = _mamba(s)
    x = np.zeros((1, tcfg.chunk + 2, tcfg.d_model), np.float32)
    with pytest.raises(TypeError):
        jax.jit(functools.partial(JS.mamba2_forward, cfg=jcfg))(jp, x=jnp.asarray(x))
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        TS.mamba2_forward(tp, tcfg, torch.tensor(x))
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        tlm.forward(s["tparams"], s["tmodel"], torch.zeros((1, tcfg.chunk + 2), dtype=torch.long))


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


def test_cli_zamba2_runs_on_cpu(capsys):
    argv = ["--arch", ARCH, "--device", "cpu", "--engine", "continuous", "--requests", "3",
            "--batch", "2", "--prompt-len", "6", "--max-new", "3"]
    assert tserve.main(argv) == 0
    out = capsys.readouterr().out
    assert "[serve:continuous] 3 requests, 9 tokens" in out and "served=3/3" in out


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("which", ["config", "reduced"])
def test_config_matches_reference(which):
    """``config()`` and ``reduced()`` equal the reference's field by field,
    the blocks' attention and Mamba2 configs with their derived sizes."""
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
            if gb.mamba is not None:
                m, w = gb.mamba, wb.mamba
                assert (m.d_inner, m.n_heads, m.conv_dim) == (w.d_inner, w.n_heads, w.conv_dim)
    assert gm.n_layers == wm.n_layers
