"""Sampling at temperature > 0 in the port against the JAX package, on the CPU.

Every JAX call, the reference engines' construction included, runs inside
the scoped ``with jax.threefry_partitionable(True):`` (``_ref``): the
scheme ``serve/threefry.py`` implements, jax's default from 0.5.0 on.  No
test sets JAX config or environment variables of its own, so nothing here
outlives a test.

The threefry port: ``threefry2x32`` (Random123's known answers),
``prng_key``, ``fold_in``, ``split``, ``random_bits_u32``, ``uniform`` and
``split_chain`` must be EQUAL to ``jax.random`` bit for bit, on torch
tensors and on the host's numpy keys.  Gumbel noise goes through ``log``,
which XLA and torch round differently by an ulp: it is held within
``GUMBEL_ATOL``.  ``categorical`` and ``sample_tokens`` draw equal tokens on
hypothesis-drawn logits at several temperatures.

The serving paths: reduced kanformer-100m, parameters made in JAX and
carried across with ``params_from_jax``, fp32.  On random weights the tied
unembedding scores a row's input token ~40 above the rest, far beyond the
noise at T ~ 1, so every draw would be the argmax; the embedding table is
scaled by ``EMBED_SCALE`` on both sides, which brings the logit gaps to the
noise's scale, and every serving test asserts that at least
``MIN_SAMPLED_SHARE`` of its tokens differ from the argmax of their own
logits.  Each row's chain is ``fold_in(PRNGKey(seed), request_id)`` split
once per token on both sides, so the streams of ``generate``,
``serve_requests``, ``serve_continuous`` (dense, paged shadow and step
reads, prefix caching off, EOS, a pool that preempts) and of speculative
windows (``spec_k`` 1 and 2) must be EQUAL to the JAX engine's, and with
them every counter the reference exports, ``last_serve_stats["spec"]``
included.  The one exception a test would report is a near-tie: a first
divergence where the perturbed top-2 gap is below twice the logits'
tolerance over T plus the noise's.  The file counts those and asserts, in
its last test, that there were none.
"""

import dataclasses
from pathlib import Path

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.serve import speculative as jsp
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.serve import speculative as tsp
from repro_torch.serve import threefry
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "kanformer-100m"
MAX_SEQ, BLOCK, SLOTS, CHUNK = 32, 4, 3, 3
EMBED_SCALE = 0.07
TEMPS = [0.7, 1.0]
# Gumbel noise lies in [-4.5, 16.7] (float32, mode "low"): 4 float32 ulps at
# 16 are 7.6e-6.  The logits of the two frameworks agree within LOGIT_ATOL.
GUMBEL_ATOL, LOGIT_ATOL = 1e-5, 1e-4
MIN_SAMPLED_SHARE = 0.25
# the reference's keys that describe its wall clock, JAX tracing or meshes
NOT_COMPARED = {"wall_s", "request_latency_s", "compiles", "mesh_shape", "paged"}
MODES = {
    "dense": {},
    "paged_shadow": {"paged": True},
    "paged_step": {"paged": True, "paged_read": "step"},
    "prefix_off": {"paged": True, "prefix_caching": False},
    "eos": {"paged": True},
    "tight_pool": {"paged": True, "pool_blocks": 12},
}
KNOWN_ANSWERS = [  # Random123 kat_vectors, threefry2x32_20: key, counter, output
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]
SHAPES = [(7,), (3, 2000), (2, 3, 5), (1,), (4, 1), (33,)]
seeds = st.integers(-(2 ** 31), 2 ** 40)           # seeds of 2**32 and above too
words = st.integers(0, 2 ** 32 - 1)
TIES: list = []                                     # near-tie divergences seen


def _ref(fn, *args, **kw):
    with jax.threefry_partitionable(True):
        return fn(*args, **kw)


def _np(fn, *args, **kw):
    return np.asarray(_ref(fn, *args, **kw))


def _key(seed: int, data: int):
    """The same key on both sides: fold_in(PRNGKey(seed), data), as the
    reference's uint32 pair and the port's int64 tensor."""
    want = _np(lambda: jax.random.fold_in(jax.random.PRNGKey(seed), data))
    return want, threefry.fold_in(threefry.prng_key(seed), data)


# ---------------------------------------------------------------------------
# the threefry port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,ctr,want", KNOWN_ANSWERS)
def test_threefry2x32_known_answers(key, ctr, want):
    from jax._src.prng import threefry_2x32

    t = [torch.tensor(v, dtype=torch.int64) for v in key + ctr]
    assert tuple(int(w) for w in threefry.threefry2x32(*t)) == want
    h = [np.asarray([v], np.int64) for v in key + ctr]             # host words
    assert tuple(int(w[0]) for w in threefry.threefry2x32(*h)) == want
    ref = np.asarray(threefry_2x32(np.asarray(key, np.uint32), np.asarray(ctr, np.uint32)))
    assert tuple(int(w) for w in ref) == want


@pytest.mark.parametrize("seed", [0, 1, -1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5, -(2 ** 40)])
def test_prng_key_equals_reference(seed):
    got = threefry.prng_key(seed)
    assert got.dtype == torch.int64 and got.shape == (2,)
    np.testing.assert_array_equal(got.numpy(), _np(jax.random.PRNGKey, seed).astype(np.int64))


@hypothesis.settings(max_examples=30, deadline=None, derandomize=True)
@hypothesis.given(seed=seeds, data=words, num=st.integers(1, 9))
def test_fold_in_and_split_equal_reference(seed, data, num):
    want, got = _key(seed, data)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(threefry.split(got, num).numpy(),
                                  _np(jax.random.split, want, num))
    host = threefry.fold_in(threefry.prng_key(seed).numpy(), data)     # the host's keys
    assert host.dtype == np.int64 and np.array_equal(host, want)
    assert np.array_equal(threefry.split(host), _np(jax.random.split, want))


@hypothesis.settings(max_examples=20, deadline=None, derandomize=True)
@hypothesis.given(seed=seeds, rids=st.lists(words, min_size=1, max_size=6))
def test_row_key_pairs_equal_the_reference_vmap(seed, rids):
    """The engine's ``_row_key_pairs``: one fold_in and split per request
    id, batched, equal to the reference's vmap, on host and torch keys."""
    base = jax.random.PRNGKey(seed)
    want = _np(jax.vmap(lambda r: jax.random.split(jax.random.fold_in(base, r))),
               jnp.asarray(np.asarray(rids, np.uint32)))
    host = Engine._row_key_pairs(threefry.prng_key(seed).numpy(), rids)
    assert host.shape == (len(rids), 2, 2) and np.array_equal(host, want)
    dev = threefry.split(threefry.fold_in(threefry.prng_key(seed), torch.tensor(rids)))
    np.testing.assert_array_equal(dev.numpy(), want)


@hypothesis.settings(max_examples=20, deadline=None, derandomize=True)
@hypothesis.given(seed=seeds, data=words, shape=st.sampled_from(SHAPES))
def test_random_bits_equal_reference(seed, data, shape):
    want, key = _key(seed, data)
    got = threefry.random_bits_u32(key, shape)
    assert got.dtype == torch.int64 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), _np(jax.random.bits, want, shape, jnp.uint32))


def test_batched_random_bits_are_per_key():
    keys = threefry.split(threefry.prng_key(3), 4)
    got = threefry.random_bits_u32(keys, (5, 7))
    want = _np(jax.vmap(lambda k: jax.random.bits(k, (5, 7), jnp.uint32)),
               keys.numpy().astype(np.uint32))
    np.testing.assert_array_equal(got.numpy(), want)


@hypothesis.settings(max_examples=30, deadline=None, derandomize=True)
@hypothesis.given(seed=seeds, data=words, shape=st.sampled_from(SHAPES),
                  bounds=st.sampled_from([(0.0, 1.0), (1.1754944e-38, 1.0), (-0.3, 2.7),
                                          (-5.0, -1.1), (1e-3, 7e5)]))
def test_uniform_equals_reference_bitwise(seed, data, shape, bounds):
    want, key = _key(seed, data)
    got = threefry.uniform(key, shape, *bounds)
    ref = _np(jax.random.uniform, want, shape, minval=bounds[0], maxval=bounds[1])
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(torch.int32).numpy(), ref.view(np.int32))


@hypothesis.settings(max_examples=10, deadline=None, derandomize=True)
@hypothesis.given(seed=seeds, data=words)
def test_gumbel_within_tolerance(seed, data):
    """The port's noise within ``GUMBEL_ATOL`` of the reference's, and of
    ``-log(-log(u))`` taken in float64 on the same (bit-equal) uniforms,
    so that a miss says which side drifted."""
    want, key = _key(seed, data)
    got = threefry.gumbel(key, (3, 4000))
    ref = _np(jax.random.gumbel, want, (3, 4000))
    u = threefry.uniform(key, (3, 4000), float(np.finfo(np.float32).tiny), 1.0)
    exact = -np.log(-np.log(u.double().numpy()))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    drift = {"port": float(np.abs(got.numpy() - exact).max()),
             "reference": float(np.abs(ref - exact).max())}
    assert drift["port"] <= GUMBEL_ATOL, drift
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=GUMBEL_ATOL, err_msg=str(drift))


@hypothesis.settings(max_examples=12, deadline=None, derandomize=True)
@hypothesis.given(seed=st.integers(0, 2 ** 31 - 1), scale=st.sampled_from([0.5, 3.0, 20.0]),
                  T=st.sampled_from([0.3, 0.7, 1.0, 2.5, 30.0]), vocab=st.sampled_from([2, 97, 512]))
def test_categorical_and_sample_tokens_equal_reference(seed, scale, T, vocab):
    """``sample_tokens`` against the reference's (per-row ``categorical``
    at ``logits / T``), and ``threefry.categorical`` against
    ``jax.random.categorical``; a draw that is a near-tie of the perturbed
    scores (only the noise differs, within ``GUMBEL_ATOL``) is left out of
    the comparison.  Every row alone draws what it draws in the batch."""
    rs = np.random.RandomState(seed)
    logits = (rs.standard_normal((16, vocab)) * scale).astype(np.float32)
    keys = Engine._row_key_pairs(threefry.prng_key(seed).numpy(), np.arange(16))[:, 1]
    lg, tkeys = torch.from_numpy(logits), torch.as_tensor(keys)
    want = _np(jsp.sample_tokens, jnp.asarray(logits), jnp.asarray(keys.astype(np.uint32)), T)
    got = tsp.sample_tokens(lg, tkeys, T)
    assert got.dtype == torch.int32
    gap = tsp.perturbed_top2_gap(lg, threefry.gumbel(tkeys, (vocab,)), T).numpy()
    tie = gap < 2 * GUMBEL_ATOL                     # the logits are the same array
    np.testing.assert_array_equal(got.numpy()[~tie], want[~tie])
    for r in (0, 15):
        assert tsp.sample_tokens(lg[r:r + 1], tkeys[r:r + 1], T).item() == got[r].item()
    np.testing.assert_array_equal(tsp.sample_tokens(lg, None, 0.0).numpy(), logits.argmax(-1))
    direct = threefry.categorical(tkeys, lg)
    want_c = _np(jax.vmap(jax.random.categorical), jnp.asarray(keys.astype(np.uint32)),
                 jnp.asarray(logits))
    np.testing.assert_array_equal(direct.numpy()[~tie], want_c[~tie])


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_split_chain_equals_reference(n):
    keys = Engine._row_key_pairs(threefry.prng_key(7).numpy(), np.arange(3))[:, 0]   # (3, 2)
    jk, jc = (np.asarray(a) for a in _ref(jsp.split_chain, jnp.asarray(keys.astype(np.uint32)),
                                          n))
    kts, chains = tsp.split_chain(keys, n)
    assert kts.shape == (3, n, 2) and chains.shape == (3, n + 1, 2)
    assert np.array_equal(kts, jk) and np.array_equal(chains, jc)
    tk, tc = tsp.split_chain(torch.as_tensor(keys), n)
    np.testing.assert_array_equal(tk.numpy(), jk)
    np.testing.assert_array_equal(tc.numpy(), jc)


def test_chip_smoke_golden_values_are_jaxs(monkeypatch):
    """The constants ``chip_smoke.py`` holds the card to (it cannot import
    JAX) are ``jax.random``'s, and the port meets them on the CPU."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    f = _ref(lambda: jax.random.fold_in(jax.random.PRNGKey(42), 7))
    want = {"prng_key": [_np(jax.random.PRNGKey, s).tolist() for s in (0, 42, 2 ** 32 + 5)],
            "fold_in": np.asarray(f).tolist(), "split": _np(jax.random.split, f, 3).tolist(),
            "bits": _np(jax.random.bits, f, (6,), jnp.uint32).tolist(),
            "uniform": _np(jax.random.uniform, f, (4,)).view(np.uint32).tolist(),
            "uniform_ab": _np(jax.random.uniform, f, (4,), minval=-0.3, maxval=2.7)
            .view(np.uint32).tolist()}
    assert cs.THREEFRY_GOLDEN == want
    np.testing.assert_allclose(cs.THREEFRY_GOLDEN_GUMBEL, _np(jax.random.gumbel, f, (4,)),
                               rtol=0, atol=1e-7)
    out = cs.check_threefry(torch, np, device="cpu")
    assert out["bits_equal_cpu"] and out["golden"] == len(want)


# ---------------------------------------------------------------------------
# the serving paths: one module-scoped fixture, one engine pair per T
# ---------------------------------------------------------------------------


def _scaled(params):
    return {**params, "embed": {"table": params["embed"]["table"] * EMBED_SCALE}}


@pytest.fixture(scope="module")
def setup():
    jmodel = jconfigs.get_reduced(ARCH).model
    tmodel = tconfigs.get_reduced(ARCH).model
    jparams = _ref(lambda: _scaled(jlm.init_params(jax.random.PRNGKey(0), jmodel)))
    rs = np.random.RandomState(0)
    common = rs.randint(1, jmodel.vocab, 2 * BLOCK).astype(np.int32)
    reqs = []
    for i in range(10):
        r = rs.randint(1, jmodel.vocab, int(rs.randint(3, 14))).astype(np.int32)
        reqs.append(np.concatenate([common, r]) if i % 2 else r)
    budgets = [int(b) for b in rs.randint(1, 9, len(reqs))]
    return {"jmodel": jmodel, "tmodel": tmodel, "jparams": jparams,
            "tparams": params_from_jax(jax.device_get(jparams), device="cpu"),
            "reqs": reqs, "budgets": budgets, "engines": {}, "runs": {}, "eos": {}}


def _engines(s, T):
    """One JAX and one port engine per temperature (the JAX engine's
    compiled programs read the temperature when they are traced); both
    carry a 1-layer drafter, used when ``spec_k >= 1``."""
    if T not in s["engines"]:
        base = dict(max_seq=MAX_SEQ, max_new_tokens=8, block_size=BLOCK, spec_k=1,
                    temperature=T)
        s["engines"][T] = (_ref(JEngine, s["jparams"], s["jmodel"], JServeConfig(**base)),
                           Engine(s["tparams"], s["tmodel"], ServeConfig(**base), device="cpu"))
    return s["engines"][T]


def _logits(s, prompt, stream):
    """The port's logits that predict each token of ``stream``,
    teacher-forced after ``prompt``: ``(len(stream), vocab)``."""
    seq = np.concatenate([prompt, stream[:-1]]).astype(np.int64)
    logits, _ = tlm.prefill(s["tparams"], s["tmodel"], torch.as_tensor(seq[None]), len(seq))
    return logits[0, len(prompt) - 1:]


def _step_key(seed: int, rid: int, j: int) -> np.ndarray:
    """The sampling key of token ``j`` of request ``rid``'s chain."""
    pair = Engine._row_key_pairs(threefry.prng_key(seed).numpy(), [rid])[0]
    if j == 0:
        return pair[1]
    return tsp.split_chain(pair[None, 0], j)[0][0, j - 1]


def _assert_streams_equal(s, T, prompts, rids, got, want, seed=0) -> bool:
    """Streams equal, unless the first divergence is a near-tie of the
    perturbed scores there (counted in ``TIES``); returns whether every
    stream was equal."""
    equal = True
    for p, rid, g, w in zip(prompts, rids, got, want):
        assert g.dtype == np.int32 and g.shape == w.shape
        diff = np.nonzero(g != w)[0]
        if not diff.size:
            continue
        j = int(diff[0])
        lg = _logits(s, p, w[: j + 1])[j:j + 1]
        noise = threefry.gumbel(torch.as_tensor(_step_key(seed, int(rid), j))[None],
                                lg.shape[-1:])
        gap = float(tsp.perturbed_top2_gap(lg, noise, T)[0])
        TIES.append((int(rid), j, gap))
        assert gap < 2 * (GUMBEL_ATOL + LOGIT_ATOL / T), (rid, j, gap)
        equal = False
    return equal


def _assert_sampled(s, prompts, streams, eos=-1):
    """At least ``MIN_SAMPLED_SHARE`` of the sampled tokens (up to and
    including EOS) differ from the argmax of their own logits."""
    n = off = 0
    for p, out in zip(prompts, streams):
        toks = list(out)
        if eos >= 0 and eos in toks:
            toks = toks[: toks.index(eos) + 1]
        am = _logits(s, p, np.asarray(toks, np.int32)).argmax(-1).numpy()
        off += int((am != np.asarray(toks)).sum())
        n += len(toks)
    assert off / n >= MIN_SAMPLED_SHARE, (off, n)


def _padded(seed, lens, vocab):
    rs = np.random.RandomState(seed)
    prompts = np.zeros((len(lens), max(lens)), np.int32)
    for b, L in enumerate(lens):
        prompts[b, :L] = rs.randint(1, vocab, L)
    return prompts, np.asarray(lens, np.int32)


@pytest.mark.parametrize("T", TEMPS)
def test_generate_sampled_equals_reference(setup, T):
    """Ragged rows with their own request ids and seed, the scalar-position
    path, EOS latching; a row served alone draws what it draws in the
    batch."""
    s = setup
    jeng, teng = _engines(s, T)
    prompts, lens = _padded(0, [9, 4, 7], s["jmodel"].vocab)
    rids = np.array([3, 1, 7])
    want = _ref(jeng.generate, prompts, lengths=lens, request_ids=rids, seed=5)
    got = teng.generate(prompts, lengths=lens, request_ids=rids, seed=5)
    rows = [prompts[b, :L] for b, L in enumerate(lens)]
    assert _assert_streams_equal(s, T, rows, rids, got, want, seed=5)
    _assert_sampled(s, rows, got)
    for b in range(3):
        alone = teng.generate(prompts[b:b + 1, :lens[b]], request_ids=rids[b:b + 1], seed=5)
        np.testing.assert_array_equal(alone[0], got[b])
    full, _ = _padded(1, [8, 8], s["jmodel"].vocab)              # one scalar position
    want = _ref(jeng.generate, full)
    got = teng.generate(full)
    assert _assert_streams_equal(s, T, list(full), [0, 1], got, want)
    eos = int(want[0, 2])                                        # EOS on: per-row positions
    want = _ref(jeng.generate, full, eos_id=eos)
    got = teng.generate(full, eos_id=eos)
    assert _assert_streams_equal(s, T, list(full), [0, 1], got, want)
    first = int(np.nonzero(got[0] == eos)[0][0])
    assert (got[0, first + 1:] == 0).all()


@pytest.mark.parametrize("T", TEMPS)
def test_serve_requests_sampled_equals_reference(setup, T):
    s = setup
    jeng, teng = _engines(s, T)
    rs = np.random.RandomState(4)
    reqs = [rs.randint(1, s["jmodel"].vocab, L).astype(np.int32) for L in (5, 9, 3, 12, 7)]
    want = _ref(jeng.serve_requests, reqs, batch_size=2, seed=3)
    got = teng.serve_requests(reqs, batch_size=2, seed=3)
    assert _assert_streams_equal(s, T, reqs, range(len(reqs)), got, want, seed=3)
    _assert_sampled(s, reqs, got)
    for i, r in enumerate(reqs):                    # each request as served alone
        solo = teng.generate(r[None], request_ids=np.array([i]), seed=3)
        np.testing.assert_array_equal(got[i], solo[0])


def _serve(eng, cfg: dict, reqs, budgets):
    eng.cfg = dataclasses.replace(eng.cfg, **cfg)
    outs = _ref(eng.serve_continuous, reqs, slots=SLOTS, chunk_steps=CHUNK, max_new=budgets)
    return outs, eng.last_serve_stats


def _mode_cfg(s, T, mode: str, spec_k: int) -> dict:
    cfg = {"paged": False, "paged_read": "shadow", "prefix_caching": True,
           "pool_blocks": None, "eos_id": -1, **MODES[mode], "spec_k": spec_k}
    if mode == "eos":
        if T not in s["eos"]:      # the token request 0's sampled stream emits second
            probe, _ = _serve(_engines(s, T)[0], {"paged": False, "eos_id": -1, "spec_k": 0},
                              s["reqs"], s["budgets"])
            s["eos"][T] = int(probe[0][1])
        cfg["eos_id"] = s["eos"][T]
    return cfg


def _assert_same_run(s, T, got, gstats, want, wstats):
    assert _assert_streams_equal(s, T, s["reqs"], range(len(s["reqs"])), got, want)
    for g, m in zip(got, s["budgets"]):
        assert g.shape == (m,)
    counters = {k: v for k, v in wstats.items() if k not in NOT_COMPARED}
    assert {k: gstats[k] for k in counters} == counters
    assert ("paged" in gstats) == ("paged" in wstats)
    if "paged" in wstats:
        assert gstats["paged"] == wstats["paged"]


def _continuous(s, T, mode):
    """The port's non-speculative run of a mode, served once per module."""
    if (T, mode) not in s["runs"]:
        s["runs"][(T, mode)] = _serve(_engines(s, T)[1], _mode_cfg(s, T, mode, 0),
                                      s["reqs"], s["budgets"])
    return s["runs"][(T, mode)]


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_continuous_sampled_equals_reference(setup, mode):
    s = setup
    T = TEMPS[0]
    jeng, teng = _engines(s, T)
    cfg = _mode_cfg(s, T, mode, 0)
    want, wstats = _serve(jeng, cfg, s["reqs"], s["budgets"])
    got, gstats = _continuous(s, T, mode)
    _assert_same_run(s, T, got, gstats, want, wstats)
    _assert_sampled(s, s["reqs"], got, cfg["eos_id"])
    if mode == "dense":
        for i, r in enumerate(s["reqs"]):           # each request as served alone
            solo = teng.generate(r[None], request_ids=np.array([i]), max_new=s["budgets"][i])
            np.testing.assert_array_equal(got[i], solo[0])
        # other batch mates (the first five alone) change no stream
        few, _ = _serve(teng, cfg, s["reqs"][:5], s["budgets"][:5])
        for a, b in zip(few, got):
            np.testing.assert_array_equal(a, b)
    if mode == "eos":
        first = int(np.nonzero(got[0] == cfg["eos_id"])[0][0])
        assert (got[0][first + 1:] == 0).all()
    if mode == "tight_pool":
        # a preempted request re-derives its chain: its stream is the dense one
        assert gstats["n_preemptions"] >= 1
        dense, _ = _continuous(s, T, "dense")
        for a, b in zip(got, dense):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("spec_k", [1, 2])
def test_speculative_sampled_equals_reference(setup, spec_k, mode):
    """Streams, counters and ``last_serve_stats["spec"]`` equal the
    reference's; streams equal the port's own ``spec_k = 0`` run; drafts
    are rejected and accepted both."""
    s = setup
    T = TEMPS[0]
    jeng, teng = _engines(s, T)
    cfg = _mode_cfg(s, T, mode, spec_k)
    want, wstats = _serve(jeng, cfg, s["reqs"], s["budgets"])
    got, gstats = _serve(teng, cfg, s["reqs"], s["budgets"])
    _assert_same_run(s, T, got, gstats, want, wstats)
    assert gstats["spec"] == wstats["spec"] and gstats["spec"]["spec_k"] == spec_k
    assert 0.0 < gstats["spec"]["acceptance_rate"] < 1.0
    plain, _ = _continuous(s, T, mode)
    assert _assert_streams_equal(s, T, s["reqs"], range(len(s["reqs"])), got, plain)
    _assert_sampled(s, s["reqs"], got, cfg["eos_id"])
    if mode == "tight_pool":
        assert gstats["n_preemptions"] >= 1


@pytest.mark.parametrize("T", TEMPS)
def test_draft_propose_sampled_equals_reference(setup, T):
    """The drafter samples step ``j`` with the chain's ``j``-th step key:
    from the keys, and from that noise drawn ahead (the engine's way), its
    drafts equal the reference's ``draft_propose``; a latched row keeps its
    position."""
    s = setup
    jd = jsp.DraftModel.from_target(s["jparams"], s["jmodel"], n_layers=1)
    td = tsp.DraftModel.from_target(s["tparams"], s["tmodel"], n_layers=1)
    rs = np.random.RandomState(5)
    prompts = rs.randint(1, s["jmodel"].vocab, (3, 6)).astype(np.int32)
    tok = rs.randint(1, s["jmodel"].vocab, (3, 1)).astype(np.int32)
    pos, eos = np.full(3, 6, np.int32), np.array([False, True, False])
    keys = Engine._row_key_pairs(threefry.prng_key(3).numpy(), np.arange(3))[:, 0]
    _, jc = _ref(jlm.prefill, jd.params, jd.cfg, {"tokens": jnp.asarray(prompts)}, MAX_SEQ,
                 jnp.float32)
    want, _ = _ref(jsp.draft_propose, jd.params, jd.cfg, 4, jnp.asarray(tok), jc,
                   jnp.asarray(pos), jnp.asarray(keys.astype(np.uint32)), jnp.asarray(eos), T,
                   jnp.float32)
    kts, _ = tsp.split_chain(keys, 4)
    for k, noise in ((keys, None), (torch.as_tensor(keys), None),
                     (None, threefry.gumbel(torch.as_tensor(kts), (s["tmodel"].vocab,)))):
        _, tc = tlm.prefill(td.params, td.cfg, torch.as_tensor(prompts.astype(np.int64)), MAX_SEQ)
        got, _ = tsp.draft_propose(td.params, td.cfg, 4, torch.as_tensor(tok), tc,
                                   torch.as_tensor(pos.astype(np.int64)), k,
                                   torch.as_tensor(eos), T, noise=noise)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the CLI, in process, both launchers on the same scaled weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--batch", "2"],
    ["--engine", "continuous", "--paged", "--spec-k", "2", "--batch", "2", "--block-size", "4"],
])
def test_cli_temperature_serves_the_reference_cli_tokens(flags, monkeypatch, capsys):
    """``--temperature 0.7`` serves on the CPU, static and continuous paged
    speculative, and prints the reference CLI's tokens and counters."""
    init = jlm.init_params

    def jinit(key, model):
        return _scaled(init(key, model))

    def tinit(model, seed, device, **_):
        jmodel = jconfigs.get_reduced(ARCH).model
        return params_from_jax(jax.device_get(_ref(jinit, jax.random.PRNGKey(seed), jmodel)),
                               device=device)

    monkeypatch.setattr(jserve.lm, "init_params", jinit)
    monkeypatch.setattr(tlm, "init_params", tinit)
    argv = ["--arch", ARCH, "--requests", "5", "--prompt-len", "8", "--max-new", "6",
            "--seed", "3", *flags]

    def lines(out: str) -> list[str]:        # what does not depend on the clock
        return [ln for ln in out.splitlines() if ln.startswith(("sample output", "[serve:spec]",
                                                                "[serve:paged]"))
                or "slot_utilization" in ln]

    assert _ref(jserve.main, [*argv, "--temperature", "0.7"]) == 0
    want = lines(capsys.readouterr().out)
    assert tserve.main([*argv, "--temperature", "0.7", "--device", "cpu"]) == 0
    got = lines(capsys.readouterr().out)
    assert got == want and got[-1].startswith("sample output ids:")
    assert tserve.main([*argv, "--device", "cpu"]) == 0          # greedy: other tokens
    assert lines(capsys.readouterr().out)[-1] != got[-1]


def test_sampling_is_not_greedy_and_no_near_tie_fired(setup):
    """The greedy streams of the same requests differ from the sampled
    ones, and the near-tie rule fired nowhere in this file's runs (it runs
    last in the file)."""
    s = setup
    greedy = Engine(s["tparams"], s["tmodel"], ServeConfig(max_seq=MAX_SEQ, max_new_tokens=8),
                    device="cpu")
    g = greedy.serve_continuous(s["reqs"], slots=SLOTS, chunk_steps=CHUNK, max_new=s["budgets"])
    sampled, _ = _continuous(s, TEMPS[0], "dense")
    assert sum(not np.array_equal(a, b) for a, b in zip(g, sampled)) >= len(g) // 2
    assert TIES == []
