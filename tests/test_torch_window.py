"""The port's sliding-window rings and q/k norm against the JAX package, fp32
on the CPU, on gemma3-12b ``reduced()`` (one repeat of 5 windowed blocks,
window 8, and 1 full-attention block; q/k RMS norm on all six).

What must hold: the ring caches after a 20-token prefill (slot ``s`` holds
the latest position ``p < 20`` with ``p % 8 == s``) and 12 decode steps
past the window, scalar and per-row ``pos``, match the reference's (int8
rings too); ``q_norm``/``k_norm`` take effect and match; a ring equals a
full cache while the history fits in the window; ``serve_continuous``
reproduces the JAX engine's streams, the documented stale-pad caveat of
ragged rows included; paged and speculative use are refused with the
reference's messages.  Tolerances: logits atol 1e-4, K/V atol 1e-5 (fp32
sums in another order), int8 values within 1.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.common import enable_kv_quant as jquant
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.serve import speculative as jsp
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.configs.common import enable_kv_quant as tquant
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.serve import speculative as tsp
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "gemma3-12b"
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5
MAX_SEQ = 32
WINDOW = 8


@pytest.fixture(scope="module")
def setup():
    jmodel = jconfigs.get_reduced(ARCH).model
    tmodel = tconfigs.get_reduced(ARCH).model
    assert tmodel.unit[0].attn.window == WINDOW and tmodel.unit[-1].attn.window is None
    jparams = jlm.init_params(jax.random.PRNGKey(1), jmodel)
    # non-trivial q/k norm scales, the same on both sides
    rs = np.random.RandomState(3)
    for blk in jparams["unit"]:
        for n in ("q_norm", "k_norm"):
            blk["attn"][n] = jnp.asarray(rs.uniform(0.5, 1.5, blk["attn"][n].shape), jnp.float32)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return {"jmodel": jmodel, "tmodel": tmodel, "jparams": jparams, "tparams": tparams}


def _tok(seed, B, T):
    return np.random.RandomState(seed).randint(0, 512, (B, T)).astype(np.int32)


def _check_caches(tc, jc, int8=False):
    for got, want in zip(tc["unit"], jc["unit"]):
        assert sorted(got) == sorted(want)
        for n, a in got.items():
            w = np.asarray(want[n])
            assert tuple(a.shape) == w.shape, n
            if int8 and n in ("k", "v"):
                assert np.abs(a.numpy().astype(np.int32) - w.astype(np.int32)).max() <= 1
            elif n.endswith("_scale"):
                np.testing.assert_allclose(a.numpy(), w, rtol=1e-6)
            else:
                np.testing.assert_allclose(a.numpy(), w, atol=KV_ATOL)


@pytest.mark.parametrize("quant", [False, True])
def test_ring_prefill_then_decode_past_the_window(setup, quant):
    """20-token prefill into rings of 8 slots (full cache for the global
    block), then 12 decode steps: scalar pos for both rows, then per-row."""
    s = setup
    jmodel = jquant(jconfigs.get_reduced(ARCH)).model if quant else s["jmodel"]
    tmodel = tquant(tconfigs.get_reduced(ARCH)).model if quant else s["tmodel"]
    toks = _tok(1, 2, 20)
    prefill = jax.jit(functools.partial(jlm.prefill, cfg=jmodel, max_seq=MAX_SEQ,
                                        compute_dtype=jnp.float32))
    step = jax.jit(functools.partial(jlm.decode_step, cfg=jmodel, compute_dtype=jnp.float32))
    jlog, jc = prefill(s["jparams"], inputs={"tokens": jnp.asarray(toks)})
    tlog, tc = tlm.prefill(s["tparams"], tmodel, torch.tensor(toks), MAX_SEQ, torch.float32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    assert tc["unit"][0]["k"].shape[2] == WINDOW and tc["unit"][-1]["k"].shape[2] == MAX_SEQ
    _check_caches(tc, jc, quant)
    steps = _tok(2, 12, 2)
    for k in range(12):
        p = np.int32(20 + k) if k < 6 else np.array([20 + k, 17 + k])
        tok = steps[k][:, None]
        jlog, jc = step(s["jparams"], tokens=jnp.asarray(tok), caches=jc,
                        pos=jnp.asarray(p, jnp.int32))
        tlog, tc = tlm.decode_step(s["tparams"], tmodel, torch.tensor(tok), tc,
                                   torch.tensor(p, dtype=torch.int64), torch.float32)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    _check_caches(tc, jc, quant)


def test_forward_matches_reference_windowed_mask(setup):
    s = setup
    toks = _tok(3, 2, 20)
    jlog, _ = jlm.forward(s["jparams"], s["jmodel"], {"tokens": jnp.asarray(toks)}, jnp.float32)
    tlog, _ = tlm.forward(s["tparams"], s["tmodel"], torch.tensor(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)


def test_qk_norm_takes_effect(setup):
    """Scaling q_norm and k_norm changes the logits (they are applied), and
    the port follows the reference there too."""
    s = setup
    toks = _tok(4, 1, 12)
    base, _ = tlm.forward(s["tparams"], s["tmodel"], torch.tensor(toks))
    jp = jax.tree.map(lambda a: a, s["jparams"])
    for blk in jp["unit"]:
        blk["attn"]["q_norm"] = blk["attn"]["q_norm"] * 3.0
        blk["attn"]["k_norm"] = blk["attn"]["k_norm"] * 0.25
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    got, _ = tlm.forward(tp, s["tmodel"], torch.tensor(toks))
    want, _ = jlm.forward(jp, s["jmodel"], {"tokens": jnp.asarray(toks)}, jnp.float32)
    assert (got - base).abs().max().item() > 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


def test_ring_buffer_matches_full_cache(setup):
    """The reference's ``test_ring_buffer_matches_full_cache`` on the port:
    8 tokens (history <= window) decoded from 0 through rings of 8 slots
    equal ``lm.forward`` (rtol = atol = 3e-4 as there) and decoding through
    caches without a window (``max_seq`` 16: the rings stay 8 slots)."""
    s = setup
    toks = torch.tensor(_tok(5, 1, WINDOW))
    full_cfg = dataclasses.replace(s["tmodel"], unit=tuple(
        dataclasses.replace(b, attn=dataclasses.replace(b.attn, window=None))
        for b in s["tmodel"].unit))

    def decode(model, max_seq):
        caches = tlm.init_caches(model, 1, max_seq, torch.float32, "cpu")
        outs = []
        for t in range(WINDOW):
            lg, caches = tlm.decode_step(s["tparams"], model, toks[:, t:t + 1], caches,
                                         torch.tensor(t), torch.float32)
            outs.append(lg)
        return torch.stack(outs, 1)

    ring = decode(s["tmodel"], 2 * WINDOW)
    fwd, _ = tlm.forward(s["tparams"], s["tmodel"], toks)
    np.testing.assert_allclose(ring.numpy(), fwd.numpy(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(ring.numpy(), decode(full_cfg, 2 * WINDOW).numpy(),
                               rtol=3e-4, atol=3e-4)


def test_serve_continuous_reproduces_reference_streams(setup):
    """Ragged rows through the windowed rings: the port serves the JAX
    engine's streams, the stale-pad caveat included (a right-padded prompt
    longer than the window leaves pad K/V in the ring), and its counters."""
    s = setup
    base = dict(max_seq=MAX_SEQ, max_new_tokens=6)
    rs = np.random.RandomState(6)
    reqs = [rs.randint(1, 512, int(L)).astype(np.int32) for L in (5, 11, 14, 9, 19)]
    jeng = JEngine(s["jparams"], s["jmodel"], JServeConfig(**base))
    teng = Engine(s["tparams"], s["tmodel"], ServeConfig(**base), device="cpu")
    want = jeng.serve_continuous(reqs, slots=2, chunk_steps=3)
    got = teng.serve_continuous(reqs, slots=2, chunk_steps=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for k in ("chunks_run", "n_served", "n_preemptions"):
        assert teng.last_serve_stats[k] == jeng.last_serve_stats[k]


def test_paged_and_speculative_refused_as_the_reference(setup):
    s = setup
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
    eng = Engine(s["tparams"], s["tmodel"], ServeConfig(max_seq=16, paged=True, block_size=4),
                 device="cpu")
    with pytest.raises(NotImplementedError, match="paged KV needs full-attention"):
        eng.serve_continuous([np.ones(3, np.int32)], slots=1, max_new=2)


@pytest.mark.parametrize("flag", ["--spec-k", "--paged"])
def test_cli_refuses_as_the_reference(flag, capsys):
    """``--spec-k`` on gemma3 exits rc=2 with the reference's message;
    ``--paged`` raises the reference's ``NotImplementedError``."""
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
