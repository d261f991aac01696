"""The port's continuous-batching engine against the JAX engine, on the CPU.

Reduced kanformer-100m, parameters made in JAX and carried across with
``params_from_jax``, fp32.  Ten requests of mixed lengths, every other one
starting with the same two-block prefix, mixed token budgets, three slots
and three-step chunks.  Per-request greedy token streams must be EQUAL to
the JAX engine's, and so must the integer counters of
``last_serve_stats`` (scheduler, pool and prefix cache), in every mode:
dense rows, paged with each read cadence, prefix caching off, EOS latching,
and a pool tight enough to evict prefix entries and preempt.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_jax_subprocess
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "kanformer-100m"
MAX_SEQ = 32
BLOCK = 4
SLOTS, CHUNK = 3, 3
# the reference's keys that describe its wall clock, JAX tracing or meshes
NOT_COMPARED = {"wall_s", "request_latency_s", "compiles", "mesh_shape", "paged"}
CASES = {
    "dense": {},
    "paged_shadow": {"paged": True},
    "paged_step": {"paged": True, "paged_read": "step"},
    "prefix_off": {"paged": True, "prefix_caching": False},
    "eos": {"paged": True},
    "tight_pool": {"paged": True, "pool_blocks": 12},
}


@pytest.fixture(scope="module")
def setup():
    jmodel = jconfigs.get_reduced(ARCH).model
    tmodel = tconfigs.get_reduced(ARCH).model
    jparams = jlm.init_params(jax.random.PRNGKey(0), jmodel)
    base = dict(max_seq=MAX_SEQ, max_new_tokens=8, block_size=BLOCK)
    jeng = JEngine(jparams, jmodel, JServeConfig(**base))
    teng = Engine(params_from_jax(jax.device_get(jparams), device="cpu"), tmodel,
                  ServeConfig(**base), device="cpu")
    rs = np.random.RandomState(0)
    common = rs.randint(1, jmodel.vocab, 2 * BLOCK).astype(np.int32)
    reqs = []
    for i in range(10):
        r = rs.randint(1, jmodel.vocab, int(rs.randint(3, 14))).astype(np.int32)
        reqs.append(np.concatenate([common, r]) if i % 2 else r)
    budgets = [int(b) for b in rs.randint(1, 9, len(reqs))]
    return jeng, teng, reqs, budgets


def _serve(eng, cfg: dict, reqs, budgets):
    eng.cfg = dataclasses.replace(eng.cfg, **cfg)
    outs = eng.serve_continuous(reqs, slots=SLOTS, chunk_steps=CHUNK, max_new=budgets)
    return outs, eng.last_serve_stats


@pytest.mark.parametrize("case", list(CASES))
def test_serve_continuous_equals_reference(setup, case):
    jeng, teng, reqs, budgets = setup
    cfg = dict(CASES[case])
    if case == "eos":
        # a token that request 0's greedy stream emits at its second step
        probe, _ = _serve(jeng, {"paged": False, "eos_id": -1}, reqs, budgets)
        cfg["eos_id"] = int(probe[0][1])
    cfg = {"paged": False, "paged_read": "shadow", "prefix_caching": True,
           "pool_blocks": None, "eos_id": -1, **cfg}
    want, wstats = _serve(jeng, cfg, reqs, budgets)
    got, gstats = _serve(teng, cfg, reqs, budgets)
    assert len(got) == len(reqs)
    for g, w, m in zip(got, want, budgets):
        assert g.dtype == np.int32 and g.shape == (m,)
        np.testing.assert_array_equal(g, w)
    counters = {k: v for k, v in wstats.items() if k not in NOT_COMPARED}
    assert {k: gstats[k] for k in counters} == counters
    if cfg["paged"]:
        assert gstats["paged"] == wstats["paged"]
    if case == "dense":
        for i, r in enumerate(reqs):          # each request as served alone
            solo = teng.generate(r[None], request_ids=np.array([i]), max_new=budgets[i])
            np.testing.assert_array_equal(got[i], solo[0])
    if case == "eos":
        first = int(np.nonzero(got[0] == cfg["eos_id"])[0][0])
        assert first < budgets[0] - 1 and (got[0][first + 1:] == 0).all()
    if case == "tight_pool":
        assert gstats["n_preemptions"] >= 1 and gstats["paged"]["prefix_evictions"] >= 1
    if case in ("paged_shadow", "paged_step", "tight_pool", "eos"):
        assert gstats["paged"]["prefill_tokens_saved"] > 0


def test_prefill_into_slot_splices_one_row_as_the_reference(setup):
    """Admission of one right-padded request into row 2 of a live cache:
    logits at its last real token (atol 1e-5, fp32) and the spliced row
    match; the other rows stay untouched."""
    jeng, teng, reqs, _ = setup
    r = reqs[1]
    padded = np.pad(r, (0, 24 - len(r)))[None]
    jc = jlm.init_caches(jeng.model, 3, MAX_SEQ, jnp.float32)
    tc = tlm.init_caches(teng.model, 3, MAX_SEQ, torch.float32, "cpu")
    jl, jc = jlm.prefill_into_slot(jeng.params, jeng.model, jnp.asarray(padded), len(r), 2,
                                   jc, MAX_SEQ, jnp.float32)
    tl, tc = tlm.prefill_into_slot(teng.params, teng.model, torch.tensor(padded), len(r), 2,
                                   tc, MAX_SEQ, torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    assert tl.numpy().argmax() == np.asarray(jl).argmax()
    for n in ("k", "v"):
        got, want = tc["unit"][0][n].numpy(), np.asarray(jc["unit"][0][n])
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert not got[:, :2].any()


def test_serve_continuous_validation_errors(setup):
    _, teng, reqs, _ = setup
    teng.cfg = dataclasses.replace(teng.cfg, paged=True, pool_blocks=4, eos_id=-1)
    with pytest.raises(ValueError, match="exceeds the pool's 3 usable blocks"):
        teng.serve_continuous(reqs[:2], slots=2, chunk_steps=2, max_new=8)
    teng.cfg = dataclasses.replace(teng.cfg, pool_blocks=None, block_size=5)
    with pytest.raises(ValueError, match="must divide max_seq"):
        teng.serve_continuous(reqs[:2], slots=2)
    teng.cfg = dataclasses.replace(teng.cfg, block_size=BLOCK, paged_read="tile")
    with pytest.raises(ValueError, match="paged_read"):
        teng.serve_continuous(reqs[:2], slots=2)
    teng.cfg = dataclasses.replace(teng.cfg, paged_read="shadow")
    with pytest.raises(ValueError, match="exceeds max_seq"):
        teng.serve_continuous([np.ones(30, np.int32)], slots=1, max_new=8)


def test_cli_continuous_paged_runs_on_cpu():
    r = run_jax_subprocess(argv=[
        "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
        "--engine", "continuous", "--paged", "--requests", "5", "--batch", "2",
        "--prompt-len", "8", "--max-new", "4", "--block-size", "4"], timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[serve:continuous] 5 requests, 20 tokens" in r.stdout
    assert "served=5/5" in r.stdout and "[serve:paged] block_size=4" in r.stdout
