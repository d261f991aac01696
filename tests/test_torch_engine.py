"""The port's static greedy engine and its CLI against the JAX reference.

Reduced kanformer-100m, parameters made in JAX and carried across with
``params_from_jax``, fp32 on the CPU.  Greedy token streams must be EQUAL
to the JAX engine's (not merely close): right-padded mixed-length batches,
the scalar-position path, EOS latching followed by ``pad_id``, and
``serve_requests``' length-sorted buckets padded with copies.
"""

import jax
import numpy as np
import pytest

from conftest import run_jax_subprocess
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "kanformer-100m"
MAX_NEW = 6
PAD = 0


@pytest.fixture(scope="module")
def engines():
    jmodel = jconfigs.get_reduced(ARCH).model
    tmodel = tconfigs.get_reduced(ARCH).model
    jparams = jlm.init_params(jax.random.PRNGKey(0), jmodel)
    cfg = dict(max_seq=40, max_new_tokens=MAX_NEW, pad_id=PAD)
    jeng = JEngine(jparams, jmodel, JServeConfig(**cfg))
    teng = Engine(params_from_jax(jax.device_get(jparams), device="cpu"), tmodel,
                  ServeConfig(**cfg), device="cpu")
    return jeng, teng, jmodel.vocab


def _padded(seed, lens, vocab):
    rs = np.random.RandomState(seed)
    T = max(lens)
    prompts = np.zeros((len(lens), T), np.int32)
    for b, L in enumerate(lens):
        prompts[b, :L] = rs.randint(1, vocab, L)
    return prompts, np.asarray(lens, np.int32)


def test_generate_ragged_and_scalar_pos_streams_equal_reference(engines):
    jeng, teng, vocab = engines
    prompts, lens = _padded(0, [9, 4, 7], vocab)
    want = jeng.generate(prompts, lengths=lens)
    got = teng.generate(prompts, lengths=lens)
    assert got.dtype == np.int32 and got.shape == (3, MAX_NEW)
    np.testing.assert_array_equal(got, want)
    full, _ = _padded(1, [8, 8], vocab)               # no lengths: one scalar pos
    np.testing.assert_array_equal(teng.generate(full), jeng.generate(full))


def test_generate_eos_latch_streams_equal_reference(engines):
    jeng, teng, vocab = engines
    prompts, lens = _padded(2, [6, 10], vocab)
    never = jeng.generate(prompts, lengths=lens)
    eos = int(never[0, 2])                            # a token row 0 really emits
    want = jeng.generate(prompts, lengths=lens, eos_id=eos)
    got = teng.generate(prompts, lengths=lens, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    first = int(np.nonzero(never[0] == eos)[0][0])
    assert got[0, first] == eos and (got[0, first + 1:] == PAD).all()
    full, _ = _padded(3, [7, 7], vocab)               # EOS on: per-row pos path
    eos = int(jeng.generate(full)[1, 1])
    np.testing.assert_array_equal(teng.generate(full, eos_id=eos),
                                  jeng.generate(full, eos_id=eos))


def test_serve_requests_streams_equal_reference(engines):
    jeng, teng, vocab = engines
    rs = np.random.RandomState(4)
    reqs = [rs.randint(1, vocab, L).astype(np.int32) for L in (5, 9, 3, 12, 7)]
    want = jeng.serve_requests(reqs, batch_size=2)
    got = teng.serve_requests(reqs, batch_size=2)
    assert len(got) == len(reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    stats = teng.last_serve_stats
    assert [b["rows"] for b in stats["buckets"]] == [2, 2, 2]   # last one padded
    assert [b["prompt_len"] for b in stats["buckets"]] == [5, 9, 12]


def test_engine_rejects_what_it_cannot_serve(engines):
    _, teng, vocab = engines
    with pytest.raises(NotImplementedError, match="threefry"):
        Engine(teng.params, teng.model, ServeConfig(temperature=0.7), device="cpu")
    prompts, _ = _padded(5, [38], vocab)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        teng.generate(prompts)


def test_cli_static_engine_runs_on_cpu():
    r = run_jax_subprocess(argv=[
        "-m", "repro_torch.launch.serve", "--arch", ARCH, "--device", "cpu",
        "--requests", "3", "--batch", "2", "--prompt-len", "8", "--max-new", "4"],
        timeout=300)
    assert r.returncode == 0, r.stderr
    assert "[serve:static] 3 requests, 12 tokens" in r.stdout


@pytest.mark.parametrize("flags", [["--paged"], ["--engine", "continuous"],
                                   ["--spec-k", "2"], ["--spec-k", "-1"],
                                   ["--mesh", "1x1"], ["--temperature", "0.7"]])
def test_cli_rejects_what_is_not_ported(flags, capsys):
    assert tserve.main(["--arch", ARCH, "--device", "cpu", *flags]) == 2
    assert "[serve]" in capsys.readouterr().err
