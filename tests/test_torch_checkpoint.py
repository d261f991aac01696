"""The port's checkpoints and its training launcher, on the CPU.

* ``checkpoint/store.py``: a round trip of a ``(params, opt_state)`` pair,
  bit for bit; a partial ``.tmp`` step and a step without a finished
  manifest are ignored; the background writer keeps the newest ``keep``;
* either package restores the other's checkpoint bit for bit (the same
  layout and keys);
* ``launch.train --reduced --device cpu``: a run resumed from its step-10
  checkpoint ends at step 20 with the state of a straight 20-step run, bit
  for bit (one CPU, the same ops in the same order), and the batches after
  the resume are the stream's own;
* ``examples/lm_train.py`` trains and runs its restart drill on the CPU.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.optim import adamw as jadam
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import store
from repro_torch.convert import flatten_with_paths, params_from_jax
from repro_torch.examples import lm_train
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw as tadam
from test_torch_train import numpy_params

ARCH = "kanformer-100m"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops; one thread each keeps them
    from contending for the cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed: int = 0):
    """A port ``(params, opt_state)`` of the reduced kanformer with non-zero
    moments and step."""
    tm = tconfigs.get_reduced(ARCH).model
    params = params_from_jax(numpy_params(tm, seed), device="cpu")
    state = tadam.init_state(params)
    state["m"] = params_from_jax(numpy_params(tm, seed + 1), device="cpu")
    state["step"] = torch.tensor(7, dtype=torch.int32)
    return params, state


def _assert_bit_equal(a_tree, b_tree):
    a, b = flatten_with_paths(a_tree), flatten_with_paths(b_tree)
    assert a.keys() == b.keys()
    for k in a:
        x, y = (np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t) for t in (a[k], b[k]))
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def test_round_trip_is_bit_equal(tmp_path):
    pair = _pair()
    path = store.save(str(tmp_path), 12, pair, {"loss": 1.5})
    assert os.path.basename(path) == "step_00000012"
    with open(os.path.join(path, "manifest.json")) as f:
        mf = json.load(f)
    assert mf["done"] and mf["step"] == 12 and mf["extra"] == {"loss": 1.5}
    assert mf["keys"] == sorted(flatten_with_paths(pair)) and mf["dtypes"]["[1]/['step']"] == "int32"
    like = _pair(seed=5)
    got, mf2 = store.restore(str(tmp_path), 12, like, device="cpu")
    assert isinstance(got, tuple) and mf2 == mf
    _assert_bit_equal(got, pair)


def test_partial_steps_are_ignored_and_the_writer_keeps_the_newest(tmp_path):
    tree = {"w": torch.zeros(2), "s": torch.tensor(3, dtype=torch.int32)}
    store.save(str(tmp_path), 5, tree)
    os.makedirs(tmp_path / "step_00000009.tmp")            # a crash mid-write
    os.makedirs(tmp_path / "step_00000011")                # a directory with no manifest
    (tmp_path / "step_00000012").mkdir()
    (tmp_path / "step_00000012" / "manifest.json").write_text('{"done": false}')
    assert store.all_steps(str(tmp_path)) == [5] and store.latest_step(str(tmp_path)) == 5
    ck = store.AsyncCheckpointer(str(tmp_path / "ck"), keep=2)
    for s in (1, 2, 3):
        tree["w"] += 1                                    # training updates in place
        ck.save_async(s, tree)
    ck.wait()
    assert store.all_steps(str(tmp_path / "ck")) == [2, 3]
    got, _ = store.restore(str(tmp_path / "ck"), 2, tree, device="cpu")
    assert got["w"].tolist() == [2.0, 2.0]                # the snapshot, not the live tree


def test_each_package_restores_the_others_checkpoint(tmp_path):
    """The reference's ``store.save`` of a JAX ``(params, adamw state)``
    restores in the port bit for bit, and the port's in the reference."""
    jm = jconfigs.get_reduced(ARCH).model
    tm = tconfigs.get_reduced(ARCH).model
    jparams = jax.tree.map(jnp.asarray, numpy_params(tm, 2))
    jstate = jadam.init_state(jparams)
    jstate["v"] = jax.tree.map(lambda a: a + 0.25, jstate["v"])
    jstate["step"] = jnp.asarray(41, jnp.int32)
    jstore.save(str(tmp_path / "jax"), 41, (jparams, jstate))
    like = _pair()
    got, mf = store.restore(str(tmp_path / "jax"), store.latest_step(str(tmp_path / "jax")),
                            like, device="cpu")
    assert mf["step"] == 41
    _assert_bit_equal(got, jax.device_get((jparams, jstate)))

    pair = _pair(seed=3)
    store.save(str(tmp_path / "torch"), 8, pair)
    assert jstore.latest_step(str(tmp_path / "torch")) == 8
    back, _ = jstore.restore(str(tmp_path / "torch"), 8, (jparams, jstate))
    _assert_bit_equal(jax.device_get(back), pair)
    assert jm.d_model == tm.d_model


def _train(tmp_path, steps: int, *extra: str) -> dict:
    return ttrain.run(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", str(steps),
                       "--batch", "4", "--seq", "16", "--lr", "2e-3", "--log-every", "5",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "10", *extra])


def test_resumed_run_equals_a_straight_run(tmp_path, capsys):
    straight = _train(tmp_path / "a", 20)
    assert store.all_steps(str(tmp_path / "a")) == [10, 20]
    # a run stopped at step 10: the same checkpoints up to there
    shutil.copytree(tmp_path / "a" / "step_00000010", tmp_path / "b" / "step_00000010")
    resumed = _train(tmp_path / "b", 20)
    out = capsys.readouterr().out
    assert f"[resume] restored step 10 from {tmp_path / 'b'}" in out
    assert "[done] steps=20 loss" in out and "step    20 loss" in out
    assert resumed["start_step"] == 10 and len(resumed["losses"]) == 10
    assert resumed["losses"] == straight["losses"][10:]
    _assert_bit_equal((resumed["params"], resumed["opt_state"]),
                      (straight["params"], straight["opt_state"]))
    tm = tconfigs.get_reduced(ARCH).model
    cfg = ttrain.dp.LMDataConfig(tm.vocab, 16, 4)
    again = ttrain.make_batch(tm, cfg, 13, "cpu")
    assert all(torch.equal(again[k], ttrain.dp.lm_batch(cfg, 13)[k]) for k in again)


def test_lm_train_example_runs_its_restart_drill(capsys):
    assert lm_train.main(["--steps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[restart drill] resuming from latest checkpoint" in out
    assert "[resume] restored step 2 from" in out and "[done] steps=22" in out
