"""GPipe pipeline training (``train/pipeline.py``) against the JAX package,
fp32 on the CPU.

* The reference's ``make_pp_loss`` on a ``(pod=2, data=1, model=1)`` mesh,
  ``S = 2`` stages, ``M = 4`` microbatches, under ``jax.grad``, computed
  once in a subprocess (two fake host devices): the reduced kanformer-100m,
  qwen1.5-0.5b, olmoe-1b-7b at a capacity factor at which tokens drop, and
  paligemma-3b (its prefix ignored).  The port's loss within ``LOSS_RTOL``
  and each gradient leaf within ``GRAD_REL`` of its largest gradient.
* In process, the port's pipeline against its own ``lm_loss`` and
  ``loss_and_grads`` for ``S`` in {1, 2} and ``M`` in {1, 2, 4} on the
  non-MoE models (paligemma against its text-only loss), and a kanformer
  built at 4 repeats for ``S`` = 4; olmoe's pipelined loss equal to the
  token-weighted NLL of ``lm.forward`` on each microbatch alone and not to
  ``lm_loss`` on the whole batch; ``stage_params``' layout equal to the
  reference's; every refusal.

Parameters come from numpy (``test_torch_train.numpy_params``).
"""

import dataclasses
import pickle
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from conftest import run_jax_subprocess
from repro.train import pipeline as jpp
from repro_torch import configs as tconfigs
from repro_torch.configs import kanformer_100m
from repro_torch.convert import flatten_with_paths, params_from_jax
from repro_torch.models import lm as tlm
from repro_torch.train import pipeline as tpp
from repro_torch.train import step as tstep
from test_torch_train import numpy_params

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
B, T = 8, 8
# reduced olmoe (E = 8, top 2): a microbatch of 2 x 8 rows gets capacity 2
# per expert at 0.5, the whole batch 8, so the two drop different tokens
OLMOE_CAPACITY = 0.5
REF_ARCHS = ("kanformer-100m", "qwen1.5-0.5b", "olmoe-1b-7b", "paligemma-3b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small torch ops; one thread each keeps them
    from contending for the cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch: str):
    """The port's reduced config; olmoe at ``OLMOE_CAPACITY``."""
    model = tconfigs.get_reduced(arch).model
    if arch == "olmoe-1b-7b":
        blk = model.unit[0]
        blk = dataclasses.replace(blk, moe=dataclasses.replace(
            blk.moe, capacity_factor=OLMOE_CAPACITY))
        model = dataclasses.replace(model, unit=(blk,))
    return model


def _batch(model, seed: int, rows: int = B) -> dict:
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, model.vocab, (rows, T)).astype(np.int32)
    labels = rs.randint(0, model.vocab, (rows, T)).astype(np.int32)
    labels[:, -1] = -100
    labels[1, 2] = -100
    return {"tokens": tokens, "labels": labels}


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pp_loss_and_grads(model, params, batch, S, M):
    """The pipelined loss and its gradient in the staged layout."""
    fn = tpp.make_pp_loss(model, S, M)
    loss, _, grads = tstep.value_and_grads(lambda p: (fn(p, batch), {}),
                                           tpp.stage_params(params, S))
    return loss, grads


def _assert_grads_close(got_tree, want_tree, what):
    got, want = flatten_with_paths(got_tree), flatten_with_paths(want_tree)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape, (what, k)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_REL * scale + 1e-9, (what, k, err, scale)
    assert any(float(np.abs(np.asarray(w)).max()) > 0 for w in want.values())


# ---------------------------------------------------------------------------
# the reference's make_pp_loss, two models to a subprocess
# ---------------------------------------------------------------------------

REF_SCRIPT = textwrap.dedent("""
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.train import pipeline as PP

    src, dst = sys.argv[1], sys.argv[2]
    with open(src, "rb") as f:
        cases = pickle.load(f)
    mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"))
    out = {}
    for arch, (params, batch, capacity) in cases.items():
        model = configs.get_reduced(arch).model
        if capacity is not None:
            blk = model.unit[0]
            blk = dataclasses.replace(blk, moe=dataclasses.replace(
                blk.moe, capacity_factor=capacity))
            model = dataclasses.replace(model, unit=(blk,))
        staged = PP.stage_params(jax.tree.map(jnp.asarray, params), 2)
        staged["unit"] = [jax.device_put(
            p, jax.tree.map(lambda _: NamedSharding(mesh, P("pod")), p))
            for p in staged["unit"]]
        loss_fn = PP.make_pp_loss(model, n_stages=2, microbatches=4, mesh=mesh,
                                  compute_dtype=jnp.float32)
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
                staged, jax.tree.map(jnp.asarray, batch))
        out[arch] = (float(loss), jax.device_get(grads))
    with open(dst, "wb") as f:
        pickle.dump(out, f)
    print("PP_REF_OK")
""")


@pytest.fixture(scope="module")
def reference_pipeline(tmp_path_factory):
    """-> ``result()``, which waits for ``{arch: (model, numpy params, batch,
    loss, staged jax.grad)}`` of the reference's pipeline, S = 2, M = 4,
    fp32.  Requested only by the tests that read it, so a worker that runs
    none of them starts no JAX process; on first request two subprocesses
    of two models each run side by side (the reference's trace and compile
    take ~10 s a model)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    models, cases = {}, {}
    for i, arch in enumerate(REF_ARCHS):
        models[arch] = _model(arch)
        cases[arch] = (numpy_params(models[arch], seed=10 + i), _batch(models[arch], seed=20 + i),
                       OLMOE_CAPACITY if arch == "olmoe-1b-7b" else None)
    jobs = []
    for j, archs in enumerate((REF_ARCHS[:2], REF_ARCHS[2:])):
        src, dst = tmp / f"cases{j}.pkl", tmp / f"reference{j}.pkl"
        with open(src, "wb") as f:
            pickle.dump({a: cases[a] for a in archs}, f)
        jobs.append((dst, ["-c", REF_SCRIPT, str(src), str(dst)]))
    pool = ThreadPoolExecutor(len(jobs))
    futures = [(dst, pool.submit(run_jax_subprocess, argv=argv, devices=2, timeout=600))
               for dst, argv in jobs]
    out = {}

    def result():
        if not out:
            for dst, fut in futures:
                r = fut.result()
                assert r.returncode == 0 and "PP_REF_OK" in r.stdout, r.stderr[-3000:]
                with open(dst, "rb") as f:
                    out.update(pickle.load(f))
        return {a: (models[a], cases[a][0], cases[a][1]) + out[a] for a in REF_ARCHS}

    yield result
    for _, fut in futures:
        fut.exception()             # waits: no subprocess outlives the module
    pool.shutdown()


# ---------------------------------------------------------------------------
# the port's pipeline against its own plain loss
# ---------------------------------------------------------------------------


def _text_only(model):
    """paligemma's pipelined loss is the text-only loss: the same model
    read as a token model (the prefix ignored, positions 0..T-1)."""
    return dataclasses.replace(model, input_kind="tokens", n_prefix=0)


@pytest.fixture(scope="module", params=["kanformer-100m", "qwen1.5-0.5b", "paligemma-3b",
                                        "kanformer-100m@4"])
def plain_loss(request):
    """A non-MoE model's ``loss_and_grads`` (paligemma's text-only), its
    parameters and batch; ``@4``: kanformer at the reduced width, 4 repeats."""
    arch = request.param
    if arch == "kanformer-100m@4":
        model = dataclasses.replace(kanformer_100m.reduced().model, n_repeats=4)
    else:
        model = _model(arch)
    params = params_from_jax(numpy_params(model, seed=3), device="cpu")
    batch = _torch_batch(_batch(model, seed=4))
    loss, _, grads = tstep.loss_and_grads(params, _text_only(model), batch)
    return arch, model, params, batch, loss, grads


@pytest.mark.parametrize("S,M", [(1, 1), (1, 2), (1, 4), (2, 1), (2, 2), (2, 4), (4, 1), (4, 4)])
def test_pipeline_equals_plain_loss_and_grads(plain_loss, S, M):
    arch, model, params, batch, want_loss, want_grads = plain_loss
    if model.n_repeats % S:
        with pytest.raises(ValueError, match="equal stages"):
            tpp.make_pp_loss(model, S, M)
        return
    loss, grads = _pp_loss_and_grads(model, params, batch, S, M)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    _assert_grads_close(tpp.unstage_params(grads), want_grads, (arch, S, M))


def test_olmoe_pipeline_routes_each_microbatch_alone():
    """Capacity counts the rows routed together: the pipelined NLL equals
    ``lm.forward``'s token-weighted NLL over each microbatch alone, and
    differs from ``lm_loss`` over the whole batch (which also adds the
    auxiliary losses)."""
    model = _model("olmoe-1b-7b")
    params = params_from_jax(numpy_params(model, seed=5), device="cpu")
    batch = _torch_batch(_batch(model, seed=6))
    M = 4
    got = float(tpp.make_pp_loss(model, 2, M)(tpp.stage_params(params, 2), batch))
    nll_sum, count, drops = 0.0, 0.0, []
    for tok, lbl in zip(batch["tokens"].chunk(M), batch["labels"].chunk(M)):
        logits, aux = tlm.forward(params, model, tok)
        drops.append(float(aux["moe_drop_frac"]))
        mask = (lbl >= 0).float()
        nll = -torch.log_softmax(logits, -1).gather(-1, lbl.long().clamp(0)[..., None])[..., 0]
        nll_sum, count = nll_sum + float((nll * mask).sum()), count + float(mask.sum())
    np.testing.assert_allclose(got, nll_sum / count, rtol=LOSS_RTOL)
    assert min(drops) > 0
    # lm_loss routes the whole batch at once: other drops, another gradient
    _, metrics, plain = tstep.loss_and_grads(params, model, batch)
    assert float(metrics["moe_drop_frac"]) > 0
    assert abs(float(metrics["loss"]) - got) > 2 * LOSS_RTOL * abs(got)
    _, staged = _pp_loss_and_grads(model, params, batch, 2, M)
    want = plain["unit"][0]["moe"]["wi"]
    gap = (tpp.unstage_params(staged)["unit"][0]["moe"]["wi"] - want).abs().max()
    assert gap > 100 * GRAD_REL * want.abs().max()


def test_stage_params_matches_reference_layout():
    model = _model("kanformer-100m")
    p_np = numpy_params(dataclasses.replace(model, n_repeats=4), seed=7)
    want = flatten_with_paths(jax.device_get(jpp.stage_params(
        jax.tree.map(np.asarray, p_np), 2)))
    staged = tpp.stage_params(params_from_jax(p_np, device="cpu"), 2)
    got = flatten_with_paths(staged)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and np.array_equal(got[k].numpy(), np.asarray(w)), k
    back = flatten_with_paths(tpp.unstage_params(staged))
    for k, v in flatten_with_paths(p_np).items():
        assert np.array_equal(back[k].numpy(), v), k


REFUSALS = [
    ("zamba2-1.2b", 1, 1, "unit of one block"),
    ("gemma3-12b", 1, 1, "unit of one block"),
    ("xlstm-1.3b", 1, 1, "unit of one block"),
    ("deepseek-v2-lite", 1, 1, "no prologue, epilogue or shared"),
    ("musicgen-large", 1, 1, "KeyError: 'tokens'"),
    ("kanformer-100m", 4, 1, "equal stages"),
]


@pytest.mark.parametrize("arch,S,M,match", REFUSALS)
def test_pipeline_refuses_what_the_reference_cannot_run(arch, S, M, match):
    with pytest.raises(ValueError, match=match):
        tpp.make_pp_loss(tconfigs.get_reduced(arch).model, S, M)


def test_pipeline_refuses_a_batch_that_does_not_split():
    model = _model("kanformer-100m")
    params = params_from_jax(numpy_params(model, seed=8), device="cpu")
    fn = tpp.make_pp_loss(model, 2, 3)
    with pytest.raises(ValueError, match="does not split into 3 microbatches"):
        fn(tpp.stage_params(params, 2), _torch_batch(_batch(model, seed=9)))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_pipeline_equals_reference_make_pp_loss(reference_pipeline, arch):
    model, p_np, batch, want_loss, want_grads = reference_pipeline()[arch]
    loss, grads = _pp_loss_and_grads(model, params_from_jax(p_np, device="cpu"),
                                     _torch_batch(batch), 2, 4)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _assert_grads_close(grads, want_grads, arch)
