"""The port's kanformer against the JAX reference, fp32 on the CPU.

The reduced kanformer-100m is built once in JAX (``lm.init_params``), its
parameters are carried across with ``repro_torch.convert.params_from_jax``,
and both sides run the same tokens.  Tolerances: layer outputs atol 1e-5;
logits and KV caches atol 1e-4 (fp32 sums over d=64 and the KAN contraction
taken in another order by XLA and by torch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.store import _flatten_with_paths
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.convert import flatten_with_paths, params_from_jax
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import lm as tlm

LOGIT_ATOL = 1e-4
LAYER_ATOL = 1e-5
MAX_SEQ = 32


@pytest.fixture(scope="module")
def models():
    jmodel = jconfigs.get_reduced("kanformer-100m").model
    tmodel = tconfigs.get_reduced("kanformer-100m").model
    jparams = jlm.init_params(jax.random.PRNGKey(0), jmodel)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return jmodel, tmodel, jparams, tparams


def _tok(seed, B, T, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (B, T)).astype(np.int32)


def test_reduced_configs_agree(models):
    jmodel, tmodel, _, _ = models
    jb, tb = jmodel.unit[0], tmodel.unit[0]
    assert (jmodel.d_model, jmodel.vocab, jmodel.n_repeats) == (
        tmodel.d_model, tmodel.vocab, tmodel.n_repeats)
    assert (jb.kan_ff, jb.kan_grid.G, jb.kan_grid.P) == (
        tb.kan_ff, tb.kan_grid.G, tb.kan_grid.P)
    assert (jb.attn.n_heads, jb.attn.n_kv_heads, jb.attn.head_dim) == (
        tb.attn.n_heads, tb.attn.n_kv_heads, tb.attn.head_dim)


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_init_params_tree_matches_abstract_params(which):
    jmodel = getattr(jconfigs, f"get_{'config' if which == 'full' else which}")(
        "kanformer-100m").model
    tmodel = getattr(tconfigs, f"get_{'config' if which == 'full' else which}")(
        "kanformer-100m").model
    want = {k: tuple(v.shape) for k, v in
            _flatten_with_paths(jlm.abstract_params(jmodel))[0].items()}
    got = {k: spec.shape for k, spec in
           flatten_with_paths(tlm.param_shapes(tmodel)).items()}
    assert got == want
    if which == "reduced":
        params = tlm.init_params(tmodel, seed=1, device="cpu")
        assert {k: tuple(v.shape) for k, v in flatten_with_paths(params).items()} == want
        again = tlm.init_params(tmodel, seed=1, device="cpu")
        for a, b in zip(flatten_with_paths(params).values(),
                        flatten_with_paths(again).values()):
            assert torch.equal(a, b)


def test_init_params_scales():
    """Normal leaves carry the reference's scales: 1/sqrt(fan_in) over all
    but the last axis by default (wq: d·heads), 1.0 for the embedding, 0.02
    for the KAN FFN."""
    tmodel = tconfigs.get_reduced("kanformer-100m").model
    p = tlm.init_params(tmodel, seed=0, device="cpu")
    d = tmodel.d_model
    assert abs(p["embed"]["table"].std().item() - 1.0) < 0.05
    want = (d * tmodel.unit[0].attn.n_heads) ** -0.5
    assert abs(p["unit"][0]["attn"]["wq"].std().item() - want) < 0.1 * want
    assert abs(p["unit"][0]["kan"]["c1"].std().item() - 0.02) < 0.002
    assert torch.equal(p["final_ln"]["scale"], torch.ones(d))


def test_params_from_jax_keys_and_flat_layout(models):
    _, _, jparams, tparams = models
    jflat, _ = _flatten_with_paths(jparams)
    tflat = flatten_with_paths(tparams)
    assert list(jflat) == list(tflat)
    for k in jflat:
        np.testing.assert_array_equal(np.asarray(jflat[k]), tflat[k].numpy())
    # the flat arrays.npz layout loads to the same tree
    again = params_from_jax({k: np.asarray(v) for k, v in jflat.items()}, device="cpu")
    for k, v in flatten_with_paths(again).items():
        assert torch.equal(v, tflat[k])


def test_rmsnorm_and_rotary_match_reference():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 3, 16).astype(np.float32)
    scale = rs.randn(16).astype(np.float32)
    np.testing.assert_allclose(
        TL.rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x)).numpy(),
        np.asarray(JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        atol=LAYER_ATOL)
    pos = np.array([[0, 1, 7, 31, 100]])
    tc, ts = TL.rotary_embedding(torch.tensor(pos), 16)
    jc, js = JL.rotary_embedding(jnp.asarray(pos), 16)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=LAYER_ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=LAYER_ATOL)
    np.testing.assert_allclose(
        TL.apply_rotary(torch.tensor(x[:1]), tc, ts).numpy(),
        np.asarray(JL.apply_rotary(jnp.asarray(x[:1]), jc, js)), atol=LAYER_ATOL)


@pytest.mark.parametrize("chunk,q_offset", [(4, 0), (64, 0), (3, 2)])
def test_flash_attention_matches_reference(chunk, q_offset):
    rs = np.random.RandomState(chunk)
    q = rs.randn(2, 6, 4, 8).astype(np.float32)
    k = rs.randn(2, 6 + q_offset, 2, 8).astype(np.float32)
    v = rs.randn(2, 6 + q_offset, 2, 8).astype(np.float32)
    got = TA.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                             q_offset=q_offset, chunk=chunk)
    want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_offset=q_offset, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL)


def _caches_close(tcaches, jcaches):
    for tc, jc in zip(tcaches["unit"], jcaches["unit"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                       atol=LOGIT_ATOL)


def test_prefill_logits_and_caches_match_reference(models):
    jmodel, tmodel, jparams, tparams = models
    toks = _tok(1, 3, 11, jmodel.vocab)
    jlog, jcaches = jlm.prefill(jparams, jmodel, {"tokens": jnp.asarray(toks)},
                                MAX_SEQ, jnp.float32)
    tlog, tcaches = tlm.prefill(tparams, tmodel, torch.tensor(toks), MAX_SEQ,
                                torch.float32)
    assert tlog.shape == (3, 11, tmodel.vocab) and tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    assert tcaches["unit"][0]["k"].shape == jcaches["unit"][0]["k"].shape
    _caches_close(tcaches, jcaches)


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_steps_match_reference(models, ragged):
    """4 decode steps after prefill: scalar pos (every row at T) or per-row
    pos (right-padded rows starting at their own lengths)."""
    jmodel, tmodel, jparams, tparams = models
    B, T = 3, 9
    toks = _tok(2, B, T, jmodel.vocab)
    _, jc = jlm.prefill(jparams, jmodel, {"tokens": jnp.asarray(toks)},
                        MAX_SEQ, jnp.float32)
    _, tc = tlm.prefill(tparams, tmodel, torch.tensor(toks), MAX_SEQ, torch.float32)
    lens = np.array([9, 4, 6]) if ragged else None
    step_toks = _tok(3, 4, B, jmodel.vocab)
    for s in range(4):
        if ragged:
            jpos, tpos = jnp.asarray(lens + s), torch.tensor(lens + s)
        else:
            jpos, tpos = jnp.asarray(T + s, jnp.int32), torch.tensor(T + s)
        tok = step_toks[s][:, None]
        jlog, jc = jlm.decode_step(jparams, jmodel, jnp.asarray(tok), jc, jpos,
                                   jnp.float32)
        tlog, tc = tlm.decode_step(tparams, tmodel, torch.tensor(tok), tc, tpos,
                                   torch.float32)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL)
    _caches_close(tc, jc)


def test_unported_variants_raise():
    """What the port still refuses: block kinds and input kinds the
    reference does not have.  Every block kind is ported (the recurrent
    ``mamba2``, ``mlstm`` and ``slstm`` too), and so are shared blocks,
    windows, int8 KV caches, q/k norm, MLA and the non-token inputs
    (``embeddings``, ``mixed``)."""
    from repro_torch.models.attention import AttnConfig
    from repro_torch.models.blocks import BlockCfg
    from repro_torch.models.blocks import check_supported as blk_check
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.ssm import Mamba2Config
    from repro_torch.models.xlstm import XLSTMConfig

    attn = AttnConfig(64, 4, 4, 16)
    blk_check(BlockCfg("mamba2", mamba=Mamba2Config(64)))
    for kind in ("mlstm", "slstm"):
        blk_check(BlockCfg(kind, xlstm=XLSTMConfig(64)))
    blk_check(BlockCfg("attn_mlp", attn=attn, d_ff=8, shared_id=0))
    with pytest.raises(NotImplementedError, match="'conv_lstm' is not a block kind"):
        blk_check(BlockCfg("conv_lstm", attn=attn, d_ff=8))
    moe = MoEConfig(d_model=64, d_ff=8, n_experts=4, top_k=2)
    for ok in (AttnConfig(64, 4, 4, 16, window=8), AttnConfig(64, 4, 4, 16, kv_quant=True),
               AttnConfig(64, 4, 4, 16, qk_norm=True), AttnConfig(64, 4, 4, 16, kv_lora_rank=32)):
        blk_check(BlockCfg("attn_mlp", attn=ok, d_ff=8))
        blk_check(BlockCfg("attn_moe", attn=ok, moe=moe))
    from repro_torch.models.lm import ModelConfig, check_supported

    model = ModelConfig("m", 64, 32, unit=(BlockCfg("attn_mlp", attn=attn, d_ff=8),),
                        n_repeats=1, prologue=(BlockCfg("attn_moe", attn=attn, moe=moe),))
    check_supported(model)
    check_supported(dataclasses.replace(model, shared=(BlockCfg("attn_mlp", attn=attn, d_ff=8),)))
    for kind in ("embeddings", "mixed"):            # ported: the non-token inputs
        check_supported(dataclasses.replace(model, input_kind=kind))
    with pytest.raises(ValueError, match="input_kind 'audio' is not one of"):
        check_supported(dataclasses.replace(model, input_kind="audio"))
    with pytest.raises(NotImplementedError, match="not a block kind"):
        check_supported(dataclasses.replace(
            model, shared=(BlockCfg("conv_lstm", attn=attn, d_ff=8),)))


def test_per_row_cache_write_past_max_seq_is_dropped(models):
    """A per-row decode position at ``max_seq`` writes nothing, as the
    reference's scatter drops it (continuous batching's fixed-length chunks
    decode a finished row past the cache).  Both ``attn_decode_step``s give
    the same cache, that row's cache row is untouched, and the live rows'
    outputs match."""
    jmodel, tmodel, jparams, tparams = models
    jcfg, tcfg = jmodel.unit[0].attn, tmodel.unit[0].attn
    jp = jax.tree.map(lambda a: a[0], jparams["unit"][0]["attn"])
    tp = {k: v[0] for k, v in tparams["unit"][0]["attn"].items()}
    B, S = 3, 8
    rs = np.random.RandomState(7)
    x = rs.randn(B, 1, jmodel.d_model).astype(np.float32)
    cache = {n: rs.randn(B, S, tcfg.n_kv_heads, tcfg.head_dim).astype(np.float32)
             for n in ("k", "v")}
    pos = np.array([3, S, 5])
    jy, jc = JA.attn_decode_step(jp, jcfg, jnp.asarray(x),
                                 {n: jnp.asarray(a) for n, a in cache.items()},
                                 jnp.asarray(pos, jnp.int32))
    tc = {n: torch.tensor(a) for n, a in cache.items()}
    ty, tc = TA.attn_decode_step(tp, tcfg, torch.tensor(x), tc, torch.tensor(pos))
    for n in ("k", "v"):
        np.testing.assert_array_equal(tc[n][1].numpy(), cache[n][1])
        np.testing.assert_array_equal(np.asarray(jc[n])[1], cache[n][1])
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), atol=LAYER_ATOL)
    live = [0, 2]
    np.testing.assert_allclose(ty.numpy()[live], np.asarray(jy)[live], atol=LAYER_ATOL)
