"""The port's paged KV cache against the JAX reference, on the CPU.

* The block-table gather: the port's plain version, one pool and every
  leaf of a cache (``ops.gather_views``), against the JAX package's
  ``gather_blocks_reference`` and its Pallas kernel in interpret mode,
  BITWISE (pure data movement), for fp32, bf16 and int8 pools, stacked and
  unstacked, with repeated sentinel ids and ids past the pool.
* The write routing and the data movement of the paged model functions
  (``paged_route``, ``paged_write_span``, ``writeback_paged_chunk``,
  ``paged_views``): integers and pools EQUAL.  Blocks other than the
  sentinel are compared; the sentinel takes every redirected write, in no
  defined order on either side, and is never attended.
* Paged decode and prefill (attention and the whole reduced kanformer):
  allclose at atol 1e-5 in fp32 with equal argmax.  The reference's own
  bitwise paged == dense claims fail on this jax, so the port is held to
  allclose (ROADMAP "Held against the reference").
* Host bookkeeping (``BlockPool``, ``PrefixCache``,
  ``ContinuousScheduler``, the prefix keys): both packages driven through
  the same seeded operation sequences make the same decisions.
"""

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import paged_gather as JG
from repro.models import attention as JA
from repro.models import lm as jlm
from repro.serve import kv_pool as jpool
from repro.serve import prefix_cache as jprefix
from repro.serve import scheduler as jsched
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import build, ops
from repro_torch.kernels import paged_gather as TG
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm
from repro_torch.serve import kv_pool as tpool
from repro_torch.serve import prefix_cache as tprefix
from repro_torch.serve import scheduler as tsched

ATOL = 1e-5
BS = 4                       # tokens per block
N_BLOCKS = 11
MAX_SEQ = 24                 # 6 logical blocks
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (np.float32, torch.bfloat16, jnp.bfloat16),
          "int8": (np.int8, torch.int8, jnp.int8)}


@pytest.fixture(scope="module")
def models():
    jmodel = jconfigs.get_reduced("kanformer-100m").model
    tmodel = tconfigs.get_reduced("kanformer-100m").model
    jparams = jlm.init_params(jax.random.PRNGKey(0), jmodel)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return jmodel, tmodel, jparams, tparams


def _pool_np(rs, shape, dtype):
    if dtype == "int8":
        return rs.randint(-128, 128, shape).astype(np.int8)
    return rs.randn(*shape).astype(np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values as a torch and a jax array of ``dtype``."""
    _, tdt, jdt = DTYPES[dtype]
    return torch.tensor(a).to(tdt), jnp.asarray(a).astype(jdt)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a) -> np.ndarray:
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _table(rs, B, L, n_blocks):
    """Distinct live blocks per row, the tail of some rows the sentinel 0."""
    ids = rs.permutation(np.arange(1, n_blocks))[: B * L].reshape(B, L)
    for b in range(B):
        ids[b, rs.randint(1, L + 1):] = 0
    return ids.astype(np.int32)


# --------------------------------------------------------------------- gather


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gather_equals_reference_and_interpret_kernel_bitwise(dtype, stacked):
    rs = np.random.RandomState(len(dtype) + stacked)
    shape = ((3,) if stacked else ()) + (N_BLOCKS, BS, 2, 8)
    pool_t, pool_j = _both(_pool_np(rs, shape, dtype), dtype)
    table = _table(rs, 2, 5, N_BLOCKS)
    table[0, 0] = table[1, 0] = 0                   # sentinel repeated across rows
    got = _np(TG.gather_blocks_reference(pool_t, torch.tensor(table), stacked))
    tj = jnp.asarray(table)
    layers = [pool_j[i] for i in range(3)] if stacked else [pool_j]
    for fn in (JG.gather_blocks_reference,
               lambda p, t: JG.gather_blocks_pallas(p, t, interpret=True)):
        want = np.stack([_jnp(fn(p, tj)) for p in layers])
        np.testing.assert_array_equal(got, want if stacked else want[0])
    assert got.shape == ((3,) if stacked else ()) + (2, 5 * BS, 2, 8)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gather_clips_ids_outside_the_pool(dtype):
    """Ids past the pool read its last block, as the interpret-mode Pallas
    kernel does; negative ids read block 0, as ``jnp.take(mode="clip")``
    does (the reference's plain version documents clipping; on this jax
    ``jnp.take`` defaults to filling, so it is not compared here)."""
    rs = np.random.RandomState(3)
    pool_t, pool_j = _both(_pool_np(rs, (N_BLOCKS, BS, 2, 8), dtype), dtype)
    high = np.array([[2, N_BLOCKS, N_BLOCKS + 7, 10**6]], np.int32)
    got = _np(TG.gather_blocks_reference(pool_t, torch.tensor(high)))
    want = _jnp(JG.gather_blocks_pallas(pool_j, jnp.asarray(high), interpret=True))
    np.testing.assert_array_equal(got, want)
    low = np.array([[-1, -5, 3]], np.int32)
    got = _np(TG.gather_blocks_reference(pool_t, torch.tensor(low)))
    want = _jnp(jnp.take(pool_j, jnp.asarray(low).reshape(-1), axis=0, mode="clip")
                .reshape((1, 3 * BS, 2, 8)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gather_views_equals_reference_and_interpret_kernel_leaf_by_leaf(dtype, stacked):
    """``ops.gather_views`` over a cache of three leaves (``k`` and ``v`` in
    ``dtype``, a float32 leaf of other block bytes), one id past the pool
    and one below it: each leaf equals ``jnp.take(mode="clip")`` on the
    table, and the JAX package's plain version and its interpret-mode
    Pallas kernel on the clipped table, bit for bit; on the CPU it counts
    no launch."""
    rs = np.random.RandomState(11 + len(dtype) + stacked)
    lead = (3,) if stacked else ()
    kv = lead + (N_BLOCKS, BS, 2, 8)
    shapes = {"k": (kv, dtype), "v": (kv, dtype), "scale": (lead + (N_BLOCKS, BS, 2), "float32")}
    cache_t, cache_j = {}, {}
    for name, (shape, dt) in shapes.items():
        cache_t[name], cache_j[name] = _both(_pool_np(rs, shape, dt), dt)
    table = _table(rs, 2, 5, N_BLOCKS)
    table[0, 1], table[1, 2] = N_BLOCKS + 4, -3
    ops.reset_launches()
    got = ops.gather_views(cache_t, torch.tensor(table), stacked)
    assert list(got) == list(shapes) and ops.LAUNCHES["gather_blocks"] == 0
    clipped = jnp.asarray(np.clip(table, 0, N_BLOCKS - 1))
    for name, pool_j in cache_j.items():
        trail = pool_j.shape[len(lead) + 1:]
        want = jnp.take(pool_j, jnp.asarray(table).reshape(-1), axis=len(lead), mode="clip")
        np.testing.assert_array_equal(_np(got[name]),
                                      _jnp(want.reshape(lead + (2, 5 * BS) + trail[1:])))
        layers = [pool_j[i] for i in range(3)] if stacked else [pool_j]
        for fn in (JG.gather_blocks_reference,
                   lambda p, t: JG.gather_blocks_pallas(p, t, interpret=True)):
            want = np.stack([_jnp(fn(p, clipped)) for p in layers])
            np.testing.assert_array_equal(_np(got[name]), want if stacked else want[0])


def test_gather_views_launcher_rejects_what_the_kernel_does_not_take():
    """More leaves than one launch takes, a mismatched table and a leaf
    off the table's device raise before anything is launched."""
    pool = torch.zeros(N_BLOCKS, BS, 2, 8)
    table = torch.zeros(2, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="1 to 4 leaves"):
        TG.gather_views_cuda([pool] * 5, table)
    with pytest.raises(ValueError, match="1 to 4 leaves"):
        TG.gather_views_cuda([], table)
    with pytest.raises(ValueError, match="table rank 2"):
        TG.gather_views_cuda([pool, pool], table[0])
    with pytest.raises(ValueError, match="int32"):
        TG.gather_views_cuda([pool, pool], table.long())
    with pytest.raises(ValueError, match="one CUDA device"):
        TG.gather_views_cuda([pool.to("meta"), pool], table.to("meta"))
    ops.reset_launches()
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.gather_views({"k": pool.to("meta"), "v": pool}, table)
    assert ops.LAUNCHES["gather_blocks"] == 0


def test_gather_wrapper_on_the_cpu_takes_the_plain_version_and_counts_nothing():
    pool = torch.randn(3, N_BLOCKS, BS, 2, 8)
    table = torch.tensor(_table(np.random.RandomState(0), 2, 5, N_BLOCKS))
    ops.reset_launches()
    got = ops.gather_blocks(pool, table, stacked=True)
    assert torch.equal(got, TG.gather_blocks_reference(pool, table, stacked=True))
    assert ops.LAUNCHES["gather_blocks"] == 0


def test_gather_off_the_cpu_never_takes_the_plain_version():
    """A tensor off the CPU goes to the CUDA launcher, which raises here
    (no card), and no launch is counted."""
    pool = torch.empty(N_BLOCKS, BS, 2, 8, device="meta")
    table = torch.empty(2, 5, dtype=torch.int32, device="meta")
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA device"):
        ops.gather_blocks(pool, table)
    assert ops.LAUNCHES["gather_blocks"] == 0


def test_gather_launcher_rejects_what_the_kernel_does_not_take():
    pool = torch.zeros(N_BLOCKS, BS, 2, 8)
    table = torch.zeros(2, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        TG.gather_views_cuda([pool.double()], table)
    with pytest.raises(ValueError, match="int32"):
        TG.gather_views_cuda([pool], table.long())
    with pytest.raises(ValueError, match="contiguous"):
        TG.gather_views_cuda([pool.transpose(2, 3)], table)
    with pytest.raises(ValueError, match="rank"):
        TG.gather_views_cuda([torch.zeros(N_BLOCKS, BS)], table, stacked=True)
    assert build.LIBRARIES["paged_gather"][0] == "paged_gather.cu"


# ------------------------------------------------------ routing and data movement


def test_paged_route_equals_reference():
    rs = np.random.RandomState(5)
    table = _table(rs, 3, MAX_SEQ // BS, N_BLOCKS + 10)
    positions = rs.randint(0, MAX_SEQ + 9, (3, 7)).astype(np.int32)
    valid = rs.rand(3, 7) < 0.7
    for v in (None, valid):
        jp, jo = JA.paged_route(jnp.asarray(table), jnp.asarray(positions), BS,
                                None if v is None else jnp.asarray(v))
        tp, to = TA.paged_route(torch.tensor(table), torch.tensor(positions), BS,
                                None if v is None else torch.tensor(v))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("per_row", [False, True])
def test_paged_write_span_equals_reference(per_row):
    rs = np.random.RandomState(6 + per_row)
    B, T = 3, 6
    table = _table(rs, B, MAX_SEQ // BS, N_BLOCKS + 10)
    pool = rs.randn(N_BLOCKS + 10, BS, 2, 8).astype(np.float32)
    val = rs.randn(B, T, 2, 8).astype(np.float32)
    start = rs.randint(0, MAX_SEQ, B) if per_row else 5
    lengths = rs.randint(1, MAX_SEQ + 4, B)
    jc = JA.paged_write_span({"k": jnp.asarray(pool)}, "k", jnp.asarray(val),
                             jnp.asarray(table), jnp.asarray(start), jnp.asarray(lengths),
                             False)
    tc = {"k": torch.tensor(pool)}
    TA.paged_write_span(tc, "k", torch.tensor(val), torch.tensor(table),
                        torch.tensor(start) if per_row else start, torch.tensor(lengths))
    np.testing.assert_array_equal(tc["k"].numpy()[1:], np.asarray(jc["k"])[1:])


def _pools(rs, model, n_blocks):
    """Random pools, the same values on both sides."""
    blk = model.unit[0].attn
    shape = (model.n_repeats, n_blocks, BS, blk.n_kv_heads, blk.head_dim)
    vals = {n: rs.randn(*shape).astype(np.float32) for n in ("k", "v")}
    return ({"unit": [{n: jnp.asarray(a) for n, a in vals.items()}]},
            {"unit": [{n: torch.tensor(a) for n, a in vals.items()}]})


def test_paged_views_and_writeback_equal_reference(models):
    jmodel, tmodel, _, _ = models
    rs = np.random.RandomState(8)
    jc, tc = _pools(rs, tmodel, N_BLOCKS + 10)
    table = _table(rs, 3, MAX_SEQ // BS, N_BLOCKS + 10)
    ops.reset_launches()
    tview = tlm.paged_views(tc, torch.tensor(table))
    jview = jlm.paged_views(jc, jnp.asarray(table))
    for n in ("k", "v"):
        np.testing.assert_array_equal(tview["unit"][0][n].numpy(),
                                      np.asarray(jview["unit"][0][n]))
    # a chunk's writes in the view, then written back (one row overruns
    # max_seq, so part of its span goes to the sentinel)
    pos0 = np.array([2, 9, MAX_SEQ - 2])
    steps = 5
    for n in ("k", "v"):
        new = rs.randn(*tview["unit"][0][n].shape).astype(np.float32)
        tview["unit"][0][n] = torch.tensor(new)
        jview["unit"][0][n] = jnp.asarray(new)
    jc = jlm.writeback_paged_chunk(jc, jview, jnp.asarray(table), jnp.asarray(pos0), steps)
    tlm.writeback_paged_chunk(tc, tview, torch.tensor(table), torch.tensor(pos0), steps)
    for n in ("k", "v"):
        np.testing.assert_array_equal(tc["unit"][0][n].numpy()[:, 1:],
                                      np.asarray(jc["unit"][0][n])[:, 1:])
    assert ops.LAUNCHES["gather_blocks"] == 0          # CPU: the plain version


# ------------------------------------------------------ paged decode and prefill


def _attn_params(models):
    jmodel, tmodel, jparams, tparams = models
    jp = jax.tree.map(lambda a: a[0], jparams["unit"][0]["attn"])
    tp = {k: v[0] for k, v in tparams["unit"][0]["attn"].items()}
    return jmodel.unit[0].attn, tmodel.unit[0].attn, jp, tp


def test_attn_decode_step_paged_matches_reference(models):
    jcfg, tcfg, jp, tp = _attn_params(models)
    rs = np.random.RandomState(9)
    B = 3
    pool = {n: rs.randn(N_BLOCKS + 10, BS, tcfg.n_kv_heads, tcfg.head_dim)
            .astype(np.float32) for n in ("k", "v")}
    table = _table(rs, B, MAX_SEQ // BS, N_BLOCKS + 10)
    table[:, :3] = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    pos = np.array([5, 11, 2])
    x = rs.randn(B, 1, tcfg.d_model).astype(np.float32)
    jy, jc = JA.attn_decode_step_paged(jp, jcfg, jnp.asarray(x),
                                       {n: jnp.asarray(a) for n, a in pool.items()},
                                       jnp.asarray(table), jnp.asarray(pos))
    tc = {n: torch.tensor(a) for n, a in pool.items()}
    ty, tc = TA.attn_decode_step_paged(tp, tcfg, torch.tensor(x), tc, torch.tensor(table),
                                       torch.tensor(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy()[1:], np.asarray(jc[n])[1:], atol=ATOL)


@pytest.mark.parametrize("view_blocks", [None, 4])
def test_attn_prefill_paged_suffix_matches_reference(models, view_blocks):
    """A suffix prefill at ``start = 4`` over a reused first block."""
    jcfg, tcfg, jp, tp = _attn_params(models)
    rs = np.random.RandomState(10)
    B, Ts, start = 2, 8, BS
    pool = {n: rs.randn(N_BLOCKS, BS, tcfg.n_kv_heads, tcfg.head_dim).astype(np.float32)
            for n in ("k", "v")}
    table = np.zeros((B, MAX_SEQ // BS), np.int32)
    table[0, :3] = [1, 2, 3]
    table[1, :3] = [1, 4, 5]                       # block 1: the shared prefix
    lengths = np.array([12, 9])
    x = rs.randn(B, Ts, tcfg.d_model).astype(np.float32)
    positions = start + np.arange(Ts)[None, :]
    jy, jc = JA.attn_prefill_paged(
        jp, jcfg, jnp.asarray(x), jnp.asarray(positions),
        {n: jnp.asarray(a) for n, a in pool.items()}, jnp.asarray(table),
        jnp.asarray(lengths), jnp.int32(start), view_blocks=view_blocks)
    tc = {n: torch.tensor(a) for n, a in pool.items()}
    ty, tc = TA.attn_prefill_paged(tp, tcfg, torch.tensor(x), torch.tensor(positions), tc,
                                   torch.tensor(table), torch.tensor(lengths), start,
                                   view_blocks=view_blocks)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy()[1:], np.asarray(jc[n])[1:], atol=ATOL)


def test_prefill_into_pages_and_paged_decode_match_reference(models):
    """Two admission groups (the second reuses the first's full prompt
    block, ``start = 4``), then 4 paged decode steps of all three rows."""
    jmodel, tmodel, jparams, tparams = models
    n_blocks = 16
    jc = jlm.init_paged_caches(jmodel, n_blocks, BS, jnp.float32)
    tc = tlm.init_paged_caches(tmodel, n_blocks, BS, torch.float32, "cpu")
    rs = np.random.RandomState(11)
    prompts = rs.randint(1, jmodel.vocab, (3, 11)).astype(np.int32)
    prompts[2, :BS] = prompts[0, :BS]
    lens = np.array([11, 7, 10])
    tables = np.zeros((3, MAX_SEQ // BS), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :4] = [5, 6, 7, 8]
    tables[2, :4] = [1, 9, 10, 11]

    def admit(rows, start, t_pad):
        nonlocal jc
        suffix = np.stack([np.pad(prompts[r, start:lens[r]], (0, t_pad - (lens[r] - start)))
                           for r in rows])
        vb = -(-(start + t_pad) // BS)
        jl, jc = jlm.prefill_into_pages(jparams, jmodel, jnp.asarray(suffix),
                                        jnp.asarray(lens[rows]), jnp.asarray(tables[rows]),
                                        jc, jnp.int32(start), jnp.float32, vb)
        tl, _ = tlm.prefill_into_pages(tparams, tmodel, torch.tensor(suffix),
                                       torch.tensor(lens[rows]), torch.tensor(tables[rows]),
                                       tc, start, torch.float32, vb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))

    admit([0, 1], 0, 16)
    admit([2], BS, 8)
    pos = lens.copy()
    for s in range(4):
        tok = rs.randint(1, jmodel.vocab, (3, 1)).astype(np.int32)
        jl, jc = jlm.decode_step(jparams, jmodel, jnp.asarray(tok), jc, jnp.asarray(pos),
                                 jnp.float32, jnp.asarray(tables))
        tl, tc = tlm.decode_step(tparams, tmodel, torch.tensor(tok), tc, torch.tensor(pos),
                                 torch.float32, torch.tensor(tables))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
        pos = pos + 1
    for n in ("k", "v"):
        np.testing.assert_allclose(tc["unit"][0][n].numpy()[:, 1:],
                                   np.asarray(jc["unit"][0][n])[:, 1:], atol=ATOL)


def test_paged_model_functions_refuse_what_they_cannot_page(models):
    _, tmodel, _, _ = models
    assert tlm.model_supports_paging(tmodel) and not tlm.model_kv_quant(tmodel)
    from repro_torch.models.attention import AttnConfig
    from repro_torch.models.blocks import BlockCfg, block_init_paged_cache

    windowed = BlockCfg("attn_kan", attn=AttnConfig(64, 4, 4, 16, window=8),
                        kan_grid=tmodel.unit[0].kan_grid, kan_ff=8)
    with pytest.raises(NotImplementedError, match="full-attention"):
        block_init_paged_cache(windowed, 4, BS, torch.float32, "cpu")


# ------------------------------------------------------------ host bookkeeping


def _drive_pool(pool_mod, prefix_mod, seed: int, n_ops: int, n_blocks: int, bs: int):
    """Random admissions (prompts from a few shared prefixes, so the cache
    hits), growth, releases, evictions, CoW forks and trims; returns the log
    of every decision and the final counters."""
    rs = np.random.RandomState(seed)
    pool = pool_mod.BlockPool(n_blocks, bs)
    cache = prefix_mod.PrefixCache(bs)
    heads = [rs.randint(0, 50, 3 * bs).astype(np.int32) for _ in range(3)]
    live: list[int] = []
    log: list = []
    rid = 0
    for _ in range(n_ops):
        op = rs.randint(6)
        if op <= 1:                                     # admit
            toks = np.concatenate([heads[rs.randint(3)][: rs.randint(0, 3 * bs + 1)],
                                   rs.randint(0, 50, rs.randint(1, 2 * bs)).astype(np.int32)])
            n_hit, blocks, keys = cache.match(toks)
            pool.share(rid, blocks)
            n_new = pool_mod.blocks_for(len(toks), bs) - n_hit
            while pool.free_count() < n_new and cache.evict_lru(pool) is not None:
                pass
            if pool.free_count() < n_new:
                pool.release_request(rid)
                log.append(("defer", rid, n_hit))
            else:
                row = blocks + pool.alloc(rid, n_new)
                cache.record_admission(n_hit, len(toks))
                for i, key in enumerate(keys):
                    if cache.insert(key, row[i]):
                        pool.cache_ref(row[i])
                live.append(rid)
                log.append(("admit", rid, n_hit, row, [k.hex() for k in keys]))
            rid += 1
        elif op == 2 and live:                          # grow by one block
            r = live[rs.randint(len(live))]
            if pool.free_count() >= 1:
                log.append(("grow", r, pool.alloc(r, 1)))
        elif op == 3 and live:                          # retire
            r = live.pop(rs.randint(len(live)))
            log.append(("release", r, pool.release_request(r)))
        elif op == 4:
            log.append(("evict", cache.evict_lru(pool)))
        elif op == 5 and live:                          # fork a block, or trim
            r = live[rs.randint(len(live))]
            owned = pool.owned_blocks(r)
            if owned and rs.rand() < 0.5 and pool.free_count() >= 1:
                log.append(("cow", r, pool.copy_on_write(r, rs.randint(len(owned)))))
            elif owned and pool.refcount(owned[-1]) == 1 and not cache.holds(owned[-1]):
                log.append(("trim", r, pool.trim_request(r, len(owned) - 1)))
        log.append(("state", pool.free_count(), pool.in_use(), pool.watermark))
        pool.check_balanced(n_live_requests=len(live))
    for r in live:
        pool.release_request(r)
    log.append(("flush", cache.flush(pool)))
    pool.check_balanced(n_live_requests=0)
    return log, pool.stats(), cache.stats()


@hypothesis.settings(max_examples=25, deadline=None)
@hypothesis.given(seed=st.integers(0, 10_000), n_ops=st.integers(5, 80),
                  n_blocks=st.integers(4, 24), bs=st.sampled_from([2, 4, 8]))
def test_block_pool_and_prefix_cache_decide_as_the_reference(seed, n_ops, n_blocks, bs):
    want = _drive_pool(jpool, jprefix, seed, n_ops, n_blocks, bs)
    got = _drive_pool(tpool, tprefix, seed, n_ops, n_blocks, bs)
    assert got == want


def _drive_scheduler(mod, seed: int, n_requests: int, slots: int, chunk: int):
    """Admission bursts, chunks with random EOS latches, and preemptions of
    the youngest live slot, until the queue drains."""
    rs = np.random.RandomState(seed)
    s = mod.ContinuousScheduler(slots, range(n_requests))
    log: list = []
    while s.has_work():
        for b, rid in s.admit_ready():
            done = s.confirm_admit(b, rid, pos=int(rs.randint(1, 20)),
                                   remaining=int(rs.randint(0, 12)),
                                   eos_hit=bool(rs.rand() < 0.1))
            log.append(("admit", b, rid, done))
            if done:
                s.retire(b)
        if rs.rand() < 0.2 and s.youngest_live_slot() is not None:
            victim = s.youngest_live_slot()
            log.append(("preempt", victim, s.preempt(victim)))
        if not s.can_run_chunk():
            continue
        hits = rs.rand(slots) < 0.15
        steps = np.where(hits, rs.randint(0, chunk, slots), chunk)
        for b, rid, n_keep, finished in s.complete_chunk(chunk, hits, steps):
            log.append(("chunk", b, rid, n_keep, finished))
            if finished:
                s.retire(b)
        s.check_invariants()
    s.check_invariants()
    return log, s.stats(), s.served


@hypothesis.settings(max_examples=25, deadline=None)
@hypothesis.given(seed=st.integers(0, 10_000), n_requests=st.integers(1, 12),
                  slots=st.integers(1, 4), chunk=st.integers(1, 6))
def test_scheduler_decides_as_the_reference(seed, n_requests, slots, chunk):
    want = _drive_scheduler(jsched, seed, n_requests, slots, chunk)
    got = _drive_scheduler(tsched, seed, n_requests, slots, chunk)
    assert got == want


@pytest.mark.parametrize("bs", [1, 4, 16])
def test_prefix_keys_and_block_counts_equal_reference(bs):
    toks = np.random.RandomState(bs).randint(0, 32000, 70).astype(np.int32)
    assert tprefix.block_keys(toks, bs) == jprefix.block_keys(toks, bs)
    for args in [(10, 5, 3, bs, 64), (30, 1, 8, bs, 32), (64, 40, 8, bs, 64)]:
        assert tpool.worst_case_blocks(*args) == jpool.worst_case_blocks(*args)
