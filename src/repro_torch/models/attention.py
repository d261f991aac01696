"""GQA attention with a KV cache, in PyTorch (the GQA half of
``repro/models/attention.py``).

* :func:`flash_attention` — online softmax over KV chunks, written in plain
  torch ops (the reference is plain jnp too; no attention kernel is owed),
  with an optional sliding ``window``;
* :func:`attn_forward` — prefill attention that also returns the post-rotary
  K/V the decode cache stores;
* :func:`attn_decode_step` — one token against the cache.  The cache is
  written IN PLACE (the torch analogue of the reference's buffer donation):
  a scalar ``pos`` writes one slot for every row, a per-row ``(B,)`` ``pos``
  writes each row at its own slot, and a row whose slot is past the cache
  writes nothing (the reference's scatter drops it).  A windowed layer's
  cache is a ring of ``window`` slots, written at ``pos % window``;
* :func:`attn_verify_window` and :func:`attn_verify_window_paged` — a
  speculative verify window of W tokens per row in one pass, each query
  masked at its own position as the sequential decode step masks it;
* the paged KV cache (DESIGN.md §3b): :func:`paged_view`,
  :func:`paged_route`, :func:`paged_write_span`,
  :func:`attn_decode_step_paged` and :func:`attn_prefill_paged`.  Pools
  ``(n_blocks, bs, KV, D)`` are written in place with ``index_put_``; reads
  gather the logical view with the block-table kernel
  (``kernels.ops.gather_views``) and run the unchanged dense math on it.

With ``AttnConfig.kv_quant`` a cache holds int8 ``k``/``v`` leaves and fp32
per-(token, KV head) ``k_scale``/``v_scale`` leaves (:func:`_kv_quantize`),
and the decode reads dequantise chunk by chunk inside an online softmax, as
the reference does.  ``AttnConfig.qk_norm`` RMS-normalises q and k per head
before rotary (gemma3).

On a mesh (``shard``) a rank computes its local heads: ``wq``/``wo`` are
sharded on ``heads`` and ``wk``/``wv`` on ``kv_heads`` where the model axis
divides them, so ``wo`` gives a partial sum and one ``all_reduce`` over
``model`` completes it; the caches hold the local KV heads.  Where the
heads divide and the KV heads do not (the K/V weights and caches whole on
every rank), each local query head reads its own KV head
(:func:`_local_attn`).  A paged pool whose ``kv_blocks`` the data axis
splits is read by gathering this rank's blocks, zeros elsewhere, and one
``all_reduce`` over ``data``; a write lands only in the rank that owns its
block.  An MLA layer on a mesh keeps the reference's placement: ``wq``,
``w_uk``, ``w_uv`` and ``wo`` on ``heads``, and ``w_dkv``, ``kv_norm`` and
the latent cache on ``kv_lora``, so each model rank holds ``(r + rope) /
M`` columns of every cached latent row (columns that need not line up
with ``r`` or with the rotary halves).  Prefill computes the latent whole
and caches this rank's columns; :func:`mla_decode_step` contracts over the
split latent without gathering the cache (:func:`_mla_split_read`).
Windowed layers and the verify window take no mesh.

MLA (DeepSeek-V2's multi-head latent attention, ``kv_lora_rank``):
:func:`attn_forward` runs it through :func:`_mla_forward`, whose cache is
the UNNORMALISED ``r``-dim latent beside the rotated ``rope``-dim key, one
``(B, S, r + rope)`` leaf ``ckv`` for all heads; :func:`mla_decode_step`
normalises the whole latent cache on read and scores it with the absorbed
``w_uk``/``w_uv`` weights.  The paged and verify-window entry points refuse
windowed and MLA layers, as the reference asserts.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L

NEG_INF = -1e30
# the int8 KV cache's flash-decode chunk (the reference's min(8192, S))
QUANT_CHUNK = 8192


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    window: int | None = None
    rope_theta: float = 10000.0
    qk_norm: bool = False
    kv_lora_rank: int | None = None
    qk_rope_dim: int = 64
    kv_quant: bool = False

    def cache_len(self, max_seq: int) -> int:
        return min(max_seq, self.window) if self.window else max_seq


def _attn_axes(cfg: AttnConfig) -> dict:
    """Logical axes and whole shape of each attention leaf (GQA or MLA)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.kv_lora_rank is not None:
        r, rope = cfg.kv_lora_rank, cfg.qk_rope_dim
        return {"wq": (("embed", "heads", "head_dim"), (d, H, hd + rope)),
                "w_dkv": (("embed", "kv_lora"), (d, r + rope)),
                "w_uk": (("kv_lora", "heads", "head_dim"), (r, H, hd)),
                "w_uv": (("kv_lora", "heads", "head_dim"), (r, H, hd)),
                "wo": (("heads", "head_dim", "embed"), (H, hd, d)),
                "kv_norm": (("kv_lora",), (r,)),
                "q_norm": (("head_dim",), (hd,)), "k_norm": (("head_dim",), (hd,))}
    return {"wq": (("embed", "heads", "head_dim"), (d, H, hd)),
            "wk": (("embed", "kv_heads", "head_dim"), (d, KV, hd)),
            "wv": (("embed", "kv_heads", "head_dim"), (d, KV, hd)),
            "wo": (("heads", "head_dim", "embed"), (H, hd, d)),
            "bq": (("heads", "head_dim"), (H, hd)),
            "bk": (("kv_heads", "head_dim"), (KV, hd)),
            "bv": (("kv_heads", "head_dim"), (KV, hd)),
            "q_norm": (("head_dim",), (hd,)), "k_norm": (("head_dim",), (hd,))}


def _local_attn(params: dict, cfg: AttnConfig, shard, keep: tuple = ()):
    """The weights as this rank computes with them -> ``(weights, kv,
    partial)``: leaves sharded on ``heads``/``kv_heads`` stay local, and so
    do the leaves named in ``keep``; any other shard is gathered whole
    (an MLA layer's ``w_dkv`` and ``kv_norm``, and its ``wq``/``w_uk``/
    ``w_uv``/``wo`` where the model axis does not divide the heads); ``kv``
    the KV head of each local query head when the heads are split and the
    KV heads are not (else None); ``partial`` whether the output projection
    gives a partial sum over ``model``.  With split heads the whole
    computation is local to the rank, so a whole leaf (the MQA pairing's
    K/V weights, a replicated bias, MLA's latent projection) enters it
    through ``copy_to_model``: its gradient is the sum of every rank's
    heads' share."""
    if shard is None:
        return params, None, False
    if cfg.window is not None:
        raise NotImplementedError("a mesh serves full-attention layers only")
    axes = _attn_axes(cfg)
    heads = shard.model_split(*axes["wq"]) == "heads"
    kv_heads = cfg.kv_lora_rank is None and shard.model_split(*axes["wk"]) == "kv_heads"
    local = {name for name, split in (("heads", heads), ("kv_heads", kv_heads)) if split}

    def mine(n):
        return n in keep or bool(local & set(axes[n][0]))

    p = {n: w if mine(n) else shard.gather_whole(w, *axes[n]) for n, w in params.items()}
    if heads:
        p = {n: w if mine(n) else shard.copy_to_model(w) for n, w in p.items()}
    kv = None
    if heads and not kv_heads:
        n = cfg.n_heads // shard.size("model")
        first = shard.coord("model") * n
        kv = torch.div(first + torch.arange(n, device=params["wq"].device),
                       cfg.n_heads // cfg.n_kv_heads, rounding_mode="floor")
    return p, kv, heads


def _pick(cache: dict, kv) -> dict:
    """Each local query head's KV head of ``(B, S, KV, ...)`` leaves."""
    return cache if kv is None else {n: a.index_select(2, kv) for n, a in cache.items()}


def _finish(y: torch.Tensor, partial: bool, shard) -> torch.Tensor:
    return shard.reduce_from(y, "model") if partial else y


def _check_full_attention(cfg: AttnConfig, what: str) -> None:
    """The paged and verify-window paths take full-attention GQA layers
    only (no window, no MLA latent), as the reference asserts."""
    if cfg.window is not None or cfg.kv_lora_rank is not None:
        raise NotImplementedError(f"{what} supports full-attention GQA layers only")


class _NormScale(torch.autograd.Function):
    """``xn * scale`` in ``xn``'s dtype (fp32, as the reference's q/k norm,
    or fp64 for MLA's latent norm at fp64 compute), whose scale gradient
    sums the rows' products in fp64 and rounds once to the scale's dtype: a
    mesh's split of the heads over ``model`` and of the rows over ``data``
    then moves it by no fp32 rounding (an fp64 step stays within fp64
    roundings of the unmeshed one)."""

    @staticmethod
    def forward(ctx, xn, scale):
        ctx.save_for_backward(xn, scale)
        return xn * scale.to(xn.dtype)

    @staticmethod
    def backward(ctx, g):
        xn, scale = ctx.saved_tensors
        wide = torch.float64  # kanlint: ignore[KL103] (the scale gradient's row sum)
        gs = (g.to(wide) * xn.to(wide)).reshape(-1, xn.shape[-1]).sum(0)
        return g * scale.to(xn.dtype), gs.to(scale.dtype)


def _qk_rmsnorm(x: torch.Tensor, scale: torch.Tensor, wide=torch.float32) -> torch.Tensor:
    """RMS norm over the last dim computed in ``wide`` (fp32: the
    reference's q/k norm), cast back to ``x``'s dtype."""
    xf = x.to(wide)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + 1e-6)
    if torch.is_grad_enabled() and scale.requires_grad:
        return _NormScale.apply(xn, scale).to(x.dtype)
    return (xn * scale.to(wide)).to(x.dtype)


def _kv_norm(c: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """MLA's latent norm: fp32 as the reference's, fp64 at fp64 compute (as
    ``layers.rmsnorm``), so that an fp64 decode whose latent columns are
    split over ``model`` (:func:`_mla_split_read`) carries no fp32 sum
    whose order depends on the mesh."""
    return _qk_rmsnorm(c, scale, L._wide(c.dtype))


def flash_attention(
    q: torch.Tensor,                  # (B, Tq, H, D)
    k: torch.Tensor,                  # (B, Tk, KV, D)
    v: torch.Tensor,                  # (B, Tk, KV, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks; O(Tq·chunk) live memory.
    With ``window``, query position ``t`` sees key positions ``> t - window``."""
    B, Tq, H, D = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    rep = H // KV
    scale = 1.0 / math.sqrt(D)
    chunk = min(chunk, Tk)
    n_chunks = math.ceil(Tk / chunk)
    dev = q.device
    q_pos = q_offset + torch.arange(Tq, device=dev)
    qh = q.reshape(B, Tq, KV, rep, D)
    m = torch.full((B, KV, rep, Tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, rep, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, rep, Tq, Dv), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        kv_pos = ci * chunk + torch.arange(kb.shape[1], device=dev)
        s = torch.einsum("btgrd,bsgd->bgrts", qh, kb) * scale
        mask = kv_pos[None, :] <= q_pos[:, None] if causal else None
        if window is not None:
            inside = kv_pos[None, :] > q_pos[:, None] - window
            mask = inside if mask is None else mask & inside
        s = s.float() if mask is None else torch.where(mask, s.float(), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrts,bsgd->bgrtd", p.to(vb.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, Dv).to(q.dtype)


def _project_qkv(
    params: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """QKV projection + bias + q/k norm + rotary at absolute ``positions``."""
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(x.dtype))
    k = torch.einsum("btd,dhk->bthk", x, params["wk"].to(x.dtype))
    v = torch.einsum("btd,dhk->bthk", x, params["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = _qk_rmsnorm(q, params["q_norm"])
        k = _qk_rmsnorm(k, params["k_norm"])
    cos, sin = L.rotary_embedding(positions, cfg.head_dim, cfg.rope_theta, x.dtype)
    return L.apply_rotary(q, cos, sin), L.apply_rotary(k, cos, sin), v


def attn_forward(
    params: dict,
    cfg: AttnConfig,
    x: torch.Tensor,                  # (B, T, d_model)
    *,
    positions: torch.Tensor | None = None,
    chunk: int = 1024,
    return_cache: bool = False,
    shard=None,
):
    """Prefill attention; with ``return_cache`` also what the decode cache
    stores: the post-rotary K/V (this rank's KV heads on a mesh), or MLA's
    latent (:func:`_mla_forward`; this rank's ``kv_lora`` columns of it on
    a mesh that splits them)."""
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    params, kv_of, partial = _local_attn(params, cfg, shard)
    if partial:
        x = shard.copy_to_model(x)
    if cfg.kv_lora_rank is not None:
        y, ckv = _mla_forward(params, cfg, x, positions, chunk)
        y = _finish(y, partial, shard)
        if return_cache:
            cols = _latent_cols(cfg, shard)
            return y, {"ckv": ckv if cols is None else ckv[..., cols[0]:sum(cols)]}
        return y
    q, k, v = _project_qkv(params, cfg, x, positions)
    kq = _pick({"k": k, "v": v}, kv_of)
    o = flash_attention(q, kq["k"], kq["v"], causal=True, window=cfg.window, chunk=chunk)
    y = _finish(torch.einsum("bthk,hkd->btd", o, params["wo"].to(x.dtype)), partial, shard)
    if return_cache:
        return y, {"k": k, "v": v}
    return y


def _latent_cols(cfg: AttnConfig, shard) -> tuple[int, int] | None:
    """``(first, count)`` of the latent columns (of ``r + rope``) this
    rank's MLA cache holds, or None where they are whole on every rank."""
    if shard is None:
        return None
    return shard.model_range(("kv_lora",), (cfg.kv_lora_rank + cfg.qk_rope_dim,))


def _mla_forward(params: dict, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor,
                 chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """MLA prefill -> ``(y, latent)``: queries of ``head_dim + rope`` dims
    per head; keys and values expanded from the normalised latent by
    ``w_uk``/``w_uv``, the rotated rope key shared by every head.  The
    latent the cache keeps, ``(B, T, r + rope)``, is the one before its norm
    (``mla_decode_step`` normalises on read) with its rope part rotated."""
    hd, rope, r = cfg.head_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(x.dtype))
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    ckv = x @ params["w_dkv"].to(x.dtype)                      # (B, T, r + rope)
    c_kv = _kv_norm(ckv[..., :r], params["kv_norm"])
    k_nope = torch.einsum("btr,rhk->bthk", c_kv, params["w_uk"].to(x.dtype))
    v = torch.einsum("btr,rhk->bthk", c_kv, params["w_uv"].to(x.dtype))
    cos, sin = L.rotary_embedding(positions, rope, cfg.rope_theta, x.dtype)
    q_rope = L.apply_rotary(q_rope, cos, sin)
    k_rope1 = L.apply_rotary(ckv[..., None, r:], cos, sin)[..., 0, :]   # (B, T, rope)
    k_rope = k_rope1[..., None, :].expand(k_nope.shape[:-1] + (rope,))
    o = flash_attention(torch.cat([q_nope, q_rope], -1), torch.cat([k_nope, k_rope], -1),
                        v, causal=True, chunk=chunk)
    y = torch.einsum("bthk,hkd->btd", o, params["wo"].to(x.dtype))
    return y, torch.cat([ckv[..., :r], k_rope1], -1)


def _kv_quantize(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(..., KV, D)`` -> int8 values and a per-``(..., KV)`` fp32 scale,
    op for op the reference's (``torch.round`` rounds half to even, as
    ``jnp.round`` does)."""
    kf = k.float()
    scale = torch.clamp_min(kf.abs().amax(-1), 1e-6) / 127.0
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _read_cache(cache: dict, name: str, quant: bool, dtype) -> torch.Tensor:
    """A cache leaf in ``dtype``, dequantised under an int8 cache."""
    if quant:
        return (cache[name].float() * cache[name + "_scale"][..., None]).to(dtype)
    return cache[name].to(dtype)


def _put_rows(buf: torch.Tensor, v: torch.Tensor, slot: torch.Tensor) -> None:
    """``buf[b, slot[b]] = v[b]`` in place, for rows whose slot is inside
    the cache: a row whose slot is ``>= S`` rewrites slot ``S-1`` with the
    value it already holds, so nothing changes and nothing syncs with the
    host."""
    rows = torch.arange(v.shape[0], device=buf.device)
    S = buf.shape[1]
    keep = (slot < S).reshape((-1,) + (1,) * (v.dim() - 1))
    slot_in = torch.clamp_max(slot, S - 1)
    buf[rows, slot_in] = torch.where(keep, v, buf[rows, slot_in])


def _write_cache(cache: dict, name: str, val: torch.Tensor,
                 slot: torch.Tensor, quant: bool = False) -> None:
    """Write one token's K or V (``val (B, 1, KV, D)``) into ``cache[name]``
    in place: at one shared slot (scalar ``slot``) or per row (``(B,)``).
    Under ``quant`` the int8 values go to ``cache[name]`` and their scales
    to ``cache[name + "_scale"]``.

    Per row, a slot ``>= S`` writes nothing to either leaf, as the
    reference's scatter drops it: continuous batching's fixed-length chunks
    decode a finished row past ``max_seq``."""
    if quant:
        qv, sc = _kv_quantize(val)
        leaves = ((cache[name], qv[:, 0]), (cache[name + "_scale"], sc[:, 0]))
    else:
        leaves = ((cache[name], val[:, 0].to(cache[name].dtype)),)
    for buf, v in leaves:
        if slot.dim() == 0:
            buf[:, slot] = v
        else:
            _put_rows(buf, v, slot)


def attn_decode_step(
    params: dict,
    cfg: AttnConfig,
    x: torch.Tensor,                  # (B, 1, d_model)
    cache: dict,                      # {"k", "v"[, "k_scale", "v_scale"]}: (B, S, ...)
    pos: torch.Tensor,                # scalar or (B,) absolute position
    shard=None,
) -> tuple[torch.Tensor, dict]:
    """One-token decode against a pre-filled KV cache.  A windowed layer
    writes its ring slot ``pos % S``; rotary is applied before caching, so
    the read needs no slot positions."""
    B = x.shape[0]
    pos_b = pos.expand(B) if pos.dim() == 0 else pos
    params, kv_of, partial = _local_attn(params, cfg, shard)
    q, k, v = _project_qkv(params, cfg, x, pos_b[:, None])
    slot = torch.remainder(pos, cache["k"].shape[1]) if cfg.window else pos
    _write_cache(cache, "k", k, slot, cfg.kv_quant)
    _write_cache(cache, "v", v, slot, cfg.kv_quant)
    y = _cache_attend(params, cfg, x, _pick(cache, kv_of), q, pos_b)
    return _finish(y, partial, shard), cache


def mla_decode_step(
    params: dict,
    cfg: AttnConfig,
    x: torch.Tensor,                  # (B, 1, d_model)
    cache_ckv: torch.Tensor,          # (B, S, r + rope) latent cache, written in place
    pos: torch.Tensor,                # scalar or (B,) absolute position
    shard=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MLA decode: write the token's latent (unnormalised) and rotated rope
    key at ``pos`` (per row, a slot ``>= S`` writes nothing, as the
    reference's scatter drops it), then attend the whole cache with the
    absorbed weights: ``score = (q_nope W_uk)·norm(c) + q_rope·k_rope`` over
    ``sqrt(head_dim + rope)``, and ``((p·norm(c)) W_uv) W_o``.

    On a mesh whose model axis splits the latent (``cache_ckv`` this rank's
    columns), the new row is computed from this rank's ``w_dkv`` columns,
    gathered whole (rotary pairs may lie on two ranks), rotated, and its
    columns written; the read contracts over the split columns
    (:func:`_mla_split_read`) and never gathers the cache.  Where the
    latent is whole on every rank, the unmeshed operations run on this
    rank's heads."""
    B = x.shape[0]
    S = cache_ckv.shape[1]
    pos_b = pos.expand(B) if pos.dim() == 0 else pos
    r, rope, hd = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.head_dim
    cols = _latent_cols(cfg, shard)
    params, _, partial = _local_attn(params, cfg, shard, keep=("w_dkv",) if cols else ())
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(x.dtype))
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    ckv_new = x @ params["w_dkv"].to(x.dtype)                  # (B, 1, r + rope)
    if cols is not None:
        ckv_new = shard.gather(ckv_new, (None, None, "model"), (B, 1, r + rope))
    cos, sin = L.rotary_embedding(pos_b[:, None], rope, cfg.rope_theta, x.dtype)
    q_rope = L.apply_rotary(q_rope, cos, sin)
    rotated = L.apply_rotary(ckv_new[..., None, r:], cos, sin)[..., 0, :]
    ckv_new = torch.cat([ckv_new[..., :r], rotated], -1)
    if cols is not None:
        ckv_new = ckv_new[..., cols[0]:sum(cols)]
    _write_cache({"ckv": cache_ckv}, "ckv", ckv_new, pos)
    q_abs = torch.einsum("bthk,rhk->bthr", q_nope, params["w_uk"].to(x.dtype))
    if cols is not None:
        o_lat = _mla_split_read(params, cfg, shard, cache_ckv, q_abs[:, 0], q_rope[:, 0],
                                pos_b, cols, partial)
    else:
        c_kv = _kv_norm(cache_ckv[..., :r].to(x.dtype), params["kv_norm"])   # (B, S, r)
        k_rope = cache_ckv[..., r:].to(x.dtype)                              # (B, S, rope)
        s = torch.einsum("bhr,bsr->bhs", q_abs[:, 0], c_kv)
        s = s + torch.einsum("bhk,bsk->bhs", q_rope[:, 0], k_rope)
        s = s / math.sqrt(hd + rope)
        mask = torch.arange(S, device=x.device)[None, :] <= pos_b[:, None]
        s = torch.where(mask[:, None], s.float(), NEG_INF)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        o_lat = torch.einsum("bhs,bsr->bhr", p, c_kv)             # (B, H, r)
    o = torch.einsum("bhr,rhk->bhk", o_lat, params["w_uv"].to(x.dtype))
    y = torch.einsum("bhk,hkd->bd", o, params["wo"].to(x.dtype))[:, None]
    return _finish(y, partial, shard), cache_ckv


def _mla_split_read(params: dict, cfg: AttnConfig, shard, cache_ckv: torch.Tensor,
                    q_abs: torch.Tensor, q_rope: torch.Tensor, pos_b: torch.Tensor,
                    cols: tuple[int, int], heads: bool) -> torch.Tensor:
    """:func:`mla_decode_step`'s read of a latent split over ``model`` ->
    ``o_lat = p·norm(c)`` of this rank's heads, ``(B, H_local, r)``.

    Each query is the ``r + rope``-dim ``u = [q_nope·W_uk, q_rope]``, laid
    out as the latent's columns, so the score is ``u·[norm(c), k_rope]``
    summed over columns, and each rank sums over its own: the norm's
    ``Σc²`` over this rank's latent columns, summed over ``model``
    (``(B, S)``); ``u`` of every head gathered where the heads are split
    (``(B, H, r + rope)``); the partial scores summed over ``model``
    (``(B, H, S)``); the mask and softmax on every rank; ``p·norm(c)`` on
    this rank's latent columns, gathered whole (``(B, H, r)``).  ``heads``:
    whether this rank holds a block of the heads (``q_abs``/``q_rope``
    those heads' rows) or all of them."""
    r, rope, hd = cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.head_dim
    c0, n = cols
    nl = max(0, min(c0 + n, r) - c0)      # latent columns first, then rope ones
    B, S = cache_ckv.shape[:2]
    H, Hl = cfg.n_heads, q_abs.shape[1]
    dt = q_abs.dtype
    wide = L._wide(dt)
    c = cache_ckv.to(dt)
    lat = c[..., :nl].to(wide)
    ss = shard.all_reduce((lat * lat).sum(-1), "model")               # Σc²: (B, S)
    c_norm = (lat * torch.rsqrt(ss[..., None] / r + 1e-6)
              * params["kv_norm"][c0:c0 + nl].to(wide)).to(dt)       # (B, S, nl)
    u = torch.cat([q_abs, q_rope], -1)                                 # (B, Hl, r + rope)
    if heads:
        u = shard.gather(u.contiguous(), (None, "model", None), (B, H, r + rope))
    s = torch.einsum("bhj,bsj->bhs", u[..., c0:c0 + n], torch.cat([c_norm, c[..., nl:]], -1))
    s = shard.all_reduce(s.contiguous(), "model") / math.sqrt(hd + rope)
    mask = torch.arange(S, device=c.device)[None, :] <= pos_b[:, None]
    s = torch.where(mask[:, None], s.float(), NEG_INF)
    p = torch.softmax(s, dim=-1).to(dt)
    o_lat = torch.zeros((B, H, r), dtype=dt, device=c.device)
    o_lat[..., c0:c0 + nl] = torch.einsum("bhs,bsj->bhj", p, c_norm)
    o_lat = shard.all_reduce(o_lat, "model")                           # (B, H, r)
    if heads:
        o_lat = o_lat.narrow(1, shard.coord("model") * Hl, Hl)
    return o_lat


def _slot_mask(cfg: AttnConfig, kv_slot: torch.Tensor, pos_b: torch.Tensor,
               S: int) -> torch.Tensor:
    """``(B, n)`` readable slots: those written so far; a ring once it has
    wrapped (``pos >= S``) holds the window in every slot."""
    mask = kv_slot[None, :] <= pos_b[:, None]
    if cfg.window:
        mask = mask | (pos_b[:, None] >= S)
    return mask


def _cache_attend(
    params: dict,
    cfg: AttnConfig,
    x: torch.Tensor,                  # (B, 1, d_model)
    cache: dict,                      # (B, S, ...) leaves: dense or a paged view
    q: torch.Tensor,                  # (B, 1, H, D) post-rotary query
    pos_b: torch.Tensor,              # (B,)
) -> torch.Tensor:
    """The decode attention read: one-shot softmax over an fp cache, or the
    chunked flash-decode with the dequantisation inside each chunk over an
    int8 cache (``QUANT_CHUNK`` slots per chunk, online-softmax order as
    the reference).  The mask includes the slot just written."""
    B = x.shape[0]
    S = cache["k"].shape[1]
    H, KV, D = q.shape[2], cache["k"].shape[2], cfg.head_dim    # this rank's heads
    rep = H // KV
    qh = q.reshape(B, KV, rep, D)
    dev = x.device
    if not cfg.kv_quant:
        ck = cache["k"].to(x.dtype)
        cv = cache["v"].to(x.dtype)
        s = torch.einsum("bgrd,bsgd->bgrs", qh, ck) / math.sqrt(D)
        mask = _slot_mask(cfg, torch.arange(S, device=dev), pos_b, S)
        s = torch.where(mask[:, None, None], s.float(), NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrs,bsgd->bgrd", p.to(cv.dtype), cv)
        o = o.reshape(B, 1, H, D).to(x.dtype)
        return torch.einsum("bthk,hkd->btd", o, params["wo"].to(x.dtype))
    chunk = min(QUANT_CHUNK, S)
    n_chunks = -(-S // chunk)
    if S % chunk and n_chunks != 1:
        raise ValueError(f"int8 cache length {S} is not a multiple of {chunk}")
    m = torch.full((B, KV, rep), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, rep, D), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        part = {n: a[:, ci * chunk:(ci + 1) * chunk] for n, a in cache.items()}
        kb = _read_cache(part, "k", True, x.dtype)
        vb = _read_cache(part, "v", True, x.dtype)
        s = torch.einsum("bgrd,bsgd->bgrs", qh, kb) / math.sqrt(D)
        mask = _slot_mask(cfg, ci * chunk + torch.arange(chunk, device=dev), pos_b, S)
        s = torch.where(mask[:, None, None], s.float(), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrs,bsgd->bgrd", p.to(vb.dtype), vb).float()
        m = m_new
    o = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(x.dtype).reshape(B, 1, H, D)
    return torch.einsum("bthk,hkd->btd", o, params["wo"].to(x.dtype))


def _put_span(buf: torch.Tensor, v: torch.Tensor, positions: torch.Tensor) -> None:
    """``buf[b, positions[b, j]] = v[b, j]`` in place for positions inside
    the cache (``S`` slots); positions ``>= S`` are dropped, as the
    reference's scatter drops them.  Without a host sync they cannot be
    filtered out, so they are aimed at slot ``S-1`` carrying the value
    slot ``S-1`` ends with anyway: the span's own value where the span
    writes ``S-1``, else the value it holds.  Every duplicate write of
    ``S-1`` then carries the same value."""
    B, W = positions.shape
    S = buf.shape[1]
    rows = torch.arange(B, device=buf.device)
    keep = positions < S
    j_last = (S - 1) - positions[:, 0]                        # span index of slot S-1
    owns_last = (j_last >= 0) & (j_last < W)
    src = torch.where(keep, torch.arange(W, device=buf.device)[None, :],
                      torch.clamp(j_last, 0, W - 1)[:, None])
    vals = v[rows[:, None], src]                              # (B, W, ...)
    held = buf[rows, S - 1][:, None]                          # (B, 1, ...)
    use_win = (keep | owns_last[:, None]).reshape(B, W, *((1,) * (v.dim() - 2)))
    buf[rows[:, None], torch.clamp_max(positions, S - 1)] = torch.where(use_win, vals, held)


def _write_cache_span(cache: dict, name: str, val: torch.Tensor,
                      positions: torch.Tensor, quant: bool = False) -> None:
    """Write a ``(B, W)`` span of K or V (``val (B, W, KV, D)``) into a dense
    ``(B, S, ...)`` cache in place, at per-row absolute ``positions (B, W)``:
    the W-token generalisation of :func:`_write_cache`'s per-row branch,
    with positions ``>= S`` dropped from every leaf it writes
    (:func:`_put_span`); a fixed-shape window overruns ``max_seq`` on a
    row that retires in it."""
    if quant:
        qv, sc = _kv_quantize(val)
        _put_span(cache[name], qv, positions)
        _put_span(cache[name + "_scale"], sc, positions)
    else:
        _put_span(cache[name], val.to(cache[name].dtype), positions)


def _cache_attend_window(
    params: dict,
    cfg: AttnConfig,
    x: torch.Tensor,                  # (B, W, d_model)
    cache: dict,                      # (B, S, ...) leaves: dense or a paged view
    q: torch.Tensor,                  # (B, W, H, D) post-rotary queries
    pos_b: torch.Tensor,              # (B,) window start positions
) -> torch.Tensor:
    """The verify-window attention read: :func:`_cache_attend` with the
    window axis carried along as a batch axis.  Query ``j`` (absolute
    position ``pos_b + j``) masks ``kv_slot <= pos_b + j``, its own freshly
    written slot included, as the sequential step does; an int8 cache is
    swept in the same dequantising chunks."""
    B, W = q.shape[:2]
    S = cache["k"].shape[1]
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = H // KV
    dev = x.device
    qh = q.reshape(B, W, KV, rep, D)
    q_pos = pos_b[:, None] + torch.arange(W, device=dev)[None, :]   # (B, W)
    if not cfg.kv_quant:
        ck = cache["k"].to(x.dtype)
        cv = cache["v"].to(x.dtype)
        s = torch.einsum("btgrd,bsgd->btgrs", qh, ck) / math.sqrt(D)
        mask = torch.arange(S, device=dev)[None, None, :] <= q_pos[:, :, None]  # (B, W, S)
        s = torch.where(mask[:, :, None, None, :], s.float(), NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("btgrs,bsgd->btgrd", p.to(cv.dtype), cv)
        o = o.reshape(B, W, H, D).to(x.dtype)
        return torch.einsum("bthk,hkd->btd", o, params["wo"].to(x.dtype))
    chunk = min(QUANT_CHUNK, S)
    n_chunks = -(-S // chunk)
    if S % chunk and n_chunks != 1:
        raise ValueError(f"int8 cache length {S} is not a multiple of {chunk}")
    m = torch.full((B, W, KV, rep), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, W, KV, rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, W, KV, rep, D), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        part = {n: a[:, ci * chunk:(ci + 1) * chunk] for n, a in cache.items()}
        kb = _read_cache(part, "k", True, x.dtype)
        vb = _read_cache(part, "v", True, x.dtype)
        s = torch.einsum("btgrd,bsgd->btgrs", qh, kb) / math.sqrt(D)
        kv_slot = ci * chunk + torch.arange(chunk, device=dev)
        mask = kv_slot[None, None, :] <= q_pos[:, :, None]
        s = torch.where(mask[:, :, None, None, :], s.float(), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "btgrs,bsgd->btgrd", p.to(vb.dtype), vb).float()
        m = m_new
    o = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(x.dtype).reshape(B, W, H, D)
    return torch.einsum("bthk,hkd->btd", o, params["wo"].to(x.dtype))


# kanlint's KL105: a mesh serves no speculative window (ROADMAP queue 1,
# item 9.4), so no ShardingCtx reaches these cache writes.
def attn_verify_window(  # kanlint: ignore[KL105]
    params: dict,
    cfg: AttnConfig,
    x: torch.Tensor,                  # (B, W, d_model): last token + k drafts
    cache: dict,                      # dense (B, S, ...) leaves, updated in place
    pos: torch.Tensor,                # (B,) window start (= next write slot)
) -> tuple[torch.Tensor, dict]:
    """W-token verify against the dense cache: write all W post-rotary K/V
    (quantised under an int8 cache, as the sequential step attends its own
    quantised write), then attend with per-query causal masks.  Rejected
    positions leave stale K/V at slots ``>= pos + m``; the next window
    rewrites each such slot before any query can reach it, so no rollback
    is needed."""
    _check_full_attention(cfg, "speculative verify")
    B, W, _ = x.shape
    pos_b = pos.expand(B) if pos.dim() == 0 else pos
    positions = pos_b[:, None] + torch.arange(W, device=x.device)[None, :]   # (B, W)
    q, k, v = _project_qkv(params, cfg, x, positions)
    _write_cache_span(cache, "k", k, positions, cfg.kv_quant)
    _write_cache_span(cache, "v", v, positions, cfg.kv_quant)
    return _cache_attend_window(params, cfg, x, cache, q, pos_b), cache


# ---------------------------------------------------------------------------
# Paged KV cache (DESIGN.md §3b): pool + block-table addressing.
#
# Each cache leaf is a POOL ``(n_blocks, block_size, ...)`` shared by all
# batch rows; a per-row block table ``(B, n_logical)`` maps logical block l
# of row b to a physical block (``n_logical * block_size == max_seq``).
# Physical block 0 is the reserved sentinel: unassigned table entries point
# at it and out-of-coverage writes land in it; the causal mask hides its
# contents.  Reads gather the logical ``(B, max_seq, ...)`` view (every leaf
# of a cache, int8 values and fp32 scales alike, in one launch) and run the
# unchanged dense math (:func:`_cache_attend` / :func:`flash_attention`).
# ---------------------------------------------------------------------------


def paged_view(cache: dict, table: torch.Tensor, shard=None, stacked: bool = False) -> dict:
    """The logical contiguous view of a paged cache tree: pools
    ``([layers,] n_blocks, bs, ...)`` and table ``(B, L)`` -> ``([layers,]
    B, L·bs, ...)`` leaves, every leaf gathered in one launch of the
    block-table kernel.  On a mesh whose data axis splits the pool's
    blocks, this rank gathers its own blocks (the others read as zeros)
    and one ``all_reduce`` over ``data`` assembles the view."""
    blocks = None if shard is None else shard.block_range()
    if blocks is None:
        return ops.gather_views(cache, table, stacked)
    first, n = blocks
    mine = (table >= first) & (table < first + n)
    views = ops.gather_views(cache, torch.where(mine, table - first, 0).to(table.dtype),
                             stacked)
    bs = next(iter(cache.values())).shape[1 + stacked]
    mine = mine.repeat_interleave(bs, dim=1)                   # (B, L·bs)
    return {name: shard.all_reduce(
                torch.where(mine.reshape(mine.shape + (1,) * (v.dim() - 2 - stacked)), v, 0),
                "data")
            for name, v in views.items()}


def put_blocks(pool: torch.Tensor, phys: torch.Tensor, off: torch.Tensor,
               vals: torch.Tensor, shard=None, stacked: bool = False) -> None:
    """``pool[phys, off] = vals`` in place (``stacked``: ``pool[:, phys,
    off]``), ``phys`` global block ids.  On a mesh whose data axis splits
    the pool's blocks, only the rank that owns a block writes it: the
    others' writes go to a scratch block past this rank's shard."""
    blocks = None if shard is None else shard.block_range()
    target = pool
    if blocks is not None:
        first, n = blocks
        phys = torch.where((phys >= first) & (phys < first + n), phys - first, n)
        target = torch.cat([pool, pool.narrow(int(stacked), 0, 1)], dim=int(stacked))
    if stacked:
        target[:, phys, off] = vals
    else:
        target.index_put_((phys, off), vals)
    if target is not pool:
        pool.copy_(target.narrow(int(stacked), 0, pool.shape[int(stacked)]))


def paged_route(
    table: torch.Tensor,              # (B, L) block table
    positions: torch.Tensor,          # (B, T) absolute cache positions
    block_size: int,
    valid: torch.Tensor | None = None,  # extra (B, T) mask (e.g. pad positions)
) -> tuple[torch.Tensor, torch.Tensor]:
    """THE block-table write routing: absolute positions -> ``(phys, off)``
    scatter targets.  Positions past the table span, and any position the
    caller masks, go to the sentinel block 0.  Every paged write (decode
    token, prefill span, shadow-chunk writeback) routes through here."""
    L = table.shape[1]
    lb = torch.clamp_max(torch.div(positions, block_size, rounding_mode="floor"), L - 1)
    ok = positions < L * block_size
    if valid is not None:
        ok = ok & valid
    phys = torch.where(ok, torch.gather(table, 1, lb.long()), 0)
    return phys, torch.remainder(positions, block_size)


def paged_write_span(
    cache: dict, name: str, val: torch.Tensor, table: torch.Tensor,
    start, lengths: torch.Tensor, quant: bool = False, shard=None,
) -> None:
    """Scatter a span of K or V into pool blocks, in place (under ``quant``
    the int8 values into ``cache[name]`` and their scales into
    ``cache[name + "_scale"]``).

    ``val (B, T, KV, D)`` holds positions ``start + t`` (``start`` a scalar
    (grouped admission prefill) or per row ``(B,)`` (decode steps)); rows
    are right-padded, and positions ``>= lengths[b]`` go to the sentinel
    block so pad K/V never lands in a real block.  The same redirect takes
    positions past the table span.  Duplicate writes to the sentinel land
    in no defined order; the sentinel is never attended.  On a mesh each
    block is written by its owner only (:func:`put_blocks`)."""
    pool = cache[name]
    B, T = val.shape[:2]
    bs = pool.shape[1]
    if isinstance(start, torch.Tensor):
        positions = start.reshape(-1, 1) + torch.arange(T, device=val.device)[None, :]
    else:
        positions = torch.arange(start, start + T, device=val.device)[None, :]
    positions = positions.expand(B, T)
    phys, off = paged_route(table, positions, bs,
                            valid=positions < lengths.reshape(-1, 1))
    phys, off = phys.long(), off.long()
    if quant:
        qv, sc = _kv_quantize(val)
        put_blocks(pool, phys, off, qv, shard)
        put_blocks(cache[name + "_scale"], phys, off, sc, shard)
    else:
        put_blocks(pool, phys, off, val.to(pool.dtype), shard)


def attn_decode_step_paged(
    params: dict,
    cfg: AttnConfig,
    x: torch.Tensor,                  # (B, 1, d_model)
    cache: dict,                      # POOL leaves (n_blocks, bs, ...), in place
    table: torch.Tensor,              # (B, n_logical) int32 block table
    pos: torch.Tensor,                # (B,) absolute positions
    shard=None,
) -> tuple[torch.Tensor, dict]:
    """One-token decode against the paged pool: the QKV math of
    :func:`attn_decode_step`, writes routed through the block table, then
    :func:`_cache_attend` on the gathered logical view."""
    _check_full_attention(cfg, "paged KV")
    B = x.shape[0]
    pos_b = pos.expand(B) if pos.dim() == 0 else pos
    params, kv_of, partial = _local_attn(params, cfg, shard)
    q, k, v = _project_qkv(params, cfg, x, pos_b[:, None])
    # the T=1 span at per-row starts; lengths pos_b + 1 mask nothing, and
    # positions past the table still go to the sentinel
    paged_write_span(cache, "k", k, table, pos_b, pos_b + 1, cfg.kv_quant, shard)
    paged_write_span(cache, "v", v, table, pos_b, pos_b + 1, cfg.kv_quant, shard)
    view = _pick(paged_view(cache, table, shard), kv_of)
    return _finish(_cache_attend(params, cfg, x, view, q, pos_b), partial, shard), cache


def attn_prefill_paged(
    params: dict,
    cfg: AttnConfig,
    x: torch.Tensor,                  # (B, Ts, d_model): the UNCACHED suffix
    positions: torch.Tensor,          # (B or 1, Ts) absolute positions (start + t)
    cache: dict,                      # POOL leaves (n_blocks, bs, ...), in place
    table: torch.Tensor,              # (B, n_logical)
    lengths: torch.Tensor,            # (B,) true total prompt lengths
    start: int,                       # first uncached position
    chunk: int = 1024,
    view_blocks: int | None = None,   # table columns the attention view needs
                                      # (covers start + Ts); None: all
    shard=None,
) -> tuple[torch.Tensor, dict]:
    """Suffix prefill into pool blocks: a prefix-cache hit makes ``start >
    0`` and computes only positions ``start..len-1``.

    Attention runs over the logical view (dequantised under an int8 cache)
    with the fresh span overlaid RAW at ``start`` (the reference's
    ``dynamic_update_slice``, which clamps the offset so the span fits):
    positions ``< start`` come from reused blocks, the suffix attends its
    own raw K/V as a full prefill would, int8 cache or not.  The view is
    cut to ``view_blocks`` table columns; KV chunks past the last query are
    empty in the causal online softmax."""
    _check_full_attention(cfg, "paged KV")
    T = x.shape[1]
    params, kv_of, partial = _local_attn(params, cfg, shard)
    q, k, v = _project_qkv(params, cfg, x, positions)
    paged_write_span(cache, "k", k, table, start, lengths, cfg.kv_quant, shard)
    paged_write_span(cache, "v", v, table, start, lengths, cfg.kv_quant, shard)
    view = paged_view(cache, table if view_blocks is None
                      else table[:, :view_blocks].contiguous(), shard)
    ck = _read_cache(view, "k", cfg.kv_quant, x.dtype)
    cv = _read_cache(view, "v", cfg.kv_quant, x.dtype)
    at = max(0, min(int(start), ck.shape[1] - T))
    ck[:, at:at + T] = k.to(ck.dtype)
    cv[:, at:at + T] = v.to(cv.dtype)
    kq = _pick({"k": ck, "v": cv}, kv_of)
    o = flash_attention(q, kq["k"], kq["v"], causal=True, q_offset=int(start), chunk=chunk)
    y = _finish(torch.einsum("bthk,hkd->btd", o, params["wo"].to(x.dtype)), partial, shard)
    return y, cache


def attn_verify_window_paged(  # kanlint: ignore[KL105] (see attn_verify_window)
    params: dict,
    cfg: AttnConfig,
    x: torch.Tensor,                  # (B, W, d_model)
    cache: dict,                      # POOL leaves (n_blocks, bs, ...), in place
    table: torch.Tensor,              # (B, n_logical) int32 block table
    pos: torch.Tensor,                # (B,) window start positions
) -> tuple[torch.Tensor, dict]:
    """W-token verify against the paged pool: the span writes go through the
    block table (lengths ``pos + W`` mask nothing; positions past the table
    go to the sentinel), then the window attention of
    :func:`attn_verify_window` on the gathered logical view.  Admission caps
    prefix reuse below ``blocks_for(pos)``, so a window never writes a
    shared block; the engine trims rejected coverage afterwards."""
    _check_full_attention(cfg, "paged KV")
    B, W, _ = x.shape
    pos_b = pos.expand(B) if pos.dim() == 0 else pos
    positions = pos_b[:, None] + torch.arange(W, device=x.device)[None, :]
    q, k, v = _project_qkv(params, cfg, x, positions)
    paged_write_span(cache, "k", k, table, pos_b, pos_b + W, cfg.kv_quant)
    paged_write_span(cache, "v", v, table, pos_b, pos_b + W, cfg.kv_quant)
    return _cache_attend_window(params, cfg, x, paged_view(cache, table), q, pos_b), cache
