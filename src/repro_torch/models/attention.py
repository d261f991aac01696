"""GQA attention with a KV cache, in PyTorch (the GQA half of
``repro/models/attention.py``).

* :func:`flash_attention` — online softmax over KV chunks, written in plain
  torch ops (the reference is plain jnp too; no attention kernel is owed);
* :func:`attn_forward` — prefill attention that also returns the post-rotary
  K/V the decode cache stores;
* :func:`attn_decode_step` — one token against the cache.  The cache is
  written IN PLACE (the torch analogue of the reference's buffer donation):
  a scalar ``pos`` writes one slot for every row, a per-row ``(B,)`` ``pos``
  writes each row at its own slot.

Sliding windows, int8 KV caches, MLA and the paged paths are not ported yet
(ROADMAP queue 1); they raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import layers as L

NEG_INF = -1e30


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


def check_supported(cfg: AttnConfig) -> None:
    """Raise for the attention variants this slice of the port lacks."""
    missing = [name for name, on in (
        ("sliding window", cfg.window is not None),
        ("int8 KV cache (kv_quant)", cfg.kv_quant),
        ("MLA (kv_lora_rank)", cfg.kv_lora_rank is not None),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"attention: {', '.join(missing)} not ported yet (ROADMAP queue 1, "
            "items 4 and 13)")


def flash_attention(
    q: torch.Tensor,                  # (B, Tq, H, D)
    k: torch.Tensor,                  # (B, Tk, KV, D)
    v: torch.Tensor,                  # (B, Tk, KV, Dv)
    *,
    causal: bool = True,
    q_offset: int = 0,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks; O(Tq·chunk) live memory."""
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
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
            s = torch.where(mask, s.float(), NEG_INF)
        else:
            s = s.float()
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
    """QKV projection + bias + rotary at absolute ``positions``."""
    if cfg.qk_norm:
        raise NotImplementedError("attention: qk_norm not ported yet (ROADMAP queue 1, item 4)")
    q = torch.einsum("btd,dhk->bthk", x, params["wq"].to(x.dtype))
    k = torch.einsum("btd,dhk->bthk", x, params["wk"].to(x.dtype))
    v = torch.einsum("btd,dhk->bthk", x, params["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
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
):
    """Prefill attention; with ``return_cache`` also the post-rotary K/V."""
    check_supported(cfg)
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(params, cfg, x, positions)
    o = flash_attention(q, k, v, causal=True, chunk=chunk)
    y = torch.einsum("bthk,hkd->btd", o, params["wo"].to(x.dtype))
    if return_cache:
        return y, {"k": k, "v": v}
    return y


def _write_cache(cache: dict, name: str, val: torch.Tensor,
                 slot: torch.Tensor) -> None:
    """Write one token's K or V (``val (B, 1, KV, D)``) into ``cache[name]``
    in place: at one shared slot (scalar ``slot``) or per row (``(B,)``)."""
    buf = cache[name]
    v = val[:, 0].to(buf.dtype)
    if slot.dim() == 0:
        buf[:, slot] = v
    else:
        buf[torch.arange(v.shape[0], device=buf.device), slot] = v


# kanlint's KL105 (thread a ShardingCtx through cache writes) is the JAX
# package's mesh contract; on one device the in-place writes have no
# sharding to pin.  Mesh serving is ROADMAP queue 1, item 14.
def attn_decode_step(  # kanlint: ignore[KL105]
    params: dict,
    cfg: AttnConfig,
    x: torch.Tensor,                  # (B, 1, d_model)
    cache: dict,                      # {"k", "v"}: (B, S, KV, D), updated in place
    pos: torch.Tensor,                # scalar or (B,) absolute position
) -> tuple[torch.Tensor, dict]:
    """One-token decode against a pre-filled KV cache."""
    check_supported(cfg)
    B = x.shape[0]
    pos_b = pos.expand(B) if pos.dim() == 0 else pos
    q, k, v = _project_qkv(params, cfg, x, pos_b[:, None])
    _write_cache(cache, "k", k, pos)
    _write_cache(cache, "v", v, pos)
    return _cache_attend(params, cfg, x, cache, q, pos_b), cache


def _cache_attend(
    params: dict,
    cfg: AttnConfig,
    x: torch.Tensor,                  # (B, 1, d_model)
    cache: dict,                      # (B, S, KV, D) leaves
    q: torch.Tensor,                  # (B, 1, H, D) post-rotary query
    pos_b: torch.Tensor,              # (B,)
) -> torch.Tensor:
    """The decode attention read: one-shot softmax over the fp cache.  The
    mask ``kv_slot <= pos_b`` includes the slot just written."""
    B = x.shape[0]
    S = cache["k"].shape[1]
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = H // KV
    qh = q.reshape(B, KV, rep, D)
    ck = cache["k"].to(x.dtype)
    cv = cache["v"].to(x.dtype)
    s = torch.einsum("bgrd,bsgd->bgrs", qh, ck) / math.sqrt(D)
    kv_slot = torch.arange(S, device=x.device)[None, :]
    mask = kv_slot <= pos_b[:, None]
    s = torch.where(mask[:, None, None], s.float(), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", p.to(cv.dtype), cv)
    o = o.reshape(B, 1, H, D).to(x.dtype)
    return torch.einsum("bthk,hkd->btd", o, params["wo"].to(x.dtype))
