"""Decoder blocks in PyTorch (counterpart of ``repro/models/blocks.py``).

Only the ``attn_kan`` kind is ported: pre-norm GQA attention followed by the
KAN FFN, two spline layers ``d -> kan_ff -> d`` (the paper's technique as
an FFN replacement).  Other block kinds raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import kan_layer as KL
from repro_torch.core.bspline import SplineGrid
from repro_torch.models import attention as A
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    kind: str
    attn: A.AttnConfig | None = None
    d_ff: int = 0
    kan_grid: SplineGrid | None = None    # attn_kan
    kan_ff: int = 0
    shared_id: int | None = None


def check_supported(blk: BlockCfg) -> None:
    if blk.kind != "attn_kan" or blk.shared_id is not None:
        raise NotImplementedError(
            f"block kind {blk.kind!r} (shared_id={blk.shared_id}) is not ported "
            "yet: only attn_kan (ROADMAP queue 1, items 6 and 8)")
    A.check_supported(blk.attn)


def _kan_ffn(
    params: dict, x: torch.Tensor, grid: SplineGrid, method: str = "dense"
) -> torch.Tensor:
    """Two spline layers d -> ff -> d; tanh squashes into the spline domain
    before each.  ``method="auto"`` picks the kernel per device and row
    count (``KL.resolve_inference_method``)."""
    lead = x.shape[:-1]
    xf = torch.tanh(x.reshape(-1, x.shape[-1]))
    h = KL.kan_layer_apply({"coeff": params["c1"], "base_w": params["b1"]},
                           xf, grid, method)
    h = torch.tanh(h)
    y = KL.kan_layer_apply({"coeff": params["c2"], "base_w": params["b2"]},
                           h, grid, method)
    return y.reshape(lead + (y.shape[-1],)).to(x.dtype)


def block_supports_paging(blk: BlockCfg) -> bool:
    """Paged KV (DESIGN.md §3b) covers full-attention GQA layers (windowed
    rings and MLA latents do not strand per-token memory as a dense
    ``max_seq`` row does)."""
    return (blk.kind in ("attn_mlp", "attn_moe", "attn_kan")
            and blk.attn.kv_lora_rank is None and blk.attn.window is None)


def block_init_paged_cache(blk: BlockCfg, n_blocks: int, block_size: int,
                           dtype, device) -> dict:
    """Pool-shaped decode cache: ``(n_blocks, block_size, KV, D)`` leaves in
    place of :func:`block_init_cache`'s ``(batch, max_seq, KV, D)`` rows.
    Physical block 0 is the engine's sentinel (``serve/kv_pool.py``)."""
    if not block_supports_paging(blk):
        raise NotImplementedError(
            f"paged KV cache: unsupported block kind {blk.kind!r} "
            "(full-attention GQA layers only)")
    check_supported(blk)
    c = blk.attn
    shape = (n_blocks, block_size, c.n_kv_heads, c.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def block_init_cache(blk: BlockCfg, batch: int, max_seq: int, dtype,
                     device) -> dict:
    """Per-block decode state: the ``(batch, max_seq, KV, D)`` K/V rows."""
    check_supported(blk)
    c = blk.attn
    shape = (batch, c.cache_len(max_seq), c.n_kv_heads, c.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# kanlint's KL105 (thread a ShardingCtx through cache writes) is the JAX
# package's mesh contract; on one device the in-place writes have no
# sharding to pin.  Mesh serving is ROADMAP queue 1, item 9.
def block_prefill(  # kanlint: ignore[KL105]
    params: dict,
    blk: BlockCfg,
    x: torch.Tensor,                  # (B, T, d)
    *,
    positions: torch.Tensor | None = None,
    cache: dict,                      # (B, max_seq, KV, D) rows, filled in place
    chunk: int = 1024,
) -> tuple[torch.Tensor, dict]:
    """Forward that also writes its K/V into ``cache[:, :T]`` in place
    (slots past T stay as they are: zeros in a fresh cache, as the
    reference pads its prefill cache to ``max_seq``)."""
    check_supported(blk)
    T = x.shape[1]
    h = L.rmsnorm(params["ln1"], x)
    y, kv = A.attn_forward(params["attn"], blk.attn, h, positions=positions,
                           chunk=chunk, return_cache=True)
    cache["k"][:, :T] = kv["k"].to(cache["k"].dtype)
    cache["v"][:, :T] = kv["v"].to(cache["v"].dtype)
    x = x + y
    h2 = L.rmsnorm(params["ln2"], x)
    # prefill sees B·T rows: "auto" resolves to the fused kernel on CUDA
    return x + _kan_ffn(params["kan"], h2, blk.kan_grid, method="auto"), cache


def block_prefill_paged(  # kanlint: ignore[KL105] (see block_prefill)
    params: dict,
    blk: BlockCfg,
    x: torch.Tensor,                  # (B, Ts, d): uncached suffix tokens only
    *,
    positions: torch.Tensor,          # (B or 1, Ts) absolute positions
    cache: dict,                      # pool leaves (n_blocks, bs, KV, D), in place
    table: torch.Tensor,              # (B, n_logical)
    lengths: torch.Tensor,            # (B,) true total prompt lengths
    start: int,                       # first uncached position
    chunk: int = 1024,
    view_blocks: int | None = None,
) -> tuple[torch.Tensor, dict]:
    """Suffix prefill writing K/V straight into pool blocks: the paged
    counterpart of :func:`block_prefill`.  A prefix-cache hit enters with
    ``start > 0`` and skips the cached positions."""
    if not block_supports_paging(blk):
        raise NotImplementedError(f"paged prefill: unsupported kind {blk.kind!r}")
    check_supported(blk)
    h = L.rmsnorm(params["ln1"], x)
    y, cache = A.attn_prefill_paged(params["attn"], blk.attn, h, positions, cache,
                                    table, lengths, start, chunk=chunk,
                                    view_blocks=view_blocks)
    x = x + y
    h2 = L.rmsnorm(params["ln2"], x)
    return x + _kan_ffn(params["kan"], h2, blk.kan_grid, method="auto"), cache


def block_decode_step(  # kanlint: ignore[KL105] (see block_prefill)
    params: dict,
    blk: BlockCfg,
    x: torch.Tensor,                  # (B, 1, d)
    cache: dict,                      # updated in place
    pos: torch.Tensor,                # scalar or (B,)
    table: torch.Tensor | None = None,  # (B, n_logical): paged block table
) -> tuple[torch.Tensor, dict]:
    """One decode step; with ``table``, ``cache`` holds pools and the step
    reads and writes through the block table."""
    check_supported(blk)
    h = L.rmsnorm(params["ln1"], x)
    if table is not None:
        y, cache = A.attn_decode_step_paged(params["attn"], blk.attn, h, cache,
                                            table, pos)
    else:
        y, cache = A.attn_decode_step(params["attn"], blk.attn, h, cache, pos)
    x = x + y
    h2 = L.rmsnorm(params["ln2"], x)
    # decode sees B rows: "auto" resolves to the sparse kernel on CUDA
    return x + _kan_ffn(params["kan"], h2, blk.kan_grid, method="auto"), cache


def block_verify_window(  # kanlint: ignore[KL105] (see block_prefill)
    params: dict,
    blk: BlockCfg,
    x: torch.Tensor,                  # (B, W, d): last accepted token + k drafts
    cache: dict,                      # updated in place
    pos: torch.Tensor,                # (B,) window start positions
    table: torch.Tensor | None = None,  # (B, n_logical): paged block table
) -> tuple[torch.Tensor, dict]:
    """Speculative verify: :func:`block_decode_step` for a W-token window in
    one pass.  Full-attention GQA blocks only (ring buffers and recurrent
    states are sequential in the window)."""
    if not block_supports_paging(blk):
        raise NotImplementedError(
            f"speculative verify: unsupported kind {blk.kind!r} "
            "(full-attention GQA layers only)")
    check_supported(blk)
    h = L.rmsnorm(params["ln1"], x)
    if table is not None:
        y, cache = A.attn_verify_window_paged(params["attn"], blk.attn, h, cache,
                                              table, pos)
    else:
        y, cache = A.attn_verify_window(params["attn"], blk.attn, h, cache, pos)
    x = x + y
    h2 = L.rmsnorm(params["ln2"], x)
    # the FFN sees B·W rows: "auto" resolves to the fused kernel on CUDA
    # when B·W > $KAN_SAS_SPARSE_MAX_ROWS (8)
    return x + _kan_ffn(params["kan"], h2, blk.kan_grid, method="auto"), cache
