"""Decoder blocks in PyTorch (counterpart of ``repro/models/blocks.py``).

Every kind of the reference is ported.  Three are pre-norm attention
followed by an FFN: ``attn_mlp``, the SwiGLU MLP of the dense models (qwen,
gemma3, deepseek's dense prologue, zamba2's shared block); ``attn_moe``,
the routed experts of ``models/moe.py`` (olmoe, deepseek), whose auxiliary
losses :func:`block_apply` returns; and ``attn_kan``, the KAN FFN of two
spline layers ``d -> kan_ff -> d`` (the paper's technique as an FFN
replacement).  Windowed attention (a ring cache of ``window`` slots), q/k
norm, int8 KV caches and MLA (a ``{"ckv": (B, max_seq, r + rope)}`` latent
cache, not pageable) come with the attention config.  Three are recurrent,
a pre-norm mixer with no FFN: ``mamba2`` (``models/ssm.py``; zamba2),
``mlstm`` and ``slstm`` (``models/xlstm.py``; xlstm).  Their decode state
is per request, not per token (``{"ssm", "conv"}``, ``{"C", "n", "m",
"conv"}``, ``{"c", "n", "h", "m"}``): it neither pages nor takes a verify
window, as in the reference.  A block with ``shared_id`` is applied by
``models/lm.py`` with the model's shared parameters.

On a mesh (``shard``) the FFN is Megatron-style: the first layer
column-parallel (``ffn`` on ``model``: each rank computes its ``ff/m``
hidden columns), the second row-parallel (its ``ff/m`` input rows give a
partial sum, one ``all_reduce`` over ``model`` completes it).  A KAN layer
is a sum over its input features (``sum_k B(h_k) C_k + ReLU(h_k) Wb_k``),
so the KAN kernels run on the local rows as they are.  An ``attn_moe``
block's experts take the mesh as ``models/moe.py`` sets out (experts on
``model``, routing over the global batch on ``data``).  The attention
blocks take a mesh (``attn_kan``, ``attn_mlp``, ``attn_moe``); the
recurrent ones do not.
:func:`block_apply` trains on a mesh: the FFN's input enters the local
columns through ``copy_to_model`` and its partial output leaves through
``reduce_from`` (``dist/sharding.py``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import kan_layer as KL
from repro_torch.core.bspline import SplineGrid
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X

ATTN_KINDS = ("attn_mlp", "attn_moe", "attn_kan")
# a recurrent kind's parameter key and its forward, decode step and state init
RECURRENT = {
    "mamba2": ("mamba", S.mamba2_forward, S.mamba2_decode_step, S.mamba2_init_state),
    "mlstm": ("mlstm", X.mlstm_forward, X.mlstm_decode_step, X.mlstm_init_state),
    "slstm": ("slstm", X.slstm_forward, X.slstm_decode_step, X.slstm_init_state),
}
KINDS = ATTN_KINDS + tuple(RECURRENT)


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    kind: str
    attn: A.AttnConfig | None = None
    d_ff: int = 0                         # attn_mlp: SwiGLU hidden size
    moe: M.MoEConfig | None = None        # attn_moe
    mamba: S.Mamba2Config | None = None   # mamba2
    xlstm: X.XLSTMConfig | None = None    # mlstm, slstm
    kan_grid: SplineGrid | None = None    # attn_kan
    kan_ff: int = 0
    shared_id: int | None = None          # an entry of the model's shared set


def check_supported(blk: BlockCfg) -> None:
    if blk.kind not in KINDS:
        raise NotImplementedError(
            f"block kind {blk.kind!r} is not a block kind: {', '.join(KINDS)}")


def _recurrent_cfg(blk: BlockCfg):
    return blk.mamba if blk.kind == "mamba2" else blk.xlstm


def _ffn_axes(blk: BlockCfg, d: int) -> dict:
    """Logical axes and whole shape of each FFN leaf of an attn_mlp or
    attn_kan block."""
    if blk.kind == "attn_mlp":
        ff = blk.d_ff
        return {"wi": (("embed", "ffn"), (d, ff)), "wg": (("embed", "ffn"), (d, ff)),
                "wo": (("ffn", "embed"), (ff, d))}
    ff, M_ = blk.kan_ff, blk.kan_grid.n_basis
    return {"c1": (("embed", None, "ffn"), (d, M_, ff)), "b1": (("embed", "ffn"), (d, ff)),
            "c2": (("ffn", None, "embed"), (ff, M_, d)), "b2": (("ffn", "embed"), (ff, d))}


def _local_ffn(params: dict, blk: BlockCfg, d: int, shard) -> tuple[dict, bool]:
    """The FFN weights as this rank computes with them -> ``(weights,
    partial)``: local when ``ffn`` takes the model axis (the output then a
    partial sum), else gathered whole."""
    if shard is None:
        return params, False
    axes = _ffn_axes(blk, d)
    if shard.model_split(*next(iter(axes.values()))) == "ffn":
        return params, True
    return {n: shard.gather_whole(w, *axes[n]) for n, w in params.items()}, False


def _mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x Wg) * x Wi) Wo``."""
    h = x @ params["wi"].to(x.dtype)
    g = x @ params["wg"].to(x.dtype)
    return (F.silu(g) * h) @ params["wo"].to(x.dtype)


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


def _ffn(params: dict, blk: BlockCfg, h: torch.Tensor,
         method: str = "auto", shard=None) -> tuple[torch.Tensor, dict]:
    """The block's FFN on the post-attention norm -> ``(y, aux)``, ``aux``
    the MoE's auxiliary losses (empty for the other kinds).  Inference
    passes ``method="auto"``: the KAN FFN then resolves to the fused kernel
    at prefill and verify-window row counts and the sparse one at decode
    row counts on CUDA (``KL.resolve_inference_method``)."""
    if blk.kind == "attn_moe":
        return M.moe_forward(params["moe"], blk.moe, h, shard)
    key = "mlp" if blk.kind == "attn_mlp" else "kan"
    p, partial = _local_ffn(params[key], blk, h.shape[-1], shard)
    if partial:
        h = shard.copy_to_model(h)
    y = _mlp(p, h) if key == "mlp" else _kan_ffn(p, h, blk.kan_grid, method=method)
    return (shard.reduce_from(y, "model") if partial else y), {}


def _residual_ffn(params: dict, blk: BlockCfg, x: torch.Tensor, shard=None) -> torch.Tensor:
    """``x + FFN(norm(x))`` on the inference paths (the aux is dropped)."""
    return x + _ffn(params, blk, L.rmsnorm(params["ln2"], x, shard=shard), shard=shard)[0]


def _check_mesh(blk: BlockCfg, shard) -> None:
    if shard is not None and blk.kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"a mesh serves attn_mlp, attn_moe and attn_kan blocks, not {blk.kind!r}")


def block_apply(
    params: dict,
    blk: BlockCfg,
    x: torch.Tensor,
    *,
    positions: torch.Tensor | None = None,
    chunk: int = 1024,
    shard=None,
) -> tuple[torch.Tensor, dict]:
    """Pre-norm residual application (training/forward path: the KAN FFN
    runs ``method="dense"``, as the reference's); returns ``(x, aux)``,
    ``aux`` an attn_moe block's auxiliary losses, else empty.  On a mesh
    (``shard``; attention blocks) it differentiates through the mesh's
    collectives."""
    check_supported(blk)
    _check_mesh(blk, shard)
    h = L.rmsnorm(params["ln1"], x, shard=shard)
    if blk.kind in RECURRENT:
        key, fwd, _, _ = RECURRENT[blk.kind]
        return x + fwd(params[key], _recurrent_cfg(blk), h), {}
    x = x + A.attn_forward(params["attn"], blk.attn, h, positions=positions, chunk=chunk,
                           shard=shard)
    y, aux = _ffn(params, blk, L.rmsnorm(params["ln2"], x, shard=shard), method="dense",
                  shard=shard)
    return x + y, aux


def block_supports_paging(blk: BlockCfg) -> bool:
    """Paged KV (DESIGN.md §3b) covers full-attention GQA layers (windowed
    rings and MLA latents do not strand per-token memory as a dense
    ``max_seq`` row does)."""
    return (blk.kind in ATTN_KINDS
            and blk.attn.kv_lora_rank is None and blk.attn.window is None)


def _local_kv(c: A.AttnConfig, shard) -> A.AttnConfig:
    """``c`` with this rank's KV heads (``kv_heads`` on ``model`` where it
    divides), to build a cache shard."""
    if shard is None:
        return c
    return dataclasses.replace(c, n_kv_heads=shard.local_shape(("kv_heads",), (c.n_kv_heads,))[0])


def _kv_leaves(c: A.AttnConfig, lead: tuple, dtype, device) -> dict:
    """Zeroed K/V leaves of shape ``lead + (KV, D)``: ``dtype`` values, or
    int8 values with fp32 ``lead + (KV,)`` scales under ``kv_quant``."""
    kv_dtype = torch.int8 if c.kv_quant else dtype
    shape = lead + (c.n_kv_heads, c.head_dim)
    cache = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
             "v": torch.zeros(shape, dtype=kv_dtype, device=device)}
    if c.kv_quant:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(lead + (c.n_kv_heads,), dtype=torch.float32,
                                      device=device)
    return cache


def block_cache_axes(blk: BlockCfg) -> dict:
    """Logical axes of :func:`block_init_cache`'s leaves, the reference's:
    ``seq_cache`` lets the data axis shard a cache's sequence when the
    batch cannot take it."""
    check_supported(blk)
    Ax = L.Axes
    if blk.kind == "mamba2":
        return {"ssm": Ax(("batch", "heads", "state", "head_dim")),
                "conv": Ax(("batch", None, "ffn"))}
    if blk.kind == "mlstm":
        return {"C": Ax(("batch", "heads", "head_dim", "head_dim")),
                "n": Ax(("batch", "heads", "head_dim")), "m": Ax(("batch", "heads")),
                "conv": Ax(("batch", None, "ffn"))}
    if blk.kind == "slstm":
        ax = Ax(("batch", "heads", "head_dim"))
        return {"c": ax, "n": ax, "h": ax, "m": ax}
    if blk.attn.kv_lora_rank is not None:
        return {"ckv": Ax(("batch", "seq_cache", "kv_lora"))}
    return _kv_axes(blk.attn, ("batch", "seq_cache"))


def block_paged_cache_axes(blk: BlockCfg) -> dict:
    """Logical axes of :func:`block_init_paged_cache`'s pools: ``kv_blocks``
    where a dense cache has ``batch`` and ``seq_cache``."""
    if not block_supports_paging(blk):
        raise NotImplementedError(f"paged KV cache: unsupported block kind {blk.kind!r}")
    return _kv_axes(blk.attn, ("kv_blocks", None))


def _kv_axes(c: A.AttnConfig, lead: tuple) -> dict:
    axes = {"k": L.Axes(lead + ("kv_heads", "head_dim")),
            "v": L.Axes(lead + ("kv_heads", "head_dim"))}
    if c.kv_quant:
        axes["k_scale"] = L.Axes(lead + ("kv_heads",))
        axes["v_scale"] = L.Axes(lead + ("kv_heads",))
    return axes


def block_init_paged_cache(blk: BlockCfg, n_blocks: int, block_size: int,
                           dtype, device, shard=None) -> dict:
    """Pool-shaped decode cache: ``(n_blocks, block_size, ...)`` leaves in
    place of :func:`block_init_cache`'s ``(batch, max_seq, ...)`` rows (on a
    mesh this rank's KV heads; the caller gives the blocks).
    Physical block 0 is the engine's sentinel (``serve/kv_pool.py``)."""
    if not block_supports_paging(blk):
        raise NotImplementedError(
            f"paged KV cache: unsupported block kind {blk.kind!r} "
            "(full-attention GQA layers only)")
    check_supported(blk)
    return _kv_leaves(_local_kv(blk.attn, shard), (n_blocks, block_size), dtype, device)


def block_init_cache(blk: BlockCfg, batch: int, max_seq: int, dtype,
                     device, shard=None) -> dict:
    """Per-block decode state: the ``(batch, S, KV, D)`` K/V rows, ``S`` =
    ``window`` slots for a windowed layer's ring, else ``max_seq``; an MLA
    layer's ``(batch, max_seq, r + rope)`` latent; a recurrent layer's state
    (fp32 but for the ``conv`` row, in ``dtype``, as the reference's).  On
    a mesh (``shard``) this rank's KV heads, or an MLA latent's ``kv_lora``
    columns (``block_cache_axes``); the caller gives the rows."""
    check_supported(blk)
    if blk.kind in RECURRENT:
        return RECURRENT[blk.kind][3](_recurrent_cfg(blk), batch, dtype, device)
    c = blk.attn
    if c.kv_lora_rank is not None:
        cols = c.kv_lora_rank + c.qk_rope_dim
        if shard is not None:
            cols = shard.local_shape(("kv_lora",), (cols,))[0]
        return {"ckv": torch.zeros((batch, max_seq, cols), dtype=dtype, device=device)}
    return _kv_leaves(_local_kv(c, shard), (batch, c.cache_len(max_seq)), dtype, device)


def block_prefill(
    params: dict,
    blk: BlockCfg,
    x: torch.Tensor,                  # (B, T, d)
    *,
    positions: torch.Tensor | None = None,
    cache: dict,                      # (B, S, ...) rows, filled in place
    chunk: int = 1024,
    shard=None,
) -> tuple[torch.Tensor, dict]:
    """Forward that also stores its K/V in ``cache`` in place: slots
    ``0..T-1``, or, for a ring shorter than the prompt (``S < T``), slot
    ``s`` holds the latest position ``p < T`` with ``p % S == s`` (decode
    then writes ``pos % S``).  Slots past T hold what the reference's
    zero-padded prefill cache holds: zeros, quantised like any other slot
    under ``kv_quant``.  An MLA layer stores its latent at slots ``0..T-1``;
    a recurrent layer its state after token ``T - 1`` (pads included: a
    right-padded prompt feeds its pads through the recurrence)."""
    check_supported(blk)
    _check_mesh(blk, shard)
    T = x.shape[1]
    h = L.rmsnorm(params["ln1"], x, shard=shard)
    if blk.kind in RECURRENT:
        key, fwd, _, _ = RECURRENT[blk.kind]
        y, st = fwd(params[key], _recurrent_cfg(blk), h, return_state=True)
        for name, t in st.items():
            cache[name].copy_(t)
        return x + y, cache
    c = blk.attn
    y, kv = A.attn_forward(params["attn"], c, h, positions=positions,
                           chunk=chunk, return_cache=True, shard=shard)
    if "ckv" in kv:
        cache["ckv"][:, :T] = kv["ckv"].to(cache["ckv"].dtype)
        return _residual_ffn(params, blk, x + y, shard), cache
    S = cache["k"].shape[1]
    if c.window and S < T:
        s_idx = torch.arange(S, device=x.device)
        p_s = (T - 1) - torch.remainder(T - 1 - s_idx, S)
        kv = {n: a[:, p_s] for n, a in kv.items()}
    n = min(S, T)
    if c.kv_quant:
        for name in ("k", "v"):
            qv, sc = A._kv_quantize(kv[name])
            cache[name][:, :n] = qv
            cache[name + "_scale"][:, :n] = sc
            if S > n:                 # the quantised zero pad
                pad_q, pad_sc = A._kv_quantize(kv[name].new_zeros((1, 1) + kv[name].shape[2:]))
                cache[name][:, n:] = pad_q
                cache[name + "_scale"][:, n:] = pad_sc
    else:
        cache["k"][:, :n] = kv["k"].to(cache["k"].dtype)
        cache["v"][:, :n] = kv["v"].to(cache["v"].dtype)
    # prefill sees B·T rows: "auto" resolves to the fused kernel on CUDA
    return _residual_ffn(params, blk, x + y, shard), cache


def block_prefill_paged(
    params: dict,
    blk: BlockCfg,
    x: torch.Tensor,                  # (B, Ts, d): uncached suffix tokens only
    *,
    positions: torch.Tensor,          # (B or 1, Ts) absolute positions
    cache: dict,                      # pool leaves (n_blocks, bs, ...), in place
    table: torch.Tensor,              # (B, n_logical)
    lengths: torch.Tensor,            # (B,) true total prompt lengths
    start: int,                       # first uncached position
    chunk: int = 1024,
    view_blocks: int | None = None,
    shard=None,
) -> tuple[torch.Tensor, dict]:
    """Suffix prefill writing K/V straight into pool blocks: the paged
    counterpart of :func:`block_prefill`.  A prefix-cache hit enters with
    ``start > 0`` and skips the cached positions."""
    if not block_supports_paging(blk):
        raise NotImplementedError(f"paged prefill: unsupported kind {blk.kind!r}")
    check_supported(blk)
    _check_mesh(blk, shard)
    h = L.rmsnorm(params["ln1"], x, shard=shard)
    y, cache = A.attn_prefill_paged(params["attn"], blk.attn, h, positions, cache,
                                    table, lengths, start, chunk=chunk,
                                    view_blocks=view_blocks, shard=shard)
    return _residual_ffn(params, blk, x + y, shard), cache


def block_decode_step(
    params: dict,
    blk: BlockCfg,
    x: torch.Tensor,                  # (B, 1, d)
    cache: dict,                      # updated in place
    pos: torch.Tensor,                # scalar or (B,)
    table: torch.Tensor | None = None,  # (B, n_logical): paged block table
    shard=None,
) -> tuple[torch.Tensor, dict]:
    """One decode step; with ``table``, ``cache`` holds pools and the step
    reads and writes through the block table."""
    check_supported(blk)
    _check_mesh(blk, shard)
    if table is not None and not block_supports_paging(blk):
        raise NotImplementedError(f"paged decode: unsupported kind {blk.kind!r}")
    h = L.rmsnorm(params["ln1"], x, shard=shard)
    if blk.kind in RECURRENT:            # the position does not enter the state
        key, _, step, _ = RECURRENT[blk.kind]
        y, cache = step(params[key], _recurrent_cfg(blk), h, cache)
        return x + y, cache
    if table is not None:
        y, cache = A.attn_decode_step_paged(params["attn"], blk.attn, h, cache,
                                            table, pos, shard)
    elif blk.attn.kv_lora_rank is not None:
        y, ckv = A.mla_decode_step(params["attn"], blk.attn, h, cache["ckv"], pos, shard)
        cache["ckv"] = ckv
    else:
        y, cache = A.attn_decode_step(params["attn"], blk.attn, h, cache, pos, shard)
    # decode sees B rows: "auto" resolves to the sparse kernel on CUDA
    return _residual_ffn(params, blk, x + y, shard), cache


# kanlint's KL105: a mesh serves no speculative window (ROADMAP queue 1,
# item 9.4), so no ShardingCtx reaches these cache writes.
def block_verify_window(  # kanlint: ignore[KL105]
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
    # the FFN sees B·W rows: "auto" resolves to the fused kernel on CUDA
    # when B·W > $KAN_SAS_SPARSE_MAX_ROWS (8)
    return _residual_ffn(params, blk, x + y), cache
