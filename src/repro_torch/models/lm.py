"""Decoder LM in PyTorch (counterpart of ``repro/models/lm.py``).

The model is a repeating ``unit`` of blocks driven ``n_repeats`` times.  As
in the reference, the unit's parameters (and its decode caches) are stacked
along a leading layers axis; here a Python loop walks that axis, and the
caches are updated in place through views of the stacked buffers.

Prologue, epilogue and shared blocks, and inputs other than tokens, are not
ported yet; a config that uses them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.blocks import BlockCfg


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab: int
    unit: tuple[BlockCfg, ...]
    n_repeats: int
    prologue: tuple[BlockCfg, ...] = ()
    epilogue: tuple[BlockCfg, ...] = ()
    shared: tuple[BlockCfg, ...] = ()
    input_kind: str = "tokens"
    max_seq: int = 8192
    attn_chunk: int = 1024
    logit_softcap: float | None = None

    @property
    def n_layers(self) -> int:
        return len(self.prologue) + len(self.unit) * self.n_repeats + len(self.epilogue)


def check_supported(cfg: ModelConfig) -> None:
    if cfg.prologue or cfg.epilogue or cfg.shared or cfg.input_kind != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: prologue/epilogue/shared blocks and non-token inputs "
            "are not ported yet (ROADMAP queue 1, item 13)")
    for blk in cfg.unit:
        B.check_supported(blk)


# ---------------------------------------------------------------------------
# Parameters: the reference's tree, shapes and init scales (ParamCtx.make).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter leaf: shape, init (``normal|ones|zeros``) and the
    normal scale (``None``: ``1/sqrt(fan_in)`` over all but the last axis)."""

    shape: tuple[int, ...]
    init: str = "normal"
    scale: float | None = None


def _block_shapes(d: int, blk: BlockCfg) -> dict:
    """``ParamSpec`` tree of one attn_kan block, as ``blocks.block_init`` /
    ``attention.attn_init`` / ``blocks._kan_ffn_init`` build it."""
    a = blk.attn
    h, kv, hd = a.n_heads, a.n_kv_heads, a.head_dim
    M_ = blk.kan_grid.n_basis
    attn = {
        "wq": ParamSpec((d, h, hd), "normal", None),
        "wk": ParamSpec((d, kv, hd), "normal", None),
        "wv": ParamSpec((d, kv, hd), "normal", None),
        "wo": ParamSpec((h, hd, d), "normal", None),
    }
    if a.qkv_bias:
        attn["bq"] = ParamSpec((h, hd), "zeros", None)
        attn["bk"] = ParamSpec((kv, hd), "zeros", None)
        attn["bv"] = ParamSpec((kv, hd), "zeros", None)
    ff = blk.kan_ff
    return {
        "ln1": {"scale": ParamSpec((d,), "ones", None)},
        "attn": attn,
        "ln2": {"scale": ParamSpec((d,), "ones", None)},
        "kan": {
            "c1": ParamSpec((d, M_, ff), "normal", 0.02),
            "b1": ParamSpec((d, ff), "normal", 0.02),
            "c2": ParamSpec((ff, M_, d), "normal", 0.02),
            "b2": ParamSpec((ff, d), "normal", 0.02),
        },
    }


def param_shapes(cfg: ModelConfig) -> dict:
    """Tree of :class:`ParamSpec` leaves mirroring ``lm.model_init``
    (unit leaves carry the leading ``n_repeats`` layers axis)."""
    check_supported(cfg)
    d = cfg.d_model

    def stack(tree):
        if isinstance(tree, dict):
            return {k: stack(v) for k, v in tree.items()}
        return dataclasses.replace(tree, shape=(cfg.n_repeats,) + tree.shape)

    return {
        "embed": {"table": ParamSpec((cfg.vocab, d), "normal", 1.0)},
        "final_ln": {"scale": ParamSpec((d,), "ones", None)},
        "unit": [stack(_block_shapes(d, blk)) for blk in cfg.unit],
    }


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype=torch.float32) -> dict:
    """Random parameters with the reference's tree, shapes and scales.

    Normal leaves are ``scale * N(0, 1)`` with the reference's default scale
    ``1/sqrt(fan_in)`` over all but the last axis (per layer for the stacked
    unit leaves); ``ones``/``zeros`` leaves as named.  Values come from a
    ``torch.Generator`` seeded with ``seed`` and differ from JAX's draws.
    """
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(leaf: ParamSpec, stacked):
        shape, init, scale = leaf.shape, leaf.init, leaf.scale
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        per_layer = shape[1:] if stacked else shape
        if scale is None:
            scale = 1.0 / math.sqrt(max(1, math.prod(per_layer[:-1])))
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (scale * w).to(dtype)

    def walk(tree, stacked):
        if isinstance(tree, dict):
            return {k: walk(v, stacked) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, stacked) for v in tree]
        return make(tree, stacked)

    shapes = param_shapes(cfg)
    return {
        "embed": walk(shapes["embed"], False),
        "final_ln": walk(shapes["final_ln"], False),
        "unit": walk(shapes["unit"], True),
    }


def _layer(tree, r: int):
    """Slice ``r`` of the stacked layers axis of every leaf (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_layer(v, r) for v in tree]
    return tree[r]


# ---------------------------------------------------------------------------
# Decode (serving).
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.float32, device="cuda") -> dict:
    """Zeroed KV caches: ``{"unit": [{"k", "v"}: (n_repeats, batch, max_seq,
    KV, D)]}``, the reference's stacked layout."""
    check_supported(cfg)
    unit = []
    for blk in cfg.unit:
        one = B.block_init_cache(blk, batch, max_seq, dtype, device)
        unit.append({k: v[None].repeat((cfg.n_repeats,) + (1,) * v.dim())
                     for k, v in one.items()})
    return {"unit": unit}


def _logits(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(params["final_ln"], h)
    logits = L.unembed_logits(params["embed"], h)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


@torch.no_grad()
def prefill(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,             # (B, T) int
    max_seq: int,
    compute_dtype=torch.float32,
) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that fills fresh decode caches.

    Returns ``(logits (B, T, vocab) fp32, caches)``; each cache row holds the
    prompt's K/V at slots ``0..T-1`` and zeros beyond."""
    Bsz, T = tokens.shape
    dev = tokens.device
    h = L.embed_lookup(params["embed"], tokens, compute_dtype) * math.sqrt(cfg.d_model)
    positions = torch.arange(T, device=dev)[None, :]
    caches = init_caches(cfg, Bsz, max_seq, compute_dtype, dev)
    for r in range(cfg.n_repeats):
        rep = _layer(params["unit"], r)
        for i, blk in enumerate(cfg.unit):
            h, _ = B.block_prefill(rep[i], blk, h, positions=positions,
                                   cache=_layer(caches["unit"][i], r),
                                   chunk=cfg.attn_chunk)
    return _logits(params, cfg, h), caches


# kanlint's KL105 (thread a ShardingCtx through cache writes) is the JAX
# package's mesh contract; on one device the in-place writes have no
# sharding to pin.  Mesh serving is ROADMAP queue 1, item 14.
@torch.no_grad()
def decode_step(  # kanlint: ignore[KL105]
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,             # (B, 1) int
    caches: dict,                     # updated in place
    pos: torch.Tensor,                # scalar or (B,) int
    compute_dtype=torch.float32,
) -> tuple[torch.Tensor, dict]:
    """One decode step for the whole model -> ``(logits (B, vocab), caches)``."""
    h = L.embed_lookup(params["embed"], tokens, compute_dtype) * math.sqrt(cfg.d_model)
    for r in range(cfg.n_repeats):
        rep = _layer(params["unit"], r)
        for i, blk in enumerate(cfg.unit):
            h, _ = B.block_decode_step(rep[i], blk, h,
                                       _layer(caches["unit"][i], r), pos)
    return _logits(params, cfg, h)[:, 0], caches
