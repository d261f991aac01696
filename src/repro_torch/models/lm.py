"""Decoder LM in PyTorch (counterpart of ``repro/models/lm.py``).

The model is ``prologue + unit * n_repeats + epilogue``.  As in the
reference, the unit's parameters (and its decode caches) are stacked along
a leading layers axis; here a Python loop walks that axis
(:func:`_walk`), and the caches are updated in place through views of the
stacked buffers.  Prologue and epilogue blocks (deepseek-v2-lite's dense
first layer) keep lists of unstacked parameters and caches.  So a dense
cache leaf is ``(n_repeats, B, S, ...)`` in the unit and ``(B, S, ...)`` in
the prologue and epilogue: the batch axis is axis 1 of a stacked leaf and
axis 0 of the others (the reference finds it by name through
``cache_axes``), whatever follows ``S`` (``KV, D`` of a K/V leaf, ``r +
rope`` of an MLA latent).  Paged pools are ``([n_repeats,] n_blocks,
block_size, KV, D)``.  Each block has its own cache entry, so the blocks of
one unit may differ in cache length (gemma3: five ``window``-slot rings and
one ``max_seq`` cache) and an int8 KV cache adds ``k_scale``/``v_scale``
leaves beside ``k``/``v``.  A recurrent block's cache is its per-request
state (``models/ssm.py``, ``models/xlstm.py``), laid out the same way:
batch on axis 1 of a stacked leaf, 0 elsewhere.

Shared blocks (zamba2's shared attention): ``params["shared"]`` holds one
unstacked tree per entry of ``cfg.shared``, and a unit block with
``shared_id`` runs with ``params["shared"][shared_id]`` in place of its own
stacked parameters, which the tree keeps but nothing reads (the reference's
``abstract_params`` has them too); its cache stays its own, one per repeat.

:func:`forward` returns the reference's auxiliary losses, the MoE blocks'
``moe_lb_loss``, ``moe_z_loss`` and ``moe_drop_frac`` summed over layers
(zeros without MoE blocks).  It follows the caller's grad mode, so
:func:`lm_loss` (next-token cross-entropy plus the weighted MoE losses)
trains through it; ``prefill``, ``decode_step`` and ``verify_window``
run under ``torch.no_grad``.

Inputs come in the reference's three kinds (``ModelConfig.input_kind``):
``{"tokens"}`` (embedded and scaled by sqrt(d)), ``{"embeddings"}``
(precomputed ``(B, T, d)`` frames taken as they are: musicgen's stubbed
EnCodec frontend) and ``{"prefix_embeddings", "tokens"}`` (``n_prefix``
patch embeddings before the scaled text embeddings: paligemma's stubbed
SigLIP tower).  A bare tensor means ``{"tokens": tensor}``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.convert import tree_map
from repro_torch.models import attention as A
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
    input_kind: str = "tokens"          # "tokens" | "embeddings" | "mixed"
    n_prefix: int = 0                   # mixed: image/audio prefix length
    max_seq: int = 8192
    attn_chunk: int = 1024
    logit_softcap: float | None = None

    @property
    def n_layers(self) -> int:
        return len(self.prologue) + len(self.unit) * self.n_repeats + len(self.epilogue)


AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")
PARTS = ("prologue", "unit", "epilogue")      # a tree's parts in depth order
# the inputs dict each input kind takes
INPUT_KEYS = {"tokens": ("tokens",), "embeddings": ("embeddings",),
              "mixed": ("prefix_embeddings", "tokens")}


def check_supported(cfg: ModelConfig) -> None:
    if cfg.input_kind not in INPUT_KEYS:
        raise ValueError(f"{cfg.name}: input_kind {cfg.input_kind!r} is not one of "
                         f"{', '.join(INPUT_KEYS)}")
    for blk in cfg.prologue + cfg.unit + cfg.epilogue + cfg.shared:
        B.check_supported(blk)


# ---------------------------------------------------------------------------
# Parameters: the reference's tree, shapes and init scales (ParamCtx.make).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter leaf: shape, logical axes (``dist/sharding.py``'s
    names, one per dimension, as the reference's ``ParamCtx.make`` gives
    them), init (``normal|ones|zeros``) and the normal scale (``None``:
    ``1/sqrt(fan_in)`` over all but the last axis)."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"
    scale: float | None = None


def _norm(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), "ones")}


def _recurrent_shapes(d: int, blk: BlockCfg) -> dict:
    """The mixer of a recurrent block, as ``ssm.mamba2_init`` /
    ``xlstm.mlstm_init`` / ``xlstm.slstm_init`` build it."""
    if blk.kind == "mamba2":
        m = blk.mamba
        di, H, GN = m.d_inner, m.n_heads, m.n_groups * m.d_state
        return {"in_proj": ParamSpec((d, 2 * di + 2 * GN + H), ("embed", "ffn")),
                "conv_w": ParamSpec((m.conv_width, m.conv_dim), (None, "ffn"), "normal", 0.5),
                "conv_b": ParamSpec((m.conv_dim,), ("ffn",), "zeros"),
                "A_log": ParamSpec((H,), ("heads",), "ones"),
                "D": ParamSpec((H,), ("heads",), "ones"),
                "dt_bias": ParamSpec((H,), ("heads",), "zeros"),
                "norm": ParamSpec((di,), ("ffn",), "ones"),
                "out_proj": ParamSpec((di, d), ("ffn", "embed"))}
    x = blk.xlstm
    H = x.n_heads
    if blk.kind == "mlstm":
        di = x.d_inner
        fh = ("ffn", "heads")
        return {"up": ParamSpec((d, 2 * di), ("embed", "ffn")),
                "conv_w": ParamSpec((x.conv_width, di), (None, "ffn"), "normal", 0.5),
                "conv_b": ParamSpec((di,), ("ffn",), "zeros"),
                "wq": ParamSpec((di, di), fh), "wk": ParamSpec((di, di), fh),
                "wv": ParamSpec((di, di), fh),
                "w_i": ParamSpec((di, H), fh, "normal", 0.02),
                "w_f": ParamSpec((di, H), fh, "normal", 0.02),
                "b_i": ParamSpec((H,), ("heads",), "zeros"),
                "b_f": ParamSpec((H,), ("heads",), "ones"),
                "norm": ParamSpec((di,), ("ffn",), "ones"),
                "down": ParamSpec((di, d), ("ffn", "embed"))}
    tree = {"norm": ParamSpec((d,), ("embed",), "ones")}
    for g in "zifo":
        tree[f"w_{g}"] = ParamSpec((d, d), ("embed", "heads"), "normal", 0.02)
        tree[f"r_{g}"] = ParamSpec((H, d // H, d // H), ("heads", None, None), "normal", 0.02)
        tree[f"b_{g}"] = ParamSpec((d,), ("heads",), "ones" if g == "f" else "zeros")
    return tree


def _block_shapes(d: int, blk: BlockCfg) -> dict:
    """``ParamSpec`` tree of one block, as ``blocks.block_init`` /
    ``attention.attn_init`` / ``blocks._mlp_init`` / ``moe.moe_init`` /
    ``blocks._kan_ffn_init`` build it; a recurrent block is its pre-norm
    and its mixer."""
    if blk.kind in B.RECURRENT:
        return {"ln1": _norm(d), B.RECURRENT[blk.kind][0]: _recurrent_shapes(d, blk)}
    a = blk.attn
    h, kv, hd = a.n_heads, a.n_kv_heads, a.head_dim
    if a.kv_lora_rank is None:
        attn = {
            "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
            "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
            "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
            "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
        }
    else:                              # MLA: the nope part of q/k is head_dim wide
        r, rope = a.kv_lora_rank, a.qk_rope_dim
        attn = {
            "wq": ParamSpec((d, h, hd + rope), ("embed", "heads", "head_dim")),
            "w_dkv": ParamSpec((d, r + rope), ("embed", "kv_lora")),
            "w_uk": ParamSpec((r, h, hd), ("kv_lora", "heads", "head_dim")),
            "w_uv": ParamSpec((r, h, hd), ("kv_lora", "heads", "head_dim")),
            "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
            "kv_norm": ParamSpec((r,), ("kv_lora",), "ones"),
        }
    if a.qkv_bias and a.kv_lora_rank is None:
        attn["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), "zeros")
        attn["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), "zeros")
        attn["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), "zeros")
    if a.qk_norm:
        attn["q_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
        attn["k_norm"] = ParamSpec((hd,), ("head_dim",), "ones")
    tree = {"ln1": _norm(d), "attn": attn, "ln2": _norm(d)}
    if blk.kind == "attn_mlp":
        ff = blk.d_ff
        tree["mlp"] = {"wi": ParamSpec((d, ff), ("embed", "ffn")),
                       "wg": ParamSpec((d, ff), ("embed", "ffn")),
                       "wo": ParamSpec((ff, d), ("ffn", "embed"))}
    elif blk.kind == "attn_moe":
        m = blk.moe
        f, e = m.d_ff, m.n_experts
        tree["moe"] = {"router": ParamSpec((d, e), ("embed", "experts"), "normal", 0.02),
                       "wi": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
                       "wo": ParamSpec((e, f, d), ("experts", "ffn", "embed"))}
        if m.gated:
            tree["moe"]["wg"] = ParamSpec((e, d, f), ("experts", "embed", "ffn"))
        if m.n_shared:
            fs = f * m.n_shared
            tree["moe"].update(shared_wi=ParamSpec((d, fs), ("embed", "ffn")),
                               shared_wg=ParamSpec((d, fs), ("embed", "ffn")),
                               shared_wo=ParamSpec((fs, d), ("ffn", "embed")))
    else:
        ff, M_ = blk.kan_ff, blk.kan_grid.n_basis
        tree["kan"] = {
            "c1": ParamSpec((d, M_, ff), ("embed", None, "ffn"), "normal", 0.02),
            "b1": ParamSpec((d, ff), ("embed", "ffn"), "normal", 0.02),
            "c2": ParamSpec((ff, M_, d), ("ffn", None, "embed"), "normal", 0.02),
            "b2": ParamSpec((ff, d), ("ffn", "embed"), "normal", 0.02),
        }
    return tree


def param_shapes(cfg: ModelConfig) -> dict:
    """Tree of :class:`ParamSpec` leaves mirroring ``lm.model_init``
    (unit leaves carry the leading ``n_repeats`` layers axis, a shared
    block's unread copy too; prologue, epilogue and shared blocks are lists
    of unstacked trees)."""
    check_supported(cfg)
    d = cfg.d_model

    def stack(tree):
        if isinstance(tree, dict):
            return {k: stack(v) for k, v in tree.items()}
        return dataclasses.replace(tree, shape=(cfg.n_repeats,) + tree.shape,
                                   axes=("layers",) + tree.axes)

    tree = {
        "embed": {"table": ParamSpec((cfg.vocab, d), ("vocab", "embed"), "normal", 1.0)},
        "final_ln": _norm(d),
        "unit": [stack(_block_shapes(d, blk)) for blk in cfg.unit],
    }
    for part in ("prologue", "epilogue", "shared"):
        if getattr(cfg, part):
            tree[part] = [_block_shapes(d, blk) for blk in getattr(cfg, part)]
    return tree


def param_axes(cfg: ModelConfig) -> dict:
    """The reference's ``param_axes``: an :class:`~layers.Axes` leaf per
    parameter (stacked unit leaves lead with ``layers``)."""
    return tree_map(lambda leaf: L.Axes(leaf.axes), param_shapes(cfg))


def tree_of_shapes(tree) -> dict:
    """The shape of every leaf of a :class:`ParamSpec` or tensor tree."""
    return tree_map(lambda leaf: tuple(leaf.shape), tree)


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
        return w.mul_(scale).to(dtype)          # in place: a 19 GB expert leaf, not two

    def walk(tree, stacked):
        if isinstance(tree, dict):
            return {k: walk(v, stacked) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, stacked) for v in tree]
        return make(tree, stacked)

    return {k: walk(v, k == "unit") for k, v in param_shapes(cfg).items()}


def _layer(tree, r: int):
    """Slice ``r`` of the stacked layers axis of every leaf (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_layer(v, r) for v in tree]
    return tree[r]


def _layers(tree, n: int) -> list:
    """Every slice of the stacked layers axis of every leaf, ``n`` trees of
    views made by one ``unbind`` per leaf.  Its backward is one ``stack``;
    ``n`` separate selects would each build a zero tensor of the whole
    stacked leaf for its gradient, ``n`` times the leaf's bytes to fill and
    add (48 layers of 3.2 GB leaves in musicgen-large)."""
    if isinstance(tree, dict):
        per = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[r] for k, v in per.items()} for r in range(n)]
    if isinstance(tree, list):
        per = [_layers(v, n) for v in tree]
        return [[v[r] for v in per] for r in range(n)]
    return tree.unbind(0)


def _walk(params: dict, cfg: ModelConfig, caches: dict | None = None):
    """``(block params, BlockCfg, block cache or None)`` of every block in
    depth order: the prologue's, the unit's repeat by repeat (views of the
    stacked leaves; a block with ``shared_id`` takes
    ``params["shared"][shared_id]`` and keeps its own cache, as the
    reference's unit body), the epilogue's."""
    shared = params.get("shared", [])
    for part in PARTS:
        blks = getattr(cfg, part)
        if not blks:
            continue
        stacked = part == "unit"
        per_layer = _layers(params[part], cfg.n_repeats) if stacked else [params[part]]
        for r, ps in enumerate(per_layer):
            cs = None if caches is None else (_layer(caches[part], r) if stacked
                                              else caches[part])
            for i, blk in enumerate(blks):
                p = shared[blk.shared_id] if stacked and blk.shared_id is not None else ps[i]
                yield p, blk, None if cs is None else cs[i]


def _cache_parts(caches: dict):
    """``(part, block caches, stacked)`` of each part a cache tree holds:
    unit leaves carry the leading layers axis, the others do not."""
    for part in PARTS:
        if part in caches:
            yield part, caches[part], part == "unit"


# ---------------------------------------------------------------------------
# Forward (the whole sequence, no cache) and the training loss.
# ---------------------------------------------------------------------------


def _embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor, dtype,
                  shard=None) -> torch.Tensor:
    """Scaled token embeddings (vocab-parallel on a mesh)."""
    e = L.embed_lookup(params["embed"], tokens, dtype, shard, (cfg.vocab, cfg.d_model))
    return e * math.sqrt(cfg.d_model)


def _embed_inputs(params: dict, cfg: ModelConfig, inputs, dtype, shard=None) -> torch.Tensor:
    """The first hidden state ``(B, T, d)`` of an inputs dict (or a bare
    token tensor): scaled token embeddings, precomputed embeddings as they
    are, or ``mixed``'s prefix before the scaled text embeddings."""
    if not isinstance(inputs, dict):
        inputs = {"tokens": inputs}
    missing = [k for k in INPUT_KEYS[cfg.input_kind] if k not in inputs]
    if missing:
        raise KeyError(f"{cfg.name}: input_kind {cfg.input_kind!r} takes "
                       f"{INPUT_KEYS[cfg.input_kind]}; missing {missing}")
    if cfg.input_kind == "embeddings":
        return inputs["embeddings"].to(dtype)
    txt = _embed_tokens(params, cfg, inputs["tokens"], dtype, shard)
    if cfg.input_kind == "mixed":
        return torch.cat([inputs["prefix_embeddings"].to(dtype), txt], dim=1)
    return txt


def check_mesh(cfg: ModelConfig, shard) -> None:
    """Raise ``ValueError`` with :func:`mesh_refusal`'s reason when a mesh
    is asked for a model it does not take."""
    why = None if shard is None else mesh_refusal(cfg)
    if why:
        raise ValueError(why)


def forward(params: dict, cfg: ModelConfig, inputs,
            compute_dtype=torch.float32, shard=None) -> tuple[torch.Tensor, dict]:
    """``inputs`` (see the module docstring) -> ``(logits (B, T, vocab)
    fp32, aux)``: the reference's ``lm.forward`` (no remat), ``aux`` its
    fp32 auxiliary losses summed over the blocks (:data:`AUX_KEYS`; zeros
    without MoE blocks).  Windowed layers use the sliding flash mask.  It
    records for autograd when grad is on and a parameter requires grad.
    On a mesh (``shard``, the parameters this rank's shards) the rows are
    the ones this rank was given (under ``shard.split_rows()`` its block of
    a batch split over ``data``, which the MoE routes as one), and the
    vocabulary split of the logits is gathered whole (``gather_whole``:
    every model rank then computes the same thing from them)."""
    check_supported(cfg)
    check_mesh(cfg, shard)
    h = _embed_inputs(params, cfg, inputs, compute_dtype, shard)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    aux = {k: torch.zeros((), device=h.device) for k in AUX_KEYS}
    for p, blk, _ in _walk(params, cfg):
        h, a = B.block_apply(p, blk, h, positions=positions, chunk=cfg.attn_chunk, shard=shard)
        for k, v in a.items():
            aux[k] = aux[k] + v
    logits = _logits(params, cfg, h, shard)
    if shard is not None:
        lead = tuple(logits.shape[:-1])
        logits = shard.gather_whole(logits, (None,) * len(lead) + ("vocab",),
                                    lead + (cfg.vocab,))
    return logits, aux


def lm_loss(params: dict, cfg: ModelConfig, batch: dict, compute_dtype=torch.float32,
            aux_weight: float = 0.01, shard=None) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy over ``batch["labels"]`` (aligned with the
    token positions, -100 masked; a ``mixed`` model's ``n_prefix`` prefix
    positions are masked too) plus ``aux_weight`` times the MoE balance
    and z losses -> ``(total, metrics)``: ``loss``, ``ntokens`` (labels >=
    0), the MoE losses, ``moe_drop_frac`` and ``total_loss``, as the
    reference's ``lm_loss``.  On a mesh each data rank holds its rows of
    the batch; the loss is the mean over the whole batch's label tokens
    (``ntokens`` summed over ``data``), each rank's share summed over
    ``data`` with a backward that keeps the share's own gradient, and the
    MoE auxiliaries are the whole batch's (``models/moe.py``)."""
    logits, aux = forward(params, cfg, batch, compute_dtype,
                          None if shard is None else shard.split_rows())
    labels = batch["labels"].long()
    if cfg.input_kind == "mixed":
        pad = labels.new_full((labels.shape[0], cfg.n_prefix), -100)
        labels = torch.cat([pad, labels], dim=1)
    mask = (labels >= 0).float()
    ntokens = mask.sum()
    if shard is not None:
        ntokens = shard.reduce_from(ntokens, "data")
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp(0, cfg.vocab - 1)[..., None])[..., 0]
    loss = (nll * mask).sum() / torch.clamp_min(ntokens, 1.0)
    if shard is not None:
        loss = shard.reduce_from(loss, "data")
    metrics = {"loss": loss, "ntokens": ntokens}
    total = loss
    for k in ("moe_lb_loss", "moe_z_loss"):
        total = total + aux_weight * aux[k]
        metrics[k] = aux[k]
    metrics["moe_drop_frac"] = aux["moe_drop_frac"]
    metrics["total_loss"] = total
    return total, metrics


# ---------------------------------------------------------------------------
# Decode (serving).
# ---------------------------------------------------------------------------


def mesh_refusal(cfg: ModelConfig) -> str | None:
    """Why a mesh cannot serve or train ``cfg`` yet, or None: the port's
    mesh takes token-input models of full-attention (GQA or MLA)
    ``attn_kan``, ``attn_mlp`` and ``attn_moe`` blocks (the reference shards
    every family through GSPMD)."""
    why = None
    if cfg.input_kind != "tokens":
        why = f"{cfg.input_kind!r} inputs"
    for blk in cfg.prologue + cfg.unit + cfg.epilogue + cfg.shared:
        if why:
            break
        if blk.kind not in B.ATTN_KINDS:
            why = f"recurrent {blk.kind} blocks"
        elif blk.attn.window is not None:
            why = "windowed attention"
    if why is None:
        return None
    return (f"{cfg.name}: a mesh does not take {why} yet (not ported: ROADMAP queue 1, "
            "item 9.4.2); a mesh serves and trains token-input attn_kan, attn_mlp and "
            "attn_moe models of full attention, GQA or MLA")


def cache_axes(cfg: ModelConfig) -> dict:
    """Logical-axes tree mirroring :func:`init_caches` (stacked unit caches
    lead with ``layers``), the reference's ``cache_axes``."""
    return _axes_tree(cfg, B.block_cache_axes)


def paged_cache_axes(cfg: ModelConfig) -> dict:
    """Logical-axes tree mirroring :func:`init_paged_caches`."""
    return _axes_tree(cfg, B.block_paged_cache_axes)


def _axes_tree(cfg: ModelConfig, one_block) -> dict:
    axes = {}
    for part in PARTS:
        made = [one_block(blk) for blk in getattr(cfg, part)]
        if part == "unit":
            made = [{k: L.Axes(("layers",) + a.names) for k, a in c.items()} for c in made]
        if made or part == "unit":
            axes[part] = made
    return axes


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.float32, device="cuda", shard=None) -> dict:
    """Zeroed decode caches: ``{"unit": [{"k", "v"[, "k_scale", "v_scale"]}
    or {"ckv"}: (n_repeats, batch, S, ...)]}``, the reference's stacked
    layout, ``S`` each block's own cache length (``window`` for a ring), or
    a recurrent block's ``(n_repeats, batch, ...)`` state leaves, and
    ``"prologue"``/``"epilogue"`` lists of unstacked caches where the model
    has such blocks.  Each leaf takes the reference's dtype (``dtype``, or
    fp32 for a recurrent state but its ``conv`` row).

    On a mesh each rank builds its shard: the rows of
    ``shard.for_rows(batch).row_range()``, and its KV heads or its MLA
    latent columns (``kv_lora`` on ``model``).  Where the data axis does not
    divide ``batch``, the reference shards ``seq_cache`` instead; the port
    keeps every row and position on every data rank."""
    check_supported(cfg)
    rows = None if shard is None else shard.for_rows(batch).row_range()
    n = batch if rows is None else rows[1]
    return _make_caches(cfg, lambda blk: B.block_init_cache(blk, n, max_seq, dtype, device,
                                                           shard))


def _make_caches(cfg: ModelConfig, one_block) -> dict:
    """A cache tree from ``one_block(blk)``: the unit's stacked
    ``n_repeats`` times, the prologue's and epilogue's as they are."""
    caches = {}
    for part in PARTS:
        made = [one_block(blk) for blk in getattr(cfg, part)]
        if part == "unit":
            made = [{k: v[None].repeat((cfg.n_repeats,) + (1,) * v.dim()) for k, v in c.items()}
                    for c in made]
        if made or part == "unit":
            caches[part] = made
    return caches


def model_supports_paging(cfg: ModelConfig) -> bool:
    """Every block must hold a full-attention GQA KV cache (DESIGN.md §3b)."""
    blks = cfg.prologue + cfg.unit + cfg.epilogue + cfg.shared
    return all(B.block_supports_paging(b) for b in blks)


def model_supports_speculative(cfg: ModelConfig) -> bool:
    """Speculative verify takes a W-token window in one pass: the
    full-attention GQA condition of paging, plus token inputs (the drafter
    re-embeds accepted tokens)."""
    return model_supports_paging(cfg) and cfg.input_kind == "tokens"


def model_kv_quant(cfg: ModelConfig) -> bool:
    """True if any attention block stores an int8-quantized KV cache."""
    blks = cfg.prologue + cfg.unit + cfg.epilogue + cfg.shared
    return any(b.attn is not None and b.attn.kv_quant for b in blks)


def init_paged_caches(cfg: ModelConfig, n_blocks: int, block_size: int,
                      dtype=torch.float32, device="cuda", shard=None) -> dict:
    """Zeroed pools ``{"unit": [{"k", "v"[, "k_scale", "v_scale"]}:
    (n_repeats, n_blocks, block_size, ...)]}`` (and unstacked prologue and
    epilogue pools): one physical block id addresses every layer's pool, so
    one allocation covers a token's KV through the whole depth.  On a mesh
    each rank builds its shard: the blocks of
    ``shard.for_pool(n_blocks).block_range()`` and its KV heads."""
    check_supported(cfg)
    if not model_supports_paging(cfg):
        raise NotImplementedError(
            f"{cfg.name}: paged KV needs full-attention GQA blocks throughout")
    blocks = None if shard is None else shard.for_pool(n_blocks).block_range()
    n = n_blocks if blocks is None else blocks[1]
    return _make_caches(cfg, lambda blk: B.block_init_paged_cache(blk, n, block_size, dtype,
                                                                 device, shard))


def paged_views(caches: dict, table: torch.Tensor, shard=None) -> dict:
    """The logical dense view of every pool, shaped as :func:`init_caches`
    (batch = table rows, seq = n_logical·block_size): the engine's "shadow"
    read path gathers it once per decode chunk, runs the dense decode on it
    and writes the chunk's span back with :func:`writeback_paged_chunk`.
    One gather launch per block of the tree covers its leaves (the four of
    an int8 cache too) and, in the unit, every stacked layer (the
    reference's ``vmap``).  On a mesh (``shard.for_pool``) the view holds
    every row on every rank (``attention.paged_view``)."""
    return {part: [A.paged_view(c, table, shard, stacked) for c in cs]
            for part, cs, stacked in _cache_parts(caches)}


def writeback_paged_chunk(
    caches: dict, view: dict, table: torch.Tensor, pos0: torch.Tensor, steps: int,
    shard=None,
) -> dict:
    """Scatter a finished chunk's writes from the dense shadow ``view`` back
    into the pools, in place.

    The chunk wrote rows only at positions ``pos0[b] .. pos0[b] + steps -
    1`` (latched rows rewrote their frozen slot; the other positions of the
    window still hold the gathered pool values, so copying them back changes
    nothing).  Positions past the table (a chunk overrunning ``max_seq``) go
    to the sentinel block through ``attention.paged_route``.  On a mesh each
    block is written by its owner only (``attention.put_blocks``)."""
    dev = pos0.device
    positions = pos0.reshape(-1, 1) + torch.arange(steps, device=dev)[None, :]
    rows = torch.arange(positions.shape[0], device=dev)[:, None]
    block_size = caches["unit"][0]["k"].shape[2]
    phys, off = (t.long() for t in A.paged_route(table, positions, block_size))
    for part, cs, stacked in _cache_parts(caches):
        for pools, views in zip(cs, view[part]):
            for name, pool in pools.items():
                v = views[name] if stacked else views[name][None]      # (R, B, S, ...)
                vals = v[:, rows, torch.clamp_max(positions, v.shape[2] - 1)]
                A.put_blocks(pool if stacked else pool[None], phys, off, vals.to(pool.dtype),
                             shard, stacked=True)
    return caches


def copy_paged_blocks(caches: dict, srcs, dsts, shard=None) -> dict:
    """Copy physical blocks ``srcs[i] -> dsts[i]`` in every pool leaf, in
    place: the data half of copy-on-write (``kv_pool.BlockPool.copy_on_write``
    rebinds the table).  One gather and one scatter per leaf for the whole
    batch of copies.  ``dsts`` must be pairwise distinct (the pool's fresh
    blocks are).  On a mesh whose data axis splits the pool
    (``shard.for_pool``), a source's owner contributes its block to one
    ``all_reduce`` over ``data`` and a destination's owner writes it."""
    dev = caches["unit"][0]["k"].device
    idx = torch.as_tensor(srcs, device=dev).reshape(-1).long()
    dst = torch.as_tensor(dsts, device=dev).reshape(-1).long()
    owned = None if shard is None else shard.block_range()
    for _, cs, stacked in _cache_parts(caches):
        for pools in cs:
            for pool in pools.values():
                blocks = pool if stacked else pool[None]     # (R, n_blocks, ...)
                if owned is None:
                    blocks[:, dst] = blocks[:, idx]
                    continue
                first, n = owned
                mine = (idx >= first) & (idx < first + n)
                vals = blocks[:, torch.where(mine, idx - first, 0)]
                mask = mine.reshape((1, -1) + (1,) * (vals.dim() - 2))
                vals = shard.all_reduce(torch.where(mask, vals, 0), "data")
                bs = blocks.shape[2]
                offs = torch.arange(bs, device=dev)[None].expand(len(dst), bs)
                A.put_blocks(blocks, dst[:, None].expand(-1, bs), offs, vals, shard,
                             stacked=True)
    return caches


def copy_paged_block(caches: dict, src, dst, shard=None) -> dict:
    """Single-pair :func:`copy_paged_blocks`."""
    return copy_paged_blocks(caches, [int(src)], [int(dst)], shard)


def insert_cache_slot(cfg: ModelConfig, caches: dict, one: dict, slot: int,
                      shard=None) -> dict:
    """Write a batch-1 cache tree ``one`` into batch row ``slot`` of a live
    cache, in place (both built for the same ``max_seq``): batch is axis 1
    of a stacked unit leaf, axis 0 of a prologue or epilogue leaf, for K/V
    rows and recurrent states alike (a recurrent row is replaced whole, so
    a recycled slot keeps nothing of its last occupant).  On a mesh
    (``shard.for_rows(batch)`` of the live cache) only the rank holding row
    ``slot`` writes it."""
    rows = None if shard is None else shard.row_range()
    if rows is not None:
        if not rows[0] <= slot < rows[0] + rows[1]:
            return caches
        slot -= rows[0]
    for part, cs, stacked in _cache_parts(caches):
        for big, small in zip(cs, one[part]):
            for name, buf in big.items():
                buf.select(int(stacked), slot).copy_(small[name].select(int(stacked), 0))
    return caches


@torch.no_grad()
def prefill_into_slot(
    params: dict, cfg: ModelConfig, tokens: torch.Tensor, length: int, slot: int,
    caches: dict, max_seq: int, compute_dtype=torch.float32, shard=None,
) -> tuple[torch.Tensor, dict]:
    """Prefill ONE right-padded request ``tokens (1, T_pad)`` and splice
    its KV into row ``slot``; returns ``(last_logits (vocab,), caches)`` at
    its last real token.  The k=1 case of :func:`prefill_into_slots`."""
    last, caches = prefill_into_slots(
        params, cfg, tokens, torch.full((1,), length, device=tokens.device), [slot],
        caches, max_seq, compute_dtype, shard)
    return last[0], caches


@torch.no_grad()
def prefill_into_slots(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,             # (k, T_pad) int, right-padded prompts
    lengths: torch.Tensor,            # (k,) true prompt lengths
    slots,                            # k target batch rows (host ints)
    caches: dict,                     # live (n_repeats, slots, max_seq, ...) caches
    max_seq: int,
    compute_dtype=torch.float32,
    shard=None,                       # the live cache's: shard.for_rows(slots)
) -> tuple[torch.Tensor, dict]:
    """Prefill ``k`` queued requests in ONE pass and splice each row's KV
    into its slot of the live cache (continuous batching's admission).
    Returns ``(last_logits (k, vocab), caches)``, each row's logits at its
    own last real token.  On a mesh every rank prefills all ``k`` rows (its
    KV heads) and keeps the rows whose slots it holds."""
    k = tokens.shape[0]
    many = _make_caches(cfg, lambda blk: B.block_init_cache(blk, k, max_seq, compute_dtype,
                                                           tokens.device, shard))
    logits = _fill(params, cfg, _embed_tokens(params, cfg, tokens, compute_dtype, shard),
                   many, shard)
    last = _whole_logits(cfg, logits[torch.arange(k, device=tokens.device),
                                     lengths.long() - 1], shard)
    for i, slot in enumerate(slots):
        one = {part: [{n: a.narrow(int(stacked), i, 1) for n, a in c.items()} for c in cs]
               for part, cs, stacked in _cache_parts(many)}
        insert_cache_slot(cfg, caches, one, int(slot), shard)
    return last, caches


@torch.no_grad()
def prefill_into_pages(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,             # (k, Ts_pad) int, right-padded SUFFIX tokens
    lengths: torch.Tensor,            # (k,) true TOTAL prompt lengths
    tables: torch.Tensor,             # (k, n_logical) int32 block tables
    caches: dict,                     # paged pools (init_paged_caches), in place
    start: int,                       # first uncached position
    compute_dtype=torch.float32,
    view_blocks: int | None = None,   # attention-view table columns (covers
                                      # start + Ts_pad); None: all
    shard=None,                       # the pool's: shard.for_pool(n_blocks)
) -> tuple[torch.Tensor, dict]:
    """Paged admission prefill: compute ONLY the uncached suffix (positions
    ``start .. len-1``; a prefix-cache hit makes ``start > 0``) and scatter
    its K/V into the pool blocks ``tables`` maps.  Returns ``(last_logits
    (k, vocab), caches)`` at each request's last real token (suffix row
    ``lengths - 1 - start``).  On a mesh every rank prefills all ``k``
    rows."""
    k, Ts = tokens.shape
    dev = tokens.device
    h = _embed_tokens(params, cfg, tokens, compute_dtype, shard)
    positions = torch.arange(start, start + Ts, device=dev)[None, :]
    for p, blk, c in _walk(params, cfg, caches):
        h, _ = B.block_prefill_paged(
            p, blk, h, positions=positions, cache=c, table=tables, lengths=lengths,
            start=start, chunk=cfg.attn_chunk, view_blocks=view_blocks, shard=shard)
    logits = _logits(params, cfg, h, shard)
    last = logits[torch.arange(k, device=dev), lengths.long() - 1 - start]
    return _whole_logits(cfg, last, shard), caches


def _logits(params: dict, cfg: ModelConfig, h: torch.Tensor, shard=None) -> torch.Tensor:
    """Logits of the final hidden state; on a mesh whose model axis splits
    the vocabulary, this rank's slice (:func:`_whole_logits` gathers)."""
    h = L.rmsnorm(params["final_ln"], h, shard=shard)
    logits = L.unembed_logits(params["embed"], h, shard, (cfg.vocab, cfg.d_model))
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _whole_logits(cfg: ModelConfig, logits: torch.Tensor, shard,
                  rows: tuple[int, int] | None = None) -> torch.Tensor:
    """This rank's logits -> every row's whole vocabulary on every rank:
    ``rows`` the row block this rank computed (None: all of them), the
    vocabulary split as :func:`_logits` left it."""
    if shard is None:
        return logits
    spec = [None] * logits.dim()
    shape = list(logits.shape)
    if rows is not None:
        spec[0] = "data"
        shape[0] *= shard.size("data")
    if shard.model_split(L.TABLE_AXES, (cfg.vocab, cfg.d_model)) == "vocab":
        spec[-1] = "model"
        shape[-1] = cfg.vocab
    return shard.gather(logits, tuple(spec), tuple(shape))


def _fill(params: dict, cfg: ModelConfig, h: torch.Tensor, caches: dict,
          shard=None) -> torch.Tensor:
    """The prefill walk: every block on ``h (B, T, d)``, filling ``caches``
    in place -> this rank's logits (:func:`_logits`)."""
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for p, blk, c in _walk(params, cfg, caches):
        h, _ = B.block_prefill(p, blk, h, positions=positions, cache=c, chunk=cfg.attn_chunk,
                               shard=shard)
    return _logits(params, cfg, h, shard)


@torch.no_grad()
def prefill(
    params: dict,
    cfg: ModelConfig,
    inputs,                           # (B, T) int tokens, or an inputs dict
    max_seq: int,
    compute_dtype=torch.float32,
    shard=None,
) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that fills fresh decode caches.

    Returns ``(logits (B, T, vocab) fp32, caches)``; each cache row holds the
    prompt's K/V at slots ``0..T-1`` and zeros beyond, or a ring's latest
    ``window`` positions (``blocks.block_prefill``).  ``T`` counts every
    input position (a ``mixed`` model's prefix too).  On a mesh (token
    inputs) each rank computes and caches the rows of
    ``shard.for_rows(B).row_range()`` and the logits are whole on every
    rank."""
    check_supported(cfg)
    if shard is None:
        h = _embed_inputs(params, cfg, inputs, compute_dtype)
        caches = init_caches(cfg, h.shape[0], max_seq, compute_dtype, h.device)
        return _fill(params, cfg, h, caches), caches
    tokens = inputs["tokens"] if isinstance(inputs, dict) else inputs
    caches = init_caches(cfg, tokens.shape[0], max_seq, compute_dtype, tokens.device, shard)
    rows = shard.for_rows(tokens.shape[0]).row_range()
    if rows is not None:
        tokens = tokens.narrow(0, *rows)
        shard = shard.split_rows()
    logits = _fill(params, cfg, _embed_tokens(params, cfg, tokens, compute_dtype, shard),
                   caches, shard)
    return _whole_logits(cfg, logits, shard, rows), caches


@torch.no_grad()
def decode_step(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,             # (B, 1) int, or (B, 1, d) / (B, d) embeddings
    caches: dict,                     # updated in place
    pos: torch.Tensor,                # scalar or (B,) int
    compute_dtype=torch.float32,
    table: torch.Tensor | None = None,  # (B, n_logical) int32: paged block tables
    shard=None,                       # shard.for_rows(B) (dense) or .for_pool(n) (paged)
) -> tuple[torch.Tensor, dict]:
    """One decode step for the whole model -> ``(logits (B, vocab), caches)``.

    ``tokens`` are ``(B, 1)`` ids for ``tokens`` and ``mixed`` models (the
    prefix is prompt only) and embedding rows for ``embeddings`` models.
    With ``table``, ``caches`` holds paged pools (:func:`init_paged_caches`)
    and every layer reads and writes through the block table.  On a mesh
    the inputs hold every row; a rank decodes the rows its dense caches
    hold (``shard.row_range()``) or, paged, every row, and the logits are
    whole on every rank."""
    rows = None if shard is None else shard.row_range()
    if rows is not None:
        tokens = tokens.narrow(0, *rows)
        pos = pos if pos.dim() == 0 else pos.narrow(0, *rows)
        shard = shard.split_rows()
    if cfg.input_kind == "embeddings":
        h = tokens.to(compute_dtype)
        if h.dim() == 2:                   # (B, d) rows
            h = h[:, None]
    else:
        h = _embed_tokens(params, cfg, tokens, compute_dtype, shard)
    for p, blk, c in _walk(params, cfg, caches):
        h, _ = B.block_decode_step(p, blk, h, c, pos, table, shard)
    return _whole_logits(cfg, _logits(params, cfg, h, shard)[:, 0], shard, rows), caches


# kanlint's KL105: a mesh serves no speculative window (ROADMAP queue 1,
# item 9.4), so no ShardingCtx reaches these cache writes.
@torch.no_grad()
def verify_window(  # kanlint: ignore[KL105]
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,             # (B, W) int: last accepted token + k drafts
    caches: dict,                     # updated in place
    pos: torch.Tensor,                # (B,) window start positions
    compute_dtype=torch.float32,
    table: torch.Tensor | None = None,  # (B, n_logical) int32: paged block tables
) -> tuple[torch.Tensor, dict]:
    """Speculative verification: score all ``W = k + 1`` window positions of
    every row in ONE pass -> ``(logits (B, W, vocab), caches)``.

    ``logits[:, j]`` is the next-token distribution after the token at
    position ``pos + j``, what :func:`decode_step` gives at step ``j`` of a
    sequential chunk whose earlier tokens were the window's.  The model
    writes all W positions; the engine's rollback-free invariants keep
    rejected writes unobservable (DESIGN.md §9)."""
    if not model_supports_speculative(cfg):
        raise NotImplementedError(
            f"{cfg.name}: speculative verify needs token-input full-attention "
            "GQA blocks throughout")
    check_supported(cfg)
    h = _embed_tokens(params, cfg, tokens, compute_dtype)
    for p, blk, c in _walk(params, cfg, caches):
        h, _ = B.block_verify_window(p, blk, h, c, pos, table)
    return _logits(params, cfg, h), caches
