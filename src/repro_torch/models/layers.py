"""Basic NN layers in PyTorch (counterpart of ``repro/models/layers.py``).

Parameters are plain nested dicts of tensors with the JAX package's layout,
so a JAX parameter tree converts leaf for leaf (``repro_torch.convert``).

On a mesh (``shard``, a ``dist.sharding.ShardingCtx``) each rank holds its
local shard of a leaf: the embedding is vocab-parallel (each rank looks up
the ids in its vocabulary slice, zeros for the others, one ``all_reduce``
over ``model``: exact, since the sum adds only zeros), the unembedding
gives this rank's vocabulary slice of the logits (the caller gathers what
it keeps), and a norm's ``scale``, sharded on ``embed``, is gathered at use.
Under autograd the same calls differentiate: the sums pass the gradient
through, the vocabulary slice's input sums it over ``model``, and a
gathered leaf takes its block of the gradient (``ShardingCtx``).

The norm and the logits are computed in fp32, or in fp64 at fp64 compute
(the reference always takes fp32; no fp32 or bf16 result changes), so that
an fp64 run carries no fp32 sum whose order depends on the mesh.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Axes:
    """Logical axis names of one parameter or cache leaf (``dist/sharding.py``
    turns them into partition specs)."""

    names: tuple[str | None, ...]


TABLE_AXES = ("vocab", "embed")


def _wide(dtype) -> torch.dtype:
    """fp32, or the compute dtype where it is wider."""
    return torch.promote_types(dtype, torch.float32)


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6, shard=None) -> torch.Tensor:
    scale = params["scale"]
    if shard is not None:
        scale = shard.gather_whole(scale, ("embed",), (x.shape[-1],))
    xf = x.to(_wide(x.dtype))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(xf.dtype)
    return out.to(x.dtype)


def _vocab_slice(table: torch.Tensor, shape: tuple[int, int], shard) -> int | None:
    """The first token id of this rank's vocabulary slice when the model
    axis splits the table's vocabulary, else None."""
    if shard is None or shard.model_split(TABLE_AXES, shape) != "vocab":
        return None
    return shard.coord("model") * table.shape[0]


def embed_lookup(params: dict, ids: torch.Tensor, compute_dtype, shard=None,
                 shape: tuple[int, int] | None = None) -> torch.Tensor:
    """Rows of the table; on a mesh ``shape`` is the whole table's
    ``(vocab, d)``."""
    table = params["table"]
    v0 = _vocab_slice(table, shape, shard)
    if v0 is None:
        if shard is not None:
            table = shard.gather_whole(table, TABLE_AXES, shape)
        return table.to(compute_dtype)[ids.long()]
    local = ids.long() - v0
    mine = (local >= 0) & (local < table.shape[0])
    rows = table.to(compute_dtype)[local.clamp(0, table.shape[0] - 1)]
    return shard.reduce_from(torch.where(mine[..., None], rows, 0), "model")


def unembed_logits(params: dict, h: torch.Tensor, shard=None,
                   shape: tuple[int, int] | None = None) -> torch.Tensor:
    """Tied unembedding: logits in fp32 (fp64 at fp64 compute); on a mesh
    whose model axis splits the vocabulary, this rank's slice of them
    (``shape`` as in :func:`embed_lookup`)."""
    table = params["table"]
    if shard is not None:
        if _vocab_slice(table, shape, shard) is None:
            table = shard.gather_whole(table, TABLE_AXES, shape)
        else:
            h = shard.copy_to_model(h)
    dt = _wide(h.dtype)
    return torch.einsum("...d,vd->...v", h.to(dt), table.to(dt))


def rotary_embedding(
    positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
    dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(positions...) -> cos/sin of shape positions.shape + (head_dim//2,),
    computed in fp32 and then cast."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    freqs = torch.pow(base, exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., T, H, D); cos/sin: (..., T, D/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
