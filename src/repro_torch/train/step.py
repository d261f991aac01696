"""The LM training step (counterpart of ``repro/train/step.py``).

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``.  The loss is ``lm.lm_loss`` (the KAN FFN on its
``dense`` path, as the reference trains it: no kernel launches), its
gradient comes from ``torch.autograd`` with respect to detached copies of
the leaves (the parameters themselves never require grad, so serving the
trained tree records nothing), and ``optim/adamw.py`` applies it in place.
With ``accum_steps > 1`` the batch splits along axis 0 into that many
microbatches in order; their fp32 gradients are summed and divided by
``accum_steps``, and the metrics are the mean loss alone, as the
reference's ``lax.scan`` gives.  ``grad_compression`` (``"bf16"`` or
``"int8"``) round-trips the gradient through a wire format first.

On a ``(data, model)`` mesh (``shard``, a ``dist.sharding.ShardingCtx``;
the parameters and the state this rank's shards, the state's ZeRO slices
from ``adamw.init_state(..., shard=shard.for_model(model_cfg))``) the step
is handed the whole global batch and each data rank takes its rows:
microbatch ``i`` is the global rows ``[i B/A, (i+1) B/A)``, split over the
data ranks and normalised by that global microbatch's label tokens, as the
reference's scan over the sharded global batch.  Each microbatch's
gradients are summed over ``data`` after its backward, in the compute
dtype, before the fp32 accumulation (as GSPMD reduces the reference's);
then compressed, then applied.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.convert import flatten_with_paths, tree_map, unflatten_paths
from repro_torch.dist import compression
from repro_torch.models import lm
from repro_torch.optim import adamw


def value_and_grads(fn, params):
    """``fn(params) -> (value, aux)`` and the gradient of ``value`` with
    respect to detached copies of every leaf of ``params`` -> ``(value,
    aux, grads)``, every tensor detached; a leaf ``fn`` does not read (zamba2's
    unread stacked copy of its shared block) gets a zero gradient, as
    ``jax.grad`` gives."""
    flat = {k: v.detach().requires_grad_(True) for k, v in flatten_with_paths(params).items()}
    with torch.enable_grad():
        value, aux = fn(unflatten_paths(flat))
        grads = torch.autograd.grad(value, list(flat.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(flat.items(), grads)}
    return value.detach(), tree_map(torch.Tensor.detach, aux), unflatten_paths(grads)


def loss_and_grads(params, model_cfg, batch: dict, compute_dtype=torch.float32, shard=None):
    """``lm.lm_loss`` and its gradient -> ``(total, metrics, grads)``
    (:func:`value_and_grads`); on a mesh this rank's share of the gradient
    (the caller sums it over ``data``)."""
    return value_and_grads(
        lambda p: lm.lm_loss(p, model_cfg, batch, compute_dtype, shard=shard), params)


def data_rows(shard, batch: dict, first: int, rows: int) -> dict:
    """This data rank's block of the global rows ``[first, first + rows)``
    (the rows themselves without a mesh)."""
    if shard is not None and shard.size("data") > 1:
        d = shard.size("data")
        if rows % d:
            raise ValueError(f"a microbatch of {rows} rows does not split over {d} data ranks")
        rows //= d
        first += shard.coord("data") * rows
    return {k: v[first:first + rows] for k, v in batch.items()}


def make_train_step(
    model_cfg,
    opt_cfg: adamw.AdamWConfig,
    *,
    compute_dtype=torch.float32,
    accum_steps: int = 1,
    grad_compression: str | None = None,   # None | "bf16" | "int8"
    shard=None,
) -> Callable:
    if shard is not None:
        lm.check_mesh(model_cfg, shard)
        shard = shard.for_model(model_cfg)

    def grads_of(params, mb):
        loss, metrics, grads = loss_and_grads(params, model_cfg, mb, compute_dtype, shard)
        if shard is not None:
            shard.sum_over(list(flatten_with_paths(grads).values()), "data")
        return loss, metrics, grads

    def train_step(params, opt_state, batch):
        rows = next(iter(batch.values())).shape[0] // accum_steps
        if accum_steps == 1:
            mb = batch if shard is None else data_rows(shard, batch, 0, rows)
            _, metrics, grads = grads_of(params, mb)
        else:
            grads, loss = None, 0.0
            for i in range(accum_steps):
                l, _, g = grads_of(params, data_rows(shard, batch, i * rows, rows))
                g = tree_map(lambda a: a.to(torch.float32), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda a: a / accum_steps, grads)
            metrics = {"loss": loss / accum_steps}
        if grad_compression:
            grads = compression.compress_tree(grads, grad_compression, shard)
        params, opt_state, opt_metrics = adamw.apply_updates(params, grads, opt_state, opt_cfg,
                                                             shard)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step
