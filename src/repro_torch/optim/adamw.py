"""AdamW, its learning-rate schedules and global-norm clipping, written out
by hand (counterpart of ``repro/optim/adamw.py``).

The state is a tree congruent with the parameters (``m``, ``v``, fp32) plus
an int32 ``step`` and, with ``master_weights``, an fp32 ``master`` copy of
the parameters.  The arithmetic is the reference's, in its order: the
gradient scaled by ``min(1, clip / max(|g|, 1e-9))``, both moments,
bias correction, weight decay inside ``delta``, and the fp32 update cast
back to the parameter's dtype.  ``torch.optim.AdamW`` orders it otherwise
and keeps no master copy of this shape.

:func:`apply_updates` updates the parameters and the state IN PLACE (the
reference's launcher donates both to its jitted step) and returns the same
trees.  It walks each leaf in pieces of :data:`CHUNK` elements, so its
temporaries stay within about 0.5 GB whatever the leaf's size
(musicgen-large has 3.2 GB leaves).

On a ``(data, model)`` mesh (``shard``, a ``ShardingCtx.for_model``) the
parameters and gradients are this rank's model-local leaves, the gradients
already summed over ``data``, and ``m``, ``v`` and ``master`` are ZeRO
slices: each data rank keeps the block of a leaf that ``zero_spec`` gives
it (``ShardingCtx.leaf_plan``), updates it with the same block of the
gradient, and the updated blocks are gathered over ``data`` into the
model-local parameter.  The global norm counts every logical element once:
the sums of squares of model-split leaves are summed over ``model``.  The
elementwise arithmetic is the unsharded one, so for the same gradients the
update is bit-equal to it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.convert import flatten_with_paths, map_with_paths

CHUNK = 1 << 24                       # elements per piece of a leaf's update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"    # "cosine" | "linear" | "constant"
    # keep an fp32 master copy of (e.g. bf16) parameters in the state
    master_weights: bool = False


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step``: a linear warmup over ``warmup_steps``
    times a cosine, linear or constant decay to ``min_lr_frac`` at
    ``total_steps``, in float32 as the reference computes it."""
    f32 = np.float32
    s = f32(step)
    warm = min(f32(1.0), (s + f32(1.0)) / f32(max(1, cfg.warmup_steps)))
    if cfg.schedule == "constant":
        decay = f32(1.0)
    else:
        t = (s - f32(cfg.warmup_steps)) / f32(max(1, cfg.total_steps - cfg.warmup_steps))
        t = min(max(t, f32(0.0)), f32(1.0))
        lo = f32(cfg.min_lr_frac)
        if cfg.schedule == "cosine":
            decay = lo + f32((1 - cfg.min_lr_frac) * 0.5) * (
                f32(1.0) + np.cos(f32(math.pi) * t, dtype=np.float32))
        elif cfg.schedule == "linear":
            decay = lo + f32(1 - cfg.min_lr_frac) * (f32(1.0) - t)
        else:
            raise ValueError(f"unknown schedule {cfg.schedule!r}")
    return float(f32(cfg.lr) * warm * decay)


def _zero_dims(tree, shard) -> dict:
    """``{path: ZeRO dimension or None}`` of a parameter-shaped tree."""
    plan = None if shard is None else shard.leaf_plan
    return {k: None if plan is None else plan[k][1] for k in flatten_with_paths(tree)}


def init_state(params, master_weights: bool = False, shard=None) -> dict:
    """Zero moments (fp32, on each parameter's device), ``step`` 0 (int32),
    and with ``master_weights`` an fp32 copy of the parameters; on a mesh
    each of them this rank's ZeRO slice of its model-local leaf."""
    dims = _zero_dims(params, shard)

    def mine(key, p):
        return p if dims[key] is None else shard.zero_slice(p, dims[key])

    zeros = lambda: map_with_paths(lambda k, p: torch.zeros(
        mine(k, p).shape, dtype=torch.float32, device=p.device), params)
    first = next(iter(flatten_with_paths(params).values()))
    state = {"m": zeros(), "v": zeros(),
             "step": torch.zeros((), dtype=torch.int32, device=first.device)}
    if master_weights:
        state["master"] = map_with_paths(
            lambda k, p: mine(k, p).detach().to(torch.float32, copy=True).contiguous(), params)
    return state


def _sum_sq(g: torch.Tensor) -> torch.Tensor:
    """The sum of a leaf's fp32 squares, accumulated in fp64 piece by piece."""
    return sum(torch.sum(p.float() ** 2, dtype=torch.float64) for p in _pieces(g, view=False))


def global_norm(tree, shard=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, an fp32 value: the fp32
    squares are summed in fp64 and rounded to fp32 once (the reference sums
    in fp32), so that neither the order of the sums nor a mesh's split of
    a leaf moves the norm by an fp32 ulp; on a mesh the sums of the leaves
    ``model`` splits are summed over ``model``."""
    flat = flatten_with_paths(tree)
    sq = torch.stack([_sum_sq(g) for g in flat.values()])
    split = [] if shard is None else [shard.leaf_plan[k][0] for k in flat]
    if any(split):
        mask = torch.tensor(split, device=sq.device)
        sq = torch.where(mask, shard.all_reduce(torch.where(mask, sq, 0), "model"), sq)
    return torch.sqrt(sq.sum().float())


def _pieces(t: torch.Tensor, view: bool = True):
    """``CHUNK``-element pieces of ``t`` flattened: views (written in place)
    of a parameter or a moment, which must be contiguous; a gradient may
    be copied."""
    return (t.view(-1) if view else t.reshape(-1)).split(CHUNK)


def apply_updates(params, grads, state: dict, cfg: AdamWConfig,
                  shard=None) -> tuple[dict, dict, dict]:
    """One AdamW step -> ``(params, state, {"grad_norm", "lr"})``, the
    parameters and the state updated in place (see the module docstring;
    ``shard`` for a mesh's ZeRO slices)."""
    step = int(state["step"]) + 1
    gnorm = global_norm(grads, shard)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    f32 = np.float32
    b1c = float(f32(1) - f32(cfg.b1) ** f32(step))
    b2c = float(f32(1) - f32(cfg.b2) ** f32(step))
    b1, b2 = float(f32(cfg.b1)), float(f32(cfg.b2))
    one_b1, one_b2 = float(f32(1 - cfg.b1)), float(f32(1 - cfg.b2))
    wd, eps = float(f32(cfg.weight_decay)), float(f32(cfg.eps))

    flat_p = flatten_with_paths(params)
    flat_ref = flatten_with_paths(state["master"]) if cfg.master_weights else flat_p
    flat_g, flat_m, flat_v = (flatten_with_paths(t) for t in (grads, state["m"], state["v"]))
    dims = _zero_dims(params, shard)
    gathered = []                          # (parameter, its updated ZeRO block, dim)
    with torch.no_grad():
        for key, p in flat_p.items():
            ref, grad, dim = flat_ref[key], flat_g[key], dims[key]
            if dim is not None:
                grad = shard.zero_slice(grad, dim)
                if not cfg.master_weights:
                    ref = shard.zero_slice(p, dim).contiguous()
            for r, g, m, v in zip(_pieces(ref), _pieces(grad, view=False),
                                  _pieces(flat_m[key]), _pieces(flat_v[key])):
                g = g.float() * scale
                m.mul_(b1).add_(one_b1 * g)
                v.mul_(b2).add_(one_b2 * g * g)
                p32 = r.float()
                delta = (m / b1c) / (torch.sqrt(v / b2c) + eps) + wd * p32
                r.copy_(p32 - lr * delta)
            if dim is not None:
                gathered.append((p, ref, dim))
            elif cfg.master_weights:
                p.copy_(ref)
        if gathered:
            wholes = shard.zero_gather([(r, dim, tuple(p.shape)) for p, r, dim in gathered])
            for (p, _, _), w in zip(gathered, wholes):
                p.copy_(w)
    state["step"] = torch.full((), step, dtype=torch.int32, device=state["step"].device)
    return params, state, {"grad_norm": gnorm, "lr": lr}
