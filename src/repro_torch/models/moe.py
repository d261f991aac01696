"""Mixture-of-Experts FFN in PyTorch (counterpart of ``repro/models/moe.py``;
olmoe-1b-7b, deepseek-v2-lite).

Token-choice top-k routing with a capacity factor, as the reference routes:

* the router runs in fp32; ``top_k`` of the softmax keeps the reference's
  order (``jax.lax.top_k``: descending, the lower expert index first on a
  tie), here a stable descending sort;
* ``cap = int(max(top_k, capacity_factor * S * top_k / E))`` with ``S`` the
  number of rows routed together (``B·T``: pad rows, dead slots and the
  tokens of a verify window included), so whether a token is dropped
  depends on its companions, as in the reference;
* a token's place in its expert's queue is the exclusive cumsum over the
  flattened ``(S·k, E)`` one-hot; choices at or past ``cap`` are dropped.

Two dispatches, both the reference's: ``"scatter"`` (the default) adds each
kept choice into its own row of an ``(E·cap + 1, d)`` buffer (one overflow
row takes the drops and is cut off) and gathers the experts' outputs back
from ``clip(slot)`` weighted by ``top_p·keep``; ``"einsum"`` is the one-hot
dispatch/combine baseline.  The experts are plain batched products
(``torch.bmm``): every expert runs over its ``cap`` rows, kept or empty, as
the reference's ``(E, cap, d)`` einsums do.  Shared experts (DeepSeek) are a
SwiGLU of width ``d_ff·n_shared`` added after the routed sum.

``moe_forward`` returns ``(y, aux)`` with the reference's fp32 auxiliaries
``moe_lb_loss`` (Switch load balance), ``moe_z_loss`` (router z-loss) and
``moe_drop_frac``.

On a ``(data, model)`` mesh (``shard``, ``dist/sharding.py``) the
computation keeps the meaning of the reference's GSPMD program:

* routing is replicated over ``model``: the router is gathered whole and
  every model rank computes the same logits, softmax and top-k;
* routing is global over ``data``: where the rows are this rank's block of a
  split batch (``ShardingCtx.split_rows``), ``cap`` counts the global rows
  and a queue position adds the lower data ranks' counts
  (``ShardingCtx.counts_below``), so ``keep`` is the whole batch's; where
  ``cap`` reaches the global row count nothing can drop, and the positions
  stay local (a slot needs only be unique in this rank's buffer);
* with ``experts`` on ``model`` (expert parallelism) each rank dispatches
  the kept choices of its own experts only and combines with
  ``top_p·keep·local``; with ``ffn`` on ``model`` every expert is column-
  and row-parallel; both give partial sums, which the shared experts'
  (column- and row-parallel) partial joins before one ``reduce_from`` over
  ``model``; with neither, every leaf is gathered whole and the unmeshed
  code runs;
* the auxiliaries are the global batch's, bit-equal to the unmeshed ones
  on every rank: the rows' values are gathered whole over ``data`` and
  reduced as the unmeshed code reduces them (a sum of per-rank sums would
  move the fp32 auxiliaries by roundings).

Training differentiates through it (Megatron's pattern): ``xf`` and
``top_p`` enter the rank-local experts through ``copy_to_model``, so the
router's gradient is whole on every model rank before the gather's backward
takes this rank's block; the replicated stream (logits, softmax, the
auxiliaries) does not pass through it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                   # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0           # DeepSeek shared experts (always on)
    capacity_factor: float = 1.25
    gated: bool = True          # SwiGLU experts
    dispatch: str = "scatter"   # "scatter" | "einsum"


def _expert_ffn(p: dict, xe: torch.Tensor, gated: bool) -> torch.Tensor:
    """``xe (E, C, d) -> (E, C, d)`` through each expert's (Sw)iGLU FFN."""
    h = torch.bmm(xe, p["wi"].to(xe.dtype))
    if gated:
        h = F.silu(torch.bmm(xe, p["wg"].to(xe.dtype))) * h
    else:
        h = F.gelu(h, approximate="tanh")       # jax.nn.gelu's default
    return torch.bmm(h, p["wo"].to(xe.dtype))


# logical axes of each leaf of moe_init's tree (lm._block_shapes)
ROUTER_AXES = ("embed", "experts")
EXPERT_AXES = {"wi": ("experts", "embed", "ffn"), "wg": ("experts", "embed", "ffn"),
               "wo": ("experts", "ffn", "embed")}
SHARED_AXES = {"shared_wi": ("embed", "ffn"), "shared_wg": ("embed", "ffn"),
               "shared_wo": ("ffn", "embed")}


def _whole_shape(cfg: MoEConfig, name: str) -> tuple[int, ...]:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    fs = f * cfg.n_shared
    return {"router": (d, E), "wi": (E, d, f), "wg": (E, d, f), "wo": (E, f, d),
            "shared_wi": (d, fs), "shared_wg": (d, fs), "shared_wo": (fs, d)}[name]


def _local(params: dict, cfg: MoEConfig, names: dict, shard, split_on: tuple):
    """The leaves ``names`` as this rank computes with them -> ``(weights,
    partial)``: local where the model axis splits them on one of
    ``split_on`` (the output is then a partial sum over ``model``), else
    gathered whole."""
    if shard is None:
        return {n: params[n] for n in names if n in params}, False
    first = next(iter(names))
    if shard.model_split(names[first], _whole_shape(cfg, first)) in split_on:
        return {n: params[n] for n in names if n in params}, True
    return {n: shard.gather_whole(params[n], names[n], _whole_shape(cfg, n))
            for n in names if n in params}, False


class _RouterLogits(torch.autograd.Function):
    """``xf.float() @ router.float()``, whose router gradient sums the rows'
    fp32 products in fp64 and rounds once to the router's dtype (as
    ``adamw.global_norm`` sums its squares): so a split of the rows over
    ``data`` moves it by no fp32 rounding, and an fp64 step stays within
    fp64 roundings of the unmeshed one."""

    @staticmethod
    def forward(ctx, xf, router):
        ctx.save_for_backward(xf, router)
        return xf.float() @ router.float()

    @staticmethod
    def backward(ctx, g):
        xf, router = ctx.saved_tensors
        gx = (g @ router.float().T).to(xf.dtype)
        wide = torch.float64  # kanlint: ignore[KL103] (the router gradient's row sum)
        gw = (xf.float().to(wide).T @ g.to(wide)).to(router.dtype)
        return gx, gw


def route(params: dict, cfg: MoEConfig, xf: torch.Tensor, shard=None):
    """The routing decisions of ``xf (S, d)``: ``(logits (S, E) fp32, probs,
    top_p (S, k) renormalised, top_e (S, k), pos (S, k) queue positions,
    keep (S, k), cap)``.  On a mesh (see the module docstring) every model
    rank computes the same decisions, and under ``shard.split_rows()`` they
    are the global batch's: ``cap`` of the global rows, ``pos`` over them
    (over this rank's rows where ``cap`` reaches the global row count)."""
    S = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    router = params["router"]
    if shard is not None:
        router = shard.gather_whole(router, ROUTER_AXES, _whole_shape(cfg, "router"))
    if torch.is_grad_enabled() and (xf.requires_grad or router.requires_grad):
        logits = _RouterLogits.apply(xf, router)
    else:
        logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = srt[:, :k], idx[:, :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    S_all = S if shard is None else shard.global_rows(S)
    cap = int(max(k, cfg.capacity_factor * S_all * k / E))
    onehot = F.one_hot(top_e, E)                                # (S, k, E) int64
    flat = onehot.reshape(S * k, E)
    pos_in_e = (torch.cumsum(flat, dim=0) - flat).reshape(S, k, E)
    pos = (pos_in_e * onehot).sum(-1)                           # (S, k)
    if S_all > S and cap < S_all:        # the lower data ranks' rows queue first
        pos = pos + shard.counts_below(flat.sum(0))[top_e]
    return logits, probs, top_p, top_e, pos, pos < cap, cap


def _aux(cfg: MoEConfig, logits, probs, top_e, keep, shard) -> dict:
    """The fp32 auxiliaries of the routed rows; under ``shard.split_rows()``
    the global batch's, bit-equal to the unmeshed ones on every rank: each
    rank's per-row values (probabilities, log-sum-exp, top-1 expert, kept
    choices) are gathered whole over ``data`` (one exact ``all_reduce``;
    its backward leaves each rank its rows' share) and reduced as the
    unmeshed code reduces them."""
    E = cfg.n_experts
    lse, top1 = torch.logsumexp(logits, dim=-1), top_e[:, 0]
    S = probs.shape[0]
    if shard is not None and shard.global_rows(S) > S:
        cols = torch.cat([probs, lse[:, None], top1[:, None].float(), keep.float()], dim=1)
        cols = shard.gather_whole(cols, ("batch", None), (shard.global_rows(S), cols.shape[1]))
        probs, lse, top1, keep = (t.contiguous() for t in cols.split([E, 1, 1, cfg.top_k], 1))
        lse, top1 = lse[:, 0], top1[:, 0].long()
    me = probs.mean(0)
    ce = F.one_hot(top1, E).float().mean(0)
    return {"moe_lb_loss": E * torch.sum(me * ce),
            "moe_z_loss": torch.mean(lse ** 2),
            "moe_drop_frac": 1.0 - keep.float().mean()}


def moe_forward(params: dict, cfg: MoEConfig, x: torch.Tensor, shard=None
                ) -> tuple[torch.Tensor, dict]:
    """``x (B, T, d) -> (y (B, T, d), aux)`` (on a mesh, see the module
    docstring)."""
    B, T, d = x.shape
    S = B * T
    E, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(S, d)
    logits, probs, top_p, top_e, pos, keep, cap = route(params, cfg, xf, shard)
    experts, partial = _local(params, cfg, EXPERT_AXES, shard, ("experts", "ffn"))
    owned = None if shard is None else shard.model_range(("experts",), (E,))
    xe_in, w_top = xf, top_p.to(xf.dtype)
    if partial:                          # rank-local experts: gradients sum over model
        xe_in, w_top = shard.copy_to_model(xf), shard.copy_to_model(w_top)
    E_l, e_loc, mine = E, top_e, keep
    if owned is not None:                # expert parallelism: this rank's experts only
        first, E_l = owned
        e_loc = top_e - first
        mine = keep & (e_loc >= 0) & (e_loc < E_l)
    if cfg.dispatch == "scatter":
        slot = torch.where(mine, e_loc * cap + pos, E_l * cap)  # a drop -> the overflow row
        xe = xf.new_zeros((E_l * cap + 1, d)).index_add_(
            0, slot.reshape(-1), xe_in.repeat_interleave(k, dim=0))
        ye = _expert_ffn(experts, xe[:-1].reshape(E_l, cap, d), cfg.gated)
        gathered = ye.reshape(E_l * cap, d)[torch.clamp(slot, 0, E_l * cap - 1).reshape(-1)]
        w = (w_top * mine.to(xf.dtype))[..., None]
        y = (gathered.reshape(S, k, d) * w).sum(dim=1)
    elif cfg.dispatch == "einsum":
        disp = (F.one_hot(torch.clamp(e_loc, 0, E_l - 1), E_l).to(xf.dtype)[..., None]
                * F.one_hot(torch.clamp_max(pos, cap - 1), cap).to(xf.dtype)[..., None, :]
                * mine.to(xf.dtype)[..., None, None])           # (S, k, E_l, cap)
        xe = torch.einsum("sec,sd->ecd", disp.sum(1), xe_in)
        ye = _expert_ffn(experts, xe, cfg.gated)
        comb = (disp * w_top[..., None, None]).sum(1)
        y = torch.einsum("sec,ecd->sd", comb, ye)
    else:
        raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r}")
    y_sh, sh_partial = None, False
    if cfg.n_shared:
        sh, sh_partial = _local(params, cfg, SHARED_AXES, shard, ("ffn",))
        xs = shard.copy_to_model(xf) if sh_partial else xf
        h = xs @ sh["shared_wi"].to(xf.dtype)
        g = xs @ sh["shared_wg"].to(xf.dtype)
        y_sh = (F.silu(g) * h) @ sh["shared_wo"].to(xf.dtype)
        if sh_partial == partial:        # one reduce_from for both partial sums
            y, y_sh = y + y_sh, None
    if partial:
        y = shard.reduce_from(y, "model")
    if y_sh is not None:
        y = y + (shard.reduce_from(y_sh, "model") if sh_partial else y_sh)
    return y.reshape(B, T, d), _aux(cfg, logits, probs, top_e, keep, shard)
