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


def route(params: dict, cfg: MoEConfig, xf: torch.Tensor):
    """The routing decisions of ``xf (S, d)``: ``(logits (S, E) fp32, probs,
    top_p (S, k) renormalised, top_e (S, k), pos (S, k) queue positions,
    keep (S, k), cap)``."""
    S = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = srt[:, :k], idx[:, :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    cap = int(max(k, cfg.capacity_factor * S * k / E))
    onehot = F.one_hot(top_e, E)                                # (S, k, E) int64
    flat = onehot.reshape(S * k, E)
    pos_in_e = (torch.cumsum(flat, dim=0) - flat).reshape(S, k, E)
    pos = (pos_in_e * onehot).sum(-1)                           # (S, k)
    return logits, probs, top_p, top_e, pos, pos < cap, cap


def moe_forward(params: dict, cfg: MoEConfig, x: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
    """``x (B, T, d) -> (y (B, T, d), aux)``."""
    B, T, d = x.shape
    S = B * T
    E, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(S, d)
    logits, probs, top_p, top_e, pos, keep, cap = route(params, cfg, xf)
    if cfg.dispatch == "scatter":
        slot = torch.where(keep, top_e * cap + pos, E * cap)    # a drop -> the overflow row
        xe = xf.new_zeros((E * cap + 1, d)).index_add_(
            0, slot.reshape(-1), xf.repeat_interleave(k, dim=0))
        ye = _expert_ffn(params, xe[:-1].reshape(E, cap, d), cfg.gated)
        gathered = ye.reshape(E * cap, d)[torch.clamp(slot, 0, E * cap - 1).reshape(-1)]
        w = (top_p.to(xf.dtype) * keep.to(xf.dtype))[..., None]
        y = (gathered.reshape(S, k, d) * w).sum(dim=1)
    elif cfg.dispatch == "einsum":
        disp = (F.one_hot(top_e, E).to(xf.dtype)[..., None]
                * F.one_hot(torch.clamp_max(pos, cap - 1), cap).to(xf.dtype)[..., None, :]
                * keep.to(xf.dtype)[..., None, None])           # (S, k, E, cap)
        xe = torch.einsum("sec,sd->ecd", disp.sum(1), xf)
        ye = _expert_ffn(params, xe, cfg.gated)
        comb = (disp * top_p.to(xf.dtype)[..., None, None]).sum(1)
        y = torch.einsum("sec,ecd->sd", comb, ye)
    else:
        raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r}")
    if cfg.n_shared:
        h = xf @ params["shared_wi"].to(xf.dtype)
        g = xf @ params["shared_wg"].to(xf.dtype)
        y = y + (F.silu(g) * h) @ params["shared_wo"].to(xf.dtype)
    me = probs.mean(0)
    ce = F.one_hot(top_e[:, 0], E).float().mean(0)
    aux = {"moe_lb_loss": E * torch.sum(me * ce),
           "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
           "moe_drop_frac": 1.0 - keep.float().mean()}
    return y.reshape(B, T, d), aux
