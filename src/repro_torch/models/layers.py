"""Basic NN layers in PyTorch (counterpart of ``repro/models/layers.py``).

Parameters are plain nested dicts of tensors with the JAX package's layout,
so a JAX parameter tree converts leaf for leaf (``repro_torch.convert``).
"""

from __future__ import annotations

import torch


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(x.dtype)


def embed_lookup(params: dict, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    return params["table"].to(compute_dtype)[ids.long()]


def unembed_logits(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits in fp32."""
    return torch.einsum("...d,vd->...v", h.float(), params["table"].float())


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
