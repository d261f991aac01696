"""Mamba2 (SSD) blocks in PyTorch (counterpart of ``repro/models/ssm.py``;
zamba2).

The SSD form splits the sequence into chunks: within a chunk the recurrence
is a masked quadratic form, and a short loop carries the ``(H, N, P)``
state across chunks.  The reference's four-operand einsums are contracted
here as elementwise products followed by one batched matmul, so no
``(Q, Q, H, P)`` tensor is ever built.  Decode keeps an O(1) recurrent
state ``{"ssm": (B, H, N, P) fp32, "conv": (B, W - 1, conv_dim)}``, which
:func:`mamba2_decode_step` updates in place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def records_grad(*ts: torch.Tensor) -> bool:
    """True when autograd records an op on ``ts``: grad mode is on and one
    of them requires grad.  Then the in-place state updates of the serving
    paths would overwrite what a backward needs, and the out-of-place form
    (the same products in the same order) runs instead."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over ``(B, T, C)`` with a width-W kernel ``(W, C)``."""
    W, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + T] * w[i].to(x.dtype) for i in range(W))
    return out + b.to(x.dtype)


def _gated_rms(y: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """The blocks' output norm: fp32 RMS, cast, then the ``w`` scale in
    ``dtype`` (the reference casts before scaling, unlike ``rmsnorm``)."""
    yf = y.float()
    rms = torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
    return (yf * rms).to(dtype) * w.to(dtype)


def _ssd_chunked(xh, Bm, Cm, dt, A, chunk: int, return_final: bool = False):
    """SSD scan.  ``xh (B, T, H, P)``, ``Bm``/``Cm (B, T, G, N)``, ``dt (B,
    T, H)``, ``A (H,) < 0`` -> ``y (B, T, H, P)`` fp32 (and the final
    ``(B, H, N, P)`` state with ``return_final``).  Heads are grouped:
    ``H / G`` consecutive heads share each B/C group.  ``T`` must be a
    multiple of ``chunk``."""
    Bsz, T, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    if T % chunk:
        raise ValueError(f"SSD scan: T = {T} is not a multiple of chunk = {chunk} (a prompt "
                         "longer than the chunk must be a multiple of it)")
    nc, Q = T // chunk, chunk

    def r(t):                                           # (B, T, ...) -> (B, nc, Q, ...)
        return t.reshape((Bsz, nc, Q) + tuple(t.shape[2:]))

    x_c, B_c, C_c, dt_c = r(xh).float(), r(Bm).float(), r(Cm).float(), r(dt)
    a = dt_c * A.to(dt.dtype)                           # (B, nc, Q, H) log-decay
    cs = torch.cumsum(a, dim=2)
    dt_f = dt_c.float()

    # intra-chunk: Y[i] = sum_{j <= i} C_i.B_j exp(cs_i - cs_j) dt_j x_j.  Above
    # the diagonal exp() overflows; torch.where drops it (a 0/1 product gives NaN)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]   # (B, nc, Qi, Qj, H)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    L = torch.where(mask[None, None, :, :, None], torch.exp(seg), 0.0).float()
    del seg
    CB = torch.einsum("bcign,bcjgn->bcijg", C_c, B_c)   # (B, nc, Qi, Qj, G)
    if records_grad(xh, Bm, Cm, dt, A):   # the product's backward needs this L
        L = (L.view(Bsz, nc, Q, Q, G, rep) * CB[..., None]).view(Bsz, nc, Q, Q, H)
        L = L * dt_f[:, :, None, :, :]
    else:
        L.view(Bsz, nc, Q, Q, G, rep).mul_(CB[..., None])
        L.mul_(dt_f[:, :, None, :, :])
    y = torch.einsum("bcijh,bcjhp->bcihp", L, x_c)      # one batched matmul over j
    del L, CB

    # chunk states: S_c = sum_q exp(cs_end - cs_q) dt_q B_q x_q^T  (B, nc, H, N, P)
    w = torch.exp(cs[:, :, -1:, :] - cs).float() * dt_f
    Bh = B_c.repeat_interleave(rep, dim=-2)             # (B, nc, Q, H, N)
    S = torch.einsum("bcqhn,bcqhp->bchnp", Bh * w[..., None], x_c)
    chunk_decay = torch.exp(cs[:, :, -1, :]).float()    # (B, nc, H)
    S_prevs = torch.empty_like(S)
    carry = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=xh.device)
    for c in range(nc):
        S_prevs[:, c] = carry
        carry = S[:, c] + chunk_decay[:, c, :, None, None] * carry

    # between chunks: Y[i] += C_i exp(cs_i) S_prev
    Ch = C_c.repeat_interleave(rep, dim=-2) * torch.exp(cs).float()[..., None]
    y += torch.einsum("bcqhn,bchnp->bcqhp", Ch, S_prevs)
    y = y.reshape(Bsz, T, H, P)
    return (y, carry) if return_final else y


def mamba2_forward(params: dict, cfg: Mamba2Config, x: torch.Tensor,
                   return_state: bool = False):
    """``x (B, T, d_model) -> (B, T, d_model)``; ``T`` at most ``cfg.chunk``
    or a multiple of it.  With ``return_state`` also the decode state
    ``{"ssm", "conv"}`` after the last token (prefill)."""
    B, T, _ = x.shape
    di, H, P, G, N = cfg.d_inner, cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xbc_raw, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    xbc = F.silu(_causal_conv(xbc_raw, params["conv_w"], params["conv_b"]))
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xh = xs.reshape(B, T, H, P)
    Bm, Cm = Bm.reshape(B, T, G, N), Cm.reshape(B, T, G, N)
    dt = F.softplus(dt + params["dt_bias"].to(x.dtype))
    A = -torch.exp(params["A_log"].float())
    y, S_final = _ssd_chunked(xh, Bm, Cm, dt, A, min(cfg.chunk, T), return_final=True)
    y = y + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, T, di).to(x.dtype) * F.silu(z)   # gated RMSNorm (norm(z-gate))
    out = _gated_rms(y, params["norm"], x.dtype) @ params["out_proj"].to(x.dtype)
    if not return_state:
        return out
    W = cfg.conv_width
    conv = torch.cat([x.new_zeros((B, max(0, W - 1 - T), cfg.conv_dim)),
                      xbc_raw[:, max(0, T - (W - 1)):]], dim=1)
    return out, {"ssm": S_final, "conv": conv}


def mamba2_init_state(cfg: Mamba2Config, batch: int, dtype=torch.float32,
                      device="cuda") -> dict:
    """Zeroed decode state: ``ssm`` always fp32, ``conv`` in ``dtype``."""
    return {
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.conv_dim), dtype=dtype,
                            device=device),
    }


def mamba2_decode_step(params: dict, cfg: Mamba2Config, x: torch.Tensor,
                       state: dict) -> tuple[torch.Tensor, dict]:
    """One token ``x (B, 1, d)``: the O(1) state update, written into
    ``state`` in place; returns ``(y (B, 1, d), state)``."""
    B = x.shape[0]
    di, H, P, G, N = cfg.d_inner, cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    zxbcdt = x[:, 0] @ params["in_proj"].to(x.dtype)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    conv = state["conv"]
    buf = torch.cat([conv, xbc[:, None].to(conv.dtype)], dim=1)        # (B, W, C)
    xbc = F.silu((buf * params["conv_w"].to(x.dtype)).sum(1) + params["conv_b"].to(x.dtype))
    conv.copy_(buf[:, 1:])
    xs, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xh = xs.reshape(B, H, P).float()
    Bm = Bm.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()
    Cm = Cm.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()
    dt = F.softplus(dt + params["dt_bias"].to(x.dtype)).float()
    decay = torch.exp(dt * -torch.exp(params["A_log"].float()))         # (B, H)
    S = state["ssm"]
    S.mul_(decay[..., None, None]).addcmul_((dt[..., None] * Bm)[..., :, None],
                                            xh[..., None, :])
    y = torch.matmul(Cm[:, :, None, :], S)[:, :, 0]                     # (B, H, P)
    y = y + params["D"].float()[None, :, None] * xh
    y = y.reshape(B, di).to(x.dtype) * F.silu(z)
    y = _gated_rms(y, params["norm"], x.dtype) @ params["out_proj"].to(x.dtype)
    return y[:, None], state
