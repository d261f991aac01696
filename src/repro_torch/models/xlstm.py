"""xLSTM blocks in PyTorch (counterpart of ``repro/models/xlstm.py``;
arXiv:2405.04517, xlstm-1.3b).

* mLSTM: a ``(D, D)`` matrix memory per head with exponential gating and
  the max stabiliser.  The recurrent form (the default) is a Python loop
  over time that keeps ``[C | n]`` in one ``(B·H, D, D + 1)`` buffer,
  updated in place: three launches per step (scale by the forget gate,
  add the outer product, read ``[C^T q | n·q]``), the stabiliser's two
  before them.  Where autograd records (training), each step makes a new
  buffer instead.  The chunked form evaluates a masked quadratic inside each
  chunk and updates the state once per chunk.
* sLSTM: scalar memory with block-diagonal recurrent weights, a loop over
  time.

Both keep an O(1) decode state that the decode steps update in place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.ssm import _causal_conv, _gated_rms, records_grad


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """``mlstm_impl``: ``"recurrent"`` (a loop over time) or ``"chunked"``
    (chunkwise parallel, taken when ``T % chunk == 0`` and ``T > chunk``).
    ``scan_unroll`` is kept for parity with the reference's config (it
    unrolls a ``lax.scan`` for XLA's cost analysis) and has no effect here."""

    d_model: int
    n_heads: int = 4
    proj_factor: int = 2
    conv_width: int = 4
    mlstm_impl: str = "recurrent"
    chunk: int = 64
    scan_unroll: bool = False

    @property
    def d_inner(self) -> int:
        return self.proj_factor * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


# ------------------------------- mLSTM --------------------------------------


def _mlstm_core(q, k, v, i_pre, f_pre):
    """Stabilised recurrent mLSTM.  ``q, k, v (B, T, H, D)``, gates ``(B, T,
    H)`` pre-activation -> ``(y (B, T, H, D), (C, n, m))`` fp32.

    ``C_t = f C + i k v^T``, ``n_t = f n + i k``, ``y = C^T q / max(|n.q|,
    exp(-m))`` with ``m_t = max(log f + m_{t-1}, log i)`` (``m_0 = 0``).  The
    stabiliser only needs the gates, so it runs first; then each step
    scales ``[C | n]`` by ``f``, adds ``i k [v | 1]^T`` and reads ``q [C |
    n]``, in place."""
    B, T, H, D = q.shape
    BH = B * H
    dev = q.device
    it, logf = i_pre.float(), F.logsigmoid(f_pre.float())
    ms, m = [], torch.zeros((B, H), dtype=torch.float32, device=dev)
    for t in range(T):
        m = torch.maximum(logf[:, t] + m, it[:, t])
        ms.append(m)
    m_all = torch.stack(ms, 1)                                  # (B, T, H)
    m_prev = torch.cat([torch.zeros_like(m_all[:, :1]), m_all[:, :-1]], 1)
    i_ = torch.exp(it - m_all)
    f_ = torch.exp(logf + m_prev - m_all)

    def steps(t):                                               # (B, T, H, ...) -> (T, BH, ...)
        return t.transpose(0, 1).reshape((T, BH) + tuple(t.shape[3:]))

    ik = steps(i_[..., None] * k.float())[..., None]            # (T, BH, D, 1)
    v1 = steps(torch.cat([v.float(), v.new_ones((B, T, H, 1), dtype=torch.float32)], -1))
    qs = steps(q.float() * D ** -0.5)[:, :, None]               # (T, BH, 1, D)
    fs = steps(f_)[..., None, None]                             # (T, BH, 1, 1)
    Cn = torch.zeros((BH, D, D + 1), dtype=torch.float32, device=dev)   # [C | n]
    track = records_grad(q, k, v, i_pre, f_pre)     # bmm's backward keeps each Cn
    out = []
    for t in range(T):
        if track:
            Cn = torch.baddbmm(Cn * fs[t], ik[t], v1[t][:, None])
        else:
            Cn.mul_(fs[t]).baddbmm_(ik[t], v1[t][:, None])
        out.append(torch.bmm(qs[t], Cn))                        # (BH, 1, D + 1)
    out = torch.stack(out).reshape(T, B, H, D + 1).transpose(0, 1)
    den = torch.maximum(out[..., D].abs(), torch.exp(-m_all))
    y = out[..., :D] / den[..., None]
    Cn = Cn.reshape(B, H, D, D + 1)
    return y, (Cn[..., :D].contiguous(), Cn[..., D].contiguous(), m)


def _mlstm_core_chunked(q, k, v, i_pre, f_pre, chunk: int):
    """Chunkwise-parallel stabilised mLSTM: the same math as
    :func:`_mlstm_core`, per chunk a masked quadratic intra-chunk term plus
    one ``(D, D)`` state update.  ``T`` must be a multiple of ``chunk``."""
    B, T, H, D = q.shape
    scale = D ** -0.5
    nc, Q = T // chunk, chunk

    def r(t):                                                   # -> (nc, B, Q, ...)
        return t.reshape((B, nc, Q) + tuple(t.shape[2:])).transpose(0, 1)

    qc = r(q).float() * scale
    kc, vc = r(k).float(), r(v).float()
    a = F.logsigmoid(r(f_pre).float())                          # (nc, B, Q, H)
    b = r(i_pre).float()
    Fc = torch.cumsum(a, dim=2)                                 # in-chunk log-forget
    F_total = Fc[:, :, -1, :]                                   # (nc, B, H)
    # intra-chunk log-weights W[i, l] = F_i - F_l + b_l (l <= i), -inf above
    logw = Fc[:, :, :, None, :] - Fc[:, :, None, :, :] + b[:, :, None, :, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    logw = torch.where(tri[None, None, :, :, None], logw, float("-inf"))
    m_intra = logw.amax(dim=3)                                  # (nc, B, Q, H)

    C_p = torch.zeros((B, H, D, D), dtype=torch.float32, device=q.device)
    n_p = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    m_p = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    ys = []
    for c in range(nc):
        qb, kb, vb, bb, Fb, Ft = qc[c], kc[c], vc[c], b[c], Fc[c], F_total[c]
        m_i = torch.maximum(m_p[:, None, :] + Fb, m_intra[c])  # (B, Q, H)
        w = torch.exp(logw[c] - m_i[:, :, None, :])             # (B, Qi, Ql, H)
        s = torch.einsum("bihd,blhd->bilh", qb, kb)
        y_intra = torch.einsum("bilh,blhd->bihd", s * w, vb)
        n_intra = torch.einsum("bilh,blhd->bihd", w, kb)
        dec_i = torch.exp(m_p[:, None, :] + Fb - m_i)           # (B, Q, H)
        y_inter = torch.einsum("bihd,bhde->bihe", qb, C_p) * dec_i[..., None]
        n_inter = torch.einsum("bihd,bhd->bih", qb, n_p) * dec_i
        den_dot = torch.einsum("bihd,bihd->bih", qb, n_intra) + n_inter
        den = torch.maximum(den_dot.abs(), torch.exp(-m_i))
        ys.append((y_intra + y_inter) / den[..., None])
        m_new = torch.maximum(m_p + Ft, (Ft[:, None] - Fb + bb).amax(dim=1))
        dec_l = torch.exp(Ft[:, None, :] - Fb + bb - m_new[:, None, :])    # (B, Q, H)
        carry = torch.exp(m_p + Ft - m_new)
        C_p = carry[..., None, None] * C_p + torch.einsum("blhd,blhe->bhde",
                                                          dec_l[..., None] * kb, vb)
        n_p = carry[..., None] * n_p + torch.einsum("blh,blhd->bhd", dec_l, kb)
        m_p = m_new
    y = torch.stack(ys, 1).reshape(B, T, H, D)
    return y, (C_p, n_p, m_p)


def mlstm_forward(params: dict, cfg: XLSTMConfig, x: torch.Tensor,
                  return_state: bool = False):
    """``x (B, T, d) -> (B, T, d)``; with ``return_state`` also the decode
    state ``{"C", "n", "m", "conv"}`` after the last token.  The chunked
    core runs only when ``mlstm_impl == "chunked"``, ``T % chunk == 0`` and
    ``T > chunk``, as the reference decides."""
    B, T, _ = x.shape
    di, H, hd = cfg.d_inner, cfg.n_heads, cfg.head_dim
    xm, z = (x @ params["up"].to(x.dtype)).chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xm, params["conv_w"], params["conv_b"]))
    q = (xc @ params["wq"].to(x.dtype)).reshape(B, T, H, hd)
    k = (xc @ params["wk"].to(x.dtype)).reshape(B, T, H, hd)
    v = (xm @ params["wv"].to(x.dtype)).reshape(B, T, H, hd)
    i_pre = xc @ params["w_i"].to(x.dtype) + params["b_i"].to(x.dtype)
    f_pre = xc @ params["w_f"].to(x.dtype) + params["b_f"].to(x.dtype)
    if cfg.mlstm_impl == "chunked" and T % cfg.chunk == 0 and T > cfg.chunk:
        yh, (Cf, nf, mf) = _mlstm_core_chunked(q, k, v, i_pre, f_pre, cfg.chunk)
    else:
        yh, (Cf, nf, mf) = _mlstm_core(q, k, v, i_pre, f_pre)
    y = _gated_rms(yh.reshape(B, T, di).to(x.dtype), params["norm"], x.dtype)
    out = (y * F.silu(z)) @ params["down"].to(x.dtype)
    if not return_state:
        return out
    W = cfg.conv_width
    conv = torch.cat([x.new_zeros((B, max(0, W - 1 - T), di)), xm[:, max(0, T - (W - 1)):]], 1)
    return out, {"C": Cf, "n": nf, "m": mf, "conv": conv}


def mlstm_init_state(cfg: XLSTMConfig, batch: int, dtype=torch.float32,
                     device="cuda") -> dict:
    """Zeroed decode state: ``C``, ``n``, ``m`` fp32, ``conv`` in ``dtype``."""
    H, hd = cfg.n_heads, cfg.head_dim

    def zeros(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    return {"C": zeros(batch, H, hd, hd), "n": zeros(batch, H, hd), "m": zeros(batch, H),
            "conv": zeros(batch, cfg.conv_width - 1, cfg.d_inner, dt=dtype)}


def mlstm_decode_step(params: dict, cfg: XLSTMConfig, x: torch.Tensor,
                      state: dict) -> tuple[torch.Tensor, dict]:
    """One token ``x (B, 1, d)``: the O(1) update of ``state``, in place."""
    B = x.shape[0]
    di, H, hd = cfg.d_inner, cfg.n_heads, cfg.head_dim
    xm, z = (x[:, 0] @ params["up"].to(x.dtype)).chunk(2, dim=-1)
    conv = state["conv"]
    buf = torch.cat([conv, xm[:, None].to(conv.dtype)], dim=1)
    xc = F.silu((buf * params["conv_w"].to(x.dtype)).sum(1) + params["conv_b"].to(x.dtype))
    conv.copy_(buf[:, 1:])
    q = (xc @ params["wq"].to(x.dtype)).reshape(B, H, hd).float()
    k = (xc @ params["wk"].to(x.dtype)).reshape(B, H, hd).float()
    v = (xm @ params["wv"].to(x.dtype)).reshape(B, H, hd).float()
    it = (xc @ params["w_i"].to(x.dtype) + params["b_i"].to(x.dtype)).float()
    ft = (xc @ params["w_f"].to(x.dtype) + params["b_f"].to(x.dtype)).float()
    C, n, m = state["C"], state["n"], state["m"]
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(logf + m - m_new)
    ik = i_[..., None] * k
    C.mul_(f_[..., None, None]).addcmul_(ik[..., :, None], v[..., None, :])
    n.mul_(f_[..., None]).add_(ik)
    m.copy_(m_new)
    qs = q * hd ** -0.5
    num = torch.matmul(qs[:, :, None, :], C)[:, :, 0]                    # (B, H, hd)
    den = torch.maximum((n * qs).sum(-1).abs(), torch.exp(-m_new))
    y = _gated_rms((num / den[..., None]).reshape(B, di).to(x.dtype), params["norm"], x.dtype)
    y = (y * F.silu(z)) @ params["down"].to(x.dtype)
    return y[:, None], state


# ------------------------------- sLSTM --------------------------------------


def _slstm_weights(params: dict, x: torch.Tensor, H: int):
    """Gate pre-activations ``(B, T, 4, d)`` fp32 (z, i, f, o) and the
    recurrent weights as one ``(H, hd, 4·hd)`` batch (the reference's
    ``einsum("bhe,ghef->bghf")`` becomes one ``bmm`` per step)."""
    pre = torch.stack([x @ params[f"w_{g}"].to(x.dtype) for g in "zifo"], -2).float()
    pre = pre + torch.stack([params[f"b_{g}"].float() for g in "zifo"])
    rz = torch.stack([params[f"r_{g}"].float() for g in "zifo"])       # (4, H, hd, hd)
    hd = rz.shape[-1]
    return pre, rz.permute(1, 2, 0, 3).reshape(H, hd, 4 * hd)


def _slstm_step(pre_t, R, c, n, h, m):
    """One sLSTM step: ``pre_t (B, 4, d)``, state ``(B, H, hd)`` each ->
    the new ``(c, n, h, m)``."""
    B, H, hd = h.shape
    rec = torch.bmm(h.transpose(0, 1), R).reshape(H, B, 4, hd).permute(1, 2, 0, 3)
    tot = pre_t.reshape(B, 4, H, hd) + rec
    zt, it = torch.tanh(tot[:, 0]), tot[:, 1]
    ft, ot = F.logsigmoid(tot[:, 2]), torch.sigmoid(tot[:, 3])
    m_new = torch.maximum(ft + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + m - m_new)
    c_new = f_ * c + i_ * zt
    n_new = f_ * n + i_
    return c_new, n_new, ot * c_new / torch.clamp_min(n_new, 1.0), m_new


def slstm_forward(params: dict, cfg: XLSTMConfig, x: torch.Tensor,
                  return_state: bool = False):
    """Scalar-memory LSTM with exponential gating, a loop over time; the
    head width is ``d_model / H`` here (not ``d_inner / H``)."""
    B, T, d = x.shape
    H = cfg.n_heads
    pre, R = _slstm_weights(params, x, H)
    zero = torch.zeros((B, H, d // H), dtype=torch.float32, device=x.device)
    st, hs = (zero, zero, zero, zero), []
    for t in range(T):
        st = _slstm_step(pre[:, t], R, *st)
        hs.append(st[2])
    y = _gated_rms(torch.stack(hs, 1).reshape(B, T, d).to(x.dtype), params["norm"], x.dtype)
    if return_state:
        return y, dict(zip("cnhm", st))
    return y


def slstm_init_state(cfg: XLSTMConfig, batch: int, dtype=torch.float32,
                     device="cuda") -> dict:
    """Zeroed decode state: ``c``, ``n``, ``h``, ``m``, each ``(B, H, d / H)``
    fp32 (``dtype`` is not used: every leaf is fp32, as the reference's)."""
    H = cfg.n_heads
    return {name: torch.zeros((batch, H, cfg.d_model // H), dtype=torch.float32,
                              device=device) for name in "cnhm"}


def slstm_decode_step(params: dict, cfg: XLSTMConfig, x: torch.Tensor,
                      state: dict) -> tuple[torch.Tensor, dict]:
    """One token ``x (B, 1, d)``: the state update, written into ``state``."""
    B, _, d = x.shape
    pre, R = _slstm_weights(params, x[:, 0], cfg.n_heads)
    new = _slstm_step(pre, R, *(state[name] for name in "cnhm"))
    for name, t in zip("cnhm", new):
        state[name].copy_(t)
    y = _gated_rms(new[2].reshape(B, d).to(x.dtype), params["norm"], x.dtype)
    return y[:, None], state
