"""Analytic cost helpers (counterpart of ``repro/models/costs.py``).

* :func:`model_flops`: 6·N_active·D to train, 2·N_active·D for a forward
  (prefill or decode), with MoE active-parameter accounting: a model-FLOP
  count that does not depend on what implements the step;
* :func:`analytic_hbm_bytes`: the reference's lower bound of HBM traffic
  per device (parameter passes, activations at the unit boundaries, the
  KV cache, the logits), with its TPU-pod defaults (``tp=16``,
  ``param_bytes=2``);
* :func:`recurrent_adders`: the FLOPs and bytes of ``T - 1`` more
  recurrence bodies of the mLSTM and sLSTM blocks, which the reference adds
  to XLA's cost analysis of a ``lax.scan`` that counts its body once.

Shapes come from ``lm.param_shapes`` and ``lm.init_caches(...,
device="meta")``, so nothing is allocated.  Caches are sized in bf16, as
the reference's ``eval_shape`` of ``init_caches(..., jnp.bfloat16)``,
whatever the port's default dtype.  The arithmetic is the reference's, in
its order, so every result equals the reference's.
"""

from __future__ import annotations

import math

import torch

from repro_torch.convert import flatten_with_paths
from repro_torch.models import lm
from repro_torch.models.lm import ModelConfig


def n_params(model: ModelConfig) -> int:
    # python-int product: no overflow on >2B-element tensors
    return sum(math.prod(spec.shape)
               for spec in flatten_with_paths(lm.param_shapes(model)).values())


def n_active_params(model: ModelConfig) -> int:
    """Params touched per token: routed experts scaled by top_k/E."""
    total = n_params(model)
    inactive = 0
    for blocks, mult in (
        (model.unit, model.n_repeats),
        (model.prologue, 1),
        (model.epilogue, 1),
    ):
        for b in blocks:
            if b.kind == "attn_moe" and b.moe is not None:
                m = b.moe
                per_expert = m.d_model * m.d_ff * (3 if m.gated else 2)
                routed = m.n_experts * per_expert
                active = m.top_k * per_expert
                inactive += mult * (routed - active)
    return total - inactive


def model_flops(model: ModelConfig, tokens: int, mode: str) -> float:
    """6·N_active·D for train, 2·N_active·D for prefill/decode forward."""
    na = n_active_params(model)
    mult = 6.0 if mode == "train" else 2.0
    return mult * na * tokens


def np_prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def _cache_bytes(model: ModelConfig, global_batch: int, seq: int) -> int:
    """Bytes of ``lm.init_caches`` in bf16 (recurrent states keep their
    fp32 leaves), on the meta device."""
    caches = lm.init_caches(model, global_batch, seq, torch.bfloat16, device="meta")
    return sum(math.prod(leaf.shape) * leaf.element_size()
               for leaf in flatten_with_paths(caches).values())


def analytic_hbm_bytes(
    model: ModelConfig, *, global_batch: int, seq: int, mode: str,
    n_devices: int, tp: int = 16, param_bytes: int = 2,
) -> float:
    """Fusion-aware analytic HBM traffic per device (lower bound): parameter
    reads (x passes), activation saves/reads at remat boundaries, KV-cache
    traffic, logits."""
    n = n_params(model)
    tokens_dev = global_batch * (seq if mode != "decode" else 1) / n_devices
    d = model.d_model
    # parameter passes: fwd + bwd + opt (train) / single read (inference)
    passes = 4.0 if mode == "train" else 1.0
    p_bytes = n / tp * param_bytes * passes
    act_bytes = 0.0
    if mode == "train":
        # remat=unit: save + re-read one activation per unit boundary, then
        # recompute: 2 saves+reads per repeat + logits fp32
        act_bytes = model.n_repeats * tokens_dev * d * 2 * 4
        act_bytes += tokens_dev * model.vocab * 4 * 2 / tp
    elif mode == "prefill":
        cache = _cache_bytes(model, global_batch, seq)
        act_bytes = cache / n_devices + tokens_dev * model.vocab * 4 / tp
    else:  # decode: read the whole cache once
        act_bytes = _cache_bytes(model, global_batch, seq) / n_devices
    return p_bytes + act_bytes


def recurrent_adders(model: ModelConfig, batch: int, T: int, mode: str) -> dict:
    """FLOPs/bytes of (T-1) extra recurrence-body steps for mLSTM/sLSTM
    blocks (per rep), scaled by repeats. Decode (T=1) needs no adder."""
    if T <= 1:
        return {"flops": 0.0, "bytes": 0.0}
    flops = 0.0
    bytes_ = 0.0
    fwd_mult = 3.0 if mode == "train" else 1.0  # bwd ~ 2x fwd
    for blocks, mult in (
        (model.unit, model.n_repeats),
        (model.prologue, 1),
        (model.epilogue, 1),
    ):
        for b in blocks:
            if (b.kind == "mlstm" and b.xlstm is not None
                    and b.xlstm.mlstm_impl != "chunked"):
                # the chunked mLSTM is loop-free in the reference's cost
                # mode: no adder
                H, D = b.xlstm.n_heads, b.xlstm.head_dim
                # per step: C update (2 fma over H·D²) + decay mult + n/den/num
                body_f = batch * H * (6.0 * D * D + 6.0 * D)
                body_b = batch * H * D * D * 4.0 * 4  # C read+write fp32
                flops += mult * (T - 1) * body_f * fwd_mult
                bytes_ += mult * (T - 1) * body_b * fwd_mult
            if b.kind == "slstm" and b.xlstm is not None:
                H = b.xlstm.n_heads
                hd = model.d_model // H
                body_f = batch * (4 * H * hd * hd * 2 + 12 * H * hd)
                body_b = batch * H * hd * 4.0 * 8
                flops += mult * (T - 1) * body_f * fwd_mult
                bytes_ += mult * (T - 1) * body_b * fwd_mult
    return {"flops": flops, "bytes": bytes_}
