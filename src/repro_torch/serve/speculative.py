"""Speculative decoding (counterpart of ``repro/serve/speculative.py``).

A cheap drafter proposes ``k`` tokens per row by ``k`` decode steps, and ONE
verification pass of the target (``lm.verify_window``) scores all ``W = k +
1`` window positions: batch-shaped work of ``B·W`` rows, which the KAN FFN
runs through the fused kernel where decode runs the sparse one
(``core/kan_layer.py: resolve_inference_method``).  The drafter is a
shrunken KAN: the first ``draft_layers`` repeats of the target's own stacked
unit (views of its parameters, no second checkpoint), optionally int8
fake-quantised.

Acceptance (:func:`accept_window`): window position ``j`` emits the
target's token ``t_j``, sampled from the target's logits with the request's
own chain key for that emission (greedy: the argmax), and the drafter's
``d_j``, sampled with the same key, is accepted iff ``d_j == t_j``.  So the
emitted stream is always the target chain's own stream; the drafter moves
only the acceptance rate.  The target's tokens come from a forward at
``B·W`` rows instead of ``B``, so on the card they equal the sequential
engine's up to the kernels' summation order: a stream can differ only where
two perturbed scores are within that rounding (a near-tie).

Sampling (:func:`sample_tokens`) is the reference's ``categorical`` draw
per row, ``argmax(logits / T + gumbel(key))``, on the threefry port
(``serve/threefry.py``).  The Gumbel noise depends only on the key, not on
the logits, so a caller that knows a chunk's keys up front (every decode
chunk and verify window does: :func:`split_chain`) draws the noise of all
its steps in one batched call and samples each step with
:func:`sample_with_noise`; the tokens are the same.

Cache lockstep (DESIGN.md §9): the drafter keeps its own dense cache
``(slots, max_seq)`` over ``draft_layers`` layers.  The draft loop writes
``tok, d_0..d_{k-1}`` at ``pos..pos+k-1``; positions up to ``pos' - 1``
hold the emitted stream's KV, and what lies beyond is rewritten by the next
window before any causal mask can expose it, the same argument that lets
the target cache skip rollback.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.serve import threefry


def sample_with_noise(logits: torch.Tensor, noise: torch.Tensor | None,
                      temperature: float) -> torch.Tensor:
    """``logits (R, vocab)`` and their rows' Gumbel noise ``(R, vocab)``
    (``threefry.gumbel(step_keys, (vocab,))``) -> ``(R,)`` int32:
    ``argmax(logits / T + noise)``, the division in float32 by a tensor on
    the logits' device (a CPU scalar divisor would let the card multiply by
    its reciprocal), first index on ties.  At ``temperature <= 0`` the
    argmax of the logits; ``noise`` is not read."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if logits.dtype != torch.float32:
        raise TypeError(f"sampling takes float32 logits, got {logits.dtype}")
    t = torch.full((), temperature, dtype=torch.float32, device=logits.device)
    return torch.argmax(logits / t + noise, dim=-1).to(torch.int32)


def sample_tokens(logits: torch.Tensor, step_keys: torch.Tensor | None,
                  temperature: float) -> torch.Tensor:
    """Per-row sampling: ``logits (R, vocab)``, ``step_keys (R, 2)``, one
    key per row -> ``(R,)`` int32.  The reference's ``vmap(categorical(k,
    lg / temperature))``: each row's draw is a function of its key and its
    logits alone, so a row samples the same token at any batch shape.  At
    ``temperature <= 0`` the argmax (``step_keys`` may be None)."""
    noise = None
    if temperature > 0.0:
        noise = threefry.gumbel(step_keys, logits.shape[-1:])
    return sample_with_noise(logits, noise, temperature)


def perturbed_top2_gap(logits: torch.Tensor, noise: torch.Tensor,
                       temperature: float) -> torch.Tensor:
    """``(R,)`` float32: the gap between the two highest perturbed scores
    ``logits / T + noise`` of each row.  Two samplers whose logits differ
    by ``e`` (and noise by ``g``) can draw different tokens only where it
    is below ``2 * (e / T + g)``: a near-tie."""
    t = torch.full((), temperature, dtype=torch.float32, device=logits.device)
    top = torch.topk(logits.float() / t + noise, 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def split_chain(keys, n: int):
    """Advance every row's key chain ``n`` splits up front.

    ``keys (B, 2)`` -> ``(kts (B, n, 2), chains (B, n + 1, 2))``:
    ``kts[:, j]`` is the sampling key of the chain's ``j``-th split and
    ``chains[:, j]`` the carry after ``j`` splits (``chains[:, 0] ==
    keys``), split for split the sequential decode loop's ``pairs =
    split(keys); keys, kt = pairs[:, 0], pairs[:, 1]``.  A window that emits
    ``m`` tokens resumes from ``chains[:, m]``.  Takes torch or numpy keys
    (``threefry.split``) and returns the same kind."""
    carry, kts, chains = keys, [], [keys]
    for _ in range(n):
        pairs = threefry.split(carry)
        carry = pairs[..., 0, :]
        kts.append(pairs[..., 1, :])
        chains.append(carry)
    if isinstance(keys, torch.Tensor):
        empty = keys.new_empty((keys.shape[0], 0, 2))
        return (torch.stack(kts, dim=1) if kts else empty), torch.stack(chains, dim=1)
    empty = np.empty((keys.shape[0], 0, 2), keys.dtype)
    return (np.stack(kts, axis=1) if kts else empty), np.stack(chains, axis=1)


def accept_window(
    draft: torch.Tensor,              # (B, k) drafter proposals
    target: torch.Tensor,             # (B, k+1) target tokens t_0..t_k
    eos_hit: torch.Tensor,            # (B,) bool: latched rows emit nothing
    eos_id: int,                      # -1 never matches
    pad_id: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Longest-matching-prefix acceptance with EOS latching.

    Window position ``j`` emits iff every earlier draft matched (``j <=
    n_acc``: the bonus token ``t_{n_acc}`` always rides along), no earlier
    position emitted EOS, and the row was not latched.  Returns
    ``(emitted (B, W), m (B,) int32, eos_new (B,))``: ``emitted[:, :m]`` is
    the accepted stream, possibly ending in EOS, and positions ``>= m``
    hold ``pad_id``."""
    k = draft.shape[1]
    W = k + 1
    match = (draft == target[:, :k]).to(torch.int32)
    n_acc = torch.cumprod(match, dim=1).sum(dim=1)            # leading matches
    j = torch.arange(W, device=target.device)[None, :]
    in_prefix = j <= n_acc[:, None]                           # (B, W)
    is_eos = ((target == eos_id) & in_prefix).to(torch.int32)
    eos_before = (torch.cumsum(is_eos, dim=1) - is_eos) > 0   # strictly earlier
    real = in_prefix & ~eos_before & ~eos_hit[:, None]
    m = real.sum(dim=1).to(torch.int32)
    emitted = torch.where(real, target, torch.full_like(target, pad_id))
    eos_new = eos_hit | (real & (target == eos_id)).any(dim=1)
    return emitted, m, eos_new


def draft_propose(
    dparams: dict,
    dcfg: lm.ModelConfig,             # the drafter's config
    k: int,                           # proposals per window
    tok: torch.Tensor,                # (B, 1) last emitted token
    caches: dict,                     # drafter dense caches, updated in place
    pos: torch.Tensor,                # (B,) window start positions
    keys,                             # (B, 2) the request chains (not consumed)
    eos_hit: torch.Tensor,            # (B,) latched rows freeze their position
    temperature: float = 0.0,
    compute_dtype=torch.float32,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """Propose ``k`` tokens per row by ``k`` drafter decode steps, sampling
    step ``j`` with the chain key ``split_chain(keys, k)[0][:, j]``, the key
    the verifier replays for the target at window position ``j``.  The
    chain itself is not consumed.  ``noise (B, k, vocab)``, when the caller
    has drawn it (``threefry.gumbel`` of those keys), replaces ``keys``.
    Latched rows keep their position frozen (they rewrite only their own
    dead slot).  Returns ``(draft (B, k) int32, caches)``."""
    if temperature > 0.0 and noise is None:
        kts, _ = split_chain(keys, k)
        noise = threefry.gumbel(torch.as_tensor(kts, device=tok.device), (dcfg.vocab,))
    drafts = []
    for j in range(k):
        lg, caches = lm.decode_step(dparams, dcfg, tok, caches, pos, compute_dtype)
        nxt = sample_with_noise(lg, None if noise is None else noise[:, j], temperature)
        pos = torch.where(eos_hit, pos, pos + 1)
        tok = nxt[:, None]
        drafts.append(nxt)
    return torch.stack(drafts, dim=1), caches


def _fake_quant_int8(a: torch.Tensor) -> torch.Tensor:
    """Symmetric per-output-channel int8 round trip of a weight (KANtize-style
    compression for the drafter), stored back in ``a``'s dtype as a NEW
    tensor (``a`` may be a view of the target's weights).  ``torch.round``
    rounds half to even, as ``jnp.round`` does; the fp32 arithmetic follows
    the reference op for op."""
    if a.dim() < 2 or not a.is_floating_point():
        return a
    af = a.to(torch.float32)
    scale = torch.clamp_min(af.abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0
    q = torch.clamp(torch.round(af / scale), -127, 127)
    return (q * scale).to(a.dtype)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


@dataclasses.dataclass
class DraftModel:
    """A drafter derived from (or supplied beside) the target's parameters.

    :meth:`from_target` keeps the first ``n_layers`` repeats of every
    stacked unit leaf as VIEWS of the target's tensors and aliases every
    other leaf (``embed``, ``final_ln``), so without quantisation it adds
    no weight memory.  Its dense KV cache costs ``n_layers / n_repeats`` of
    one dense target cache (DESIGN.md §9)."""

    params: dict
    cfg: lm.ModelConfig
    n_layers: int
    quant: bool = False

    @classmethod
    def from_target(cls, params: dict, cfg: lm.ModelConfig, n_layers: int = 1,
                    quant: bool = False) -> "DraftModel":
        if not (1 <= n_layers <= cfg.n_repeats):
            raise ValueError(f"draft_layers must be in [1, {cfg.n_repeats}], got {n_layers}")
        if not lm.model_supports_speculative(cfg):
            raise NotImplementedError(
                f"{cfg.name}: speculative drafter needs token-input "
                "full-attention GQA blocks throughout")
        dcfg = dataclasses.replace(cfg, name=f"{cfg.name}-draft{n_layers}",
                                   n_repeats=n_layers)
        dparams = dict(params)                       # alias the non-unit leaves
        unit = _map(params["unit"], lambda a: a[:n_layers])
        if quant:
            unit = _map(unit, _fake_quant_int8)
        dparams["unit"] = unit
        return cls(params=dparams, cfg=dcfg, n_layers=n_layers, quant=quant)
