"""Greedy speculative decoding (counterpart of ``repro/serve/speculative.py``).

A cheap drafter proposes ``k`` tokens per row by ``k`` decode steps, and ONE
verification pass of the target (``lm.verify_window``) scores all ``W = k +
1`` window positions: batch-shaped work of ``B·W`` rows, which the KAN FFN
runs through the fused kernel where decode runs the sparse one
(``core/kan_layer.py: resolve_inference_method``).  The drafter is a
shrunken KAN: the first ``draft_layers`` repeats of the target's own stacked
unit (views of its parameters, no second checkpoint), optionally int8
fake-quantised.

Acceptance (:func:`accept_window`): window position ``j`` emits the
target's greedy token ``t_j``, and the drafter's ``d_j`` is accepted iff
``d_j == t_j``.  So the emitted stream is always the target's own greedy
stream; the drafter moves only the acceptance rate.  The target's tokens
come from a forward at ``B·W`` rows instead of ``B``, so on the card they
equal the sequential engine's up to the kernels' summation order: a stream
can differ only where two logits are within that rounding (a near-tie).

Cache lockstep (DESIGN.md §9): the drafter keeps its own dense cache
``(slots, max_seq)`` over ``draft_layers`` layers.  The draft loop writes
``tok, d_0..d_{k-1}`` at ``pos..pos+k-1``; positions up to ``pos' - 1``
hold the emitted stream's KV, and what lies beyond is rewritten by the next
window before any causal mask can expose it, the same argument that lets
the target cache skip rollback.

Only greedy decoding is ported.  Sampling at ``temperature > 0`` and the
reference's ``split_chain`` (each row's threefry key chain, advanced ``n``
splits up front) need the threefry port (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm

SAMPLING_NOT_PORTED = (
    "temperature > 0 sampling needs the threefry PRNG port (ROADMAP queue 1, "
    "item 4); only greedy decoding is ported")


def sample_tokens(logits: torch.Tensor, temperature: float = 0.0) -> torch.Tensor:
    """``logits (R, vocab)`` -> ``(R,)`` int32 tokens.

    Greedy only: argmax, first index on ties (as ``jnp.argmax``).  Sampling
    at ``temperature > 0`` needs the reference's threefry key chains ported
    (ROADMAP queue 1, item 4) to give the same draws, so it raises.
    """
    if temperature > 0.0:
        raise NotImplementedError(SAMPLING_NOT_PORTED)
    return torch.argmax(logits, dim=-1).to(torch.int32)


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
    eos_hit: torch.Tensor,            # (B,) latched rows freeze their position
    compute_dtype=torch.float32,
) -> tuple[torch.Tensor, dict]:
    """Propose ``k`` greedy tokens per row by ``k`` drafter decode steps.
    Latched rows keep their position frozen (they rewrite only their own
    dead slot).  Returns ``(draft (B, k) int32, caches)``."""
    drafts = []
    for _ in range(k):
        lg, caches = lm.decode_step(dparams, dcfg, tok, caches, pos, compute_dtype)
        nxt = sample_tokens(lg)
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
