"""Token sampling (the greedy part of ``repro/serve/speculative.py``).

Speculative decoding itself is not ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import torch

SAMPLING_NOT_PORTED = (
    "temperature > 0 sampling needs the threefry PRNG port (ROADMAP queue 1, "
    "item 11); only greedy decoding is ported")


def sample_tokens(logits: torch.Tensor, temperature: float = 0.0) -> torch.Tensor:
    """``logits (R, vocab)`` -> ``(R,)`` int32 tokens.

    Greedy only: argmax, first index on ties (as ``jnp.argmax``).  Sampling
    at ``temperature > 0`` needs the reference's threefry key chains ported
    (ROADMAP queue 1, item 11) to give the same draws, so it raises.
    """
    if temperature > 0.0:
        raise NotImplementedError(SAMPLING_NOT_PORTED)
    return torch.argmax(logits, dim=-1).to(torch.int32)
