"""Threefry-2x32 keys and the samplers built on them, in torch integer ops.

The counterpart of the parts of ``jax.random`` that the reference's
serving path draws through (``repro/serve/engine.py`` and
``repro/serve/speculative.py``): ``PRNGKey``, ``fold_in``, ``split``, 32-bit
``random_bits``, float32 ``uniform``, ``gumbel`` (mode ``"low"``) and
``categorical``; and ``randint``, which the trainer's synthetic token stream
(``data/pipeline.py: lm_batch``) draws through.  Given the same key, every function here returns the same
integers as ``jax.random``; the floats of ``uniform`` are built from those
integers bit for bit, and ``gumbel`` differs only by the rounding of
``torch.log`` against XLA's ``log`` (an ulp or so).

Semantics are those of ``jax_threefry_partitionable = True``, the default of
jax 0.5.0 and later: ``split`` and ``random_bits`` hash a 64-bit iota
counter split into two 32-bit words, and 32-bit bits are ``y0 ^ y1``.  Under
the older default (``False``), which jax 0.4.37 has, the version the
repository's CI pins (``.github/workflows/ci.yml``), ``split`` and
``random_bits`` give other bits; no switch for those semantics is offered.

A key is a ``(..., 2)`` int64 tensor holding two uint32 words.  Words are
carried in int64 and masked with ``0xFFFFFFFF`` after every add and left
shift, so that no op relies on ``torch.uint32`` arithmetic or on an
arithmetic right shift of a signed type; the same ops run on the CPU and on
the card.  Every function runs on its key's device.  The key functions
(``threefry2x32``, ``fold_in``, ``split``) also take numpy int64 keys, with
the same bits: a serving engine advances its per-row key chains on the host
that way, where a split of a few keys costs far less than on the card.
Seeds follow ``jax.random.PRNGKey`` with 64-bit types off: the seed wraps to
32 bits, ``key = (0, seed mod 2**32)``.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds: key words ``k0, k1`` and
    counter words ``x0, x1`` (int64 tensors or arrays of uint32 values,
    broadcast against each other) -> the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` -> a ``(2,)`` int64 key on ``device``."""
    seed = int(np.int64(seed))         # the reference's int64 conversion
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _words(key):
    if tuple(key.shape[-1:]) != (2,):
        raise ValueError(f"a key has shape (..., 2), got {tuple(key.shape)}")
    return key[..., 0], key[..., 1]


def _stack_words(key, y0, y1):
    if isinstance(key, np.ndarray):
        return np.stack(np.broadcast_arrays(y0, y1), axis=-1)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in``: ``key (..., 2)`` and ``data`` (an int, or
    integers broadcast against ``key[..., 0]``, taken mod 2**32) -> a new
    key (the cipher of the counter ``(0, data)``)."""
    k0, k1 = _words(key)
    if isinstance(key, np.ndarray):
        d = np.asarray(data).astype(np.int64) & MASK
    else:
        d = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    y0, y1 = threefry2x32(k0, k1, d * 0, d)
    return _stack_words(key, y0, y1)


def split(key, num: int = 2):
    """``jax.random.split``: ``key (..., 2)`` -> ``(..., num, 2)``; key ``i``
    is the cipher of the counter ``(0, i)``."""
    k0, k1 = _words(key)
    if isinstance(key, np.ndarray):
        i = np.arange(num, dtype=np.int64)
    else:
        i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], i * 0, i)
    return _stack_words(key, y0, y1)


def random_bits_u32(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: ``key (..., 2)`` -> int64
    tensor ``(..., *shape)`` of uint32 values.  Element ``n`` (row-major
    index) is ``y0 ^ y1`` of the cipher of the counter ``(n >> 32, n &
    0xFFFFFFFF)``."""
    shape = tuple(int(s) for s in shape)
    k0, k1 = _words(key)
    lead = k0.shape
    n = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                     device=key.device)
    k0 = k0.reshape(*lead, 1)
    k1 = k1.reshape(*lead, 1)
    y0, y1 = threefry2x32(k0, k1, n >> 32, n & MASK)
    return (y0 ^ y1).reshape(*lead, *shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits of each word as
    the mantissa of a float in ``[1, 2)``, minus 1, times ``maxval -
    minval`` (rounded to float32), plus ``minval``, clamped below at
    ``minval``.  XLA fuses the multiply-add into one FMA, a single
    rounding; the product of two float32 values is exact in float64, so
    the float64 multiply-add rounded once to float32 gives the same float
    (two roundings only where the float64 sum falls exactly halfway)."""
    bits = random_bits_u32(key, shape)
    f = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    # float32 constants held as Python floats (exact): no host-to-device copy
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    # float64: the reference's exact uniform (see above)
    return torch.clamp_min((f.double() * span + lo).float(), lo)  # kanlint: ignore[KL103]


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (mode ``"low"``) in float32:
    ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, one key
    per row: ``key (..., 2)``, ``logits (..., V)`` float32 -> ``(...,)``
    int64, the argmax (first index on ties) of ``logits + gumbel(key, (V,))``."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical takes float32 logits, got {logits.dtype}")
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)


def randint(key, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32, scalar
    bounds within int32) -> an int32 tensor on the key's device, the same
    integers.

    As in ``jax.random``: two 32-bit draws from the two keys of
    ``split(key)``, ``hi`` and ``lo``; ``span = maxval - minval`` (1 when
    ``maxval <= minval``); ``multiplier = (2^16 mod span)^2 mod span``, its
    square taken in uint32 (it wraps to 0 for spans above 2^16); then
    ``minval + ((hi mod span) · multiplier + lo mod span) mod span``, the
    product and the sum wrapping at 2^32 as the reference's uint32 ops do."""
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError(f"randint takes int32 bounds, got [{minval}, {maxval})")
    key = torch.as_tensor(key)
    k1, k2 = split(key).unbind(-2)
    hi, lo = random_bits_u32(k1, shape), random_bits_u32(k2, shape)
    span = max(1, maxval - minval)
    mult = (((1 << 16) % span) ** 2 & MASK) % span
    offset = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    val = minval + offset % span                   # within int32: minval + span <= maxval
    return val.to(torch.int32)
