"""Prefix cache: hash full prompt-token blocks -> reuse their KV blocks.

The port's own copy of ``repro/serve/prefix_cache.py`` (the port imports
nothing of the JAX package).  The chained digests hash the same bytes
(int32 tokens), so both packages derive equal keys for equal prompts.

Shared prompt prefixes (system prompts, few-shot preambles) are prefilled
and stored once per *request* by the dense engine.  The paged subsystem
deduplicates them at **block granularity**: the i-th full block of a
prompt is keyed by a chained digest

``key_i = H(key_{i-1} || tokens[i*bs : (i+1)*bs])``

so a cache hit on ``key_i`` guarantees the *entire* token prefix up to
``(i+1)*bs`` matches — position-dependent KV (rotary) is safe to reuse.
Only FULL blocks are ever cached; a prompt's trailing partial block is
private to its request.

At admission the engine takes the longest chain of cached blocks, capped at
``(len - 1) // bs`` so at least the last prompt token is always recomputed
(its logits seed sampling) and so decode writes never land in a shared
block — which is what keeps copy-on-write off serving's hot path
(DESIGN.md §3b).  ``prefill_into_pages`` then computes only the uncached
suffix.

Eviction is LRU over cache entries whose block the pool reports as
*cache-only* (refcount 1): entries whose block is still mapped by a live
request are skipped, and the map entry is removed in the same step the
pool reference drops — a freed-then-reallocated block can never serve a
stale hit.

Host-side Python only, like ``serve/kv_pool.py``; bit-identity of reuse is
the engine's contract (reused blocks hold exactly the KV the dense path
would recompute — tested), while this module guarantees *which* reuse is
legal.  Int8 KV-quantized caches disable prefix reuse (the engine forces
``start = 0``): dense prefill attends raw K/V while reused blocks could
only supply dequantized values, which would break bit-identity with solo
``generate``.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np


def _digest(parent: bytes, tokens: np.ndarray) -> bytes:
    h = hashlib.sha1(parent)
    h.update(np.ascontiguousarray(tokens, dtype=np.int32).tobytes())
    return h.digest()


def block_keys(tokens: np.ndarray, block_size: int) -> list[bytes]:
    """Chained digests of every FULL block of ``tokens``."""
    keys, parent = [], b"root"
    for i in range(len(tokens) // block_size):
        parent = _digest(parent, tokens[i * block_size:(i + 1) * block_size])
        keys.append(parent)
    return keys


class PrefixCache:
    def __init__(self, block_size: int):
        assert block_size >= 1
        self.block_size = block_size
        # insertion-ordered: front = least recently used (touch moves to
        # the back), so eviction scans from the front instead of sorting
        self._map: OrderedDict[bytes, int] = OrderedDict()  # key -> block id
        self._key_of: dict[int, bytes] = {}       # block id -> chained key
        self.lookups = 0                          # admissions probed
        self.hit_blocks = 0                       # probed blocks, present
        self.miss_blocks = 0                      # probed blocks, absent
        self.n_evictions = 0

    def __len__(self) -> int:
        return len(self._map)

    def _touch(self, key: bytes) -> None:
        self._map.move_to_end(key)

    # ------------------------------ lookup ----------------------------------

    def match(
        self, tokens: np.ndarray, keys: list[bytes] | None = None
    ) -> tuple[int, list[int], list[bytes]]:
        """Longest reusable prefix of ``tokens`` at admission.

        Returns ``(n_hit, blocks, keys)``: the first ``n_hit`` chained keys
        were found (their physical ``blocks`` can be shared), capped at
        ``(len(tokens) - 1) // block_size`` so the last prompt token is
        always recomputed; ``keys`` is the FULL key chain (hit or not) so
        the caller can register the blocks it goes on to compute.

        ``match`` records NO hit/miss statistics — a block-starved
        admission defers and re-probes every serve-loop iteration, and
        counting each retry would inflate the exported hit rate exactly in
        the pool-pressure regimes it is meant to describe.  Callers invoke
        :meth:`record_admission` once per admission that actually binds.
        (Matched keys are still LRU-touched: a deferred request's blocks
        staying warm is the desired eviction behavior.)

        ``keys`` (optional): a previously computed chain for these exact
        tokens — deferred admissions re-probe every serve-loop iteration,
        and the chain is immutable per prompt, so callers memoize it
        instead of re-hashing O(prompt) sha1 per retry.
        """
        if keys is None:
            keys = block_keys(tokens, self.block_size)
        cap = max((len(tokens) - 1) // self.block_size, 0)
        blocks: list[int] = []
        for key in keys[:cap]:
            if key not in self._map:
                break
            blocks.append(self._map[key])
            self._touch(key)
        return len(blocks), blocks, keys

    def record_admission(self, n_hit: int, n_tokens: int) -> None:
        """Count one *bound* admission's probe outcome: ``n_hit`` blocks
        served from cache; only blocks actually probed count toward the
        rate (the chain stops at the first miss, and keys beyond the reuse
        cap are never consulted)."""
        cap = max((n_tokens - 1) // self.block_size, 0)
        self.lookups += 1
        self.hit_blocks += n_hit
        self.miss_blocks += 1 if n_hit < cap else 0

    # ---------------------------- registration ------------------------------

    def insert(self, key: bytes, block: int) -> bool:
        """Register ``key -> block`` (skipped if the key is already cached
        — first writer wins, later identical blocks are duplicates the
        *next* admission will avoid).  Returns True when registered; the
        caller then takes a pool ``cache_ref`` on the block."""
        if key in self._map:
            return False
        assert block not in self._key_of, (
            f"block {block} already registered under another key"
        )
        self._map[key] = block
        self._key_of[block] = key
        self._touch(key)
        return True

    def holds(self, block: int) -> bool:
        return block in self._key_of

    # ------------------------------ eviction --------------------------------

    def evict_lru(self, pool) -> int | None:
        """Evict the least-recently-used entry whose block the pool reports
        as cache-only (sole reference), dropping the pool's cache reference
        in the same step.  Returns the freed block id, or None when nothing
        is evictable (every cached block is still mapped by a live
        request).  The map iterates in LRU order (``_touch`` moves entries
        to the back), so this is a front scan, not a sort."""
        for key in self._map:            # front = LRU
            block = self._map[key]
            if pool.cache_only(block):
                del self._map[key]
                del self._key_of[block]
                freed = pool.cache_unref(block)
                assert freed, "cache-only block failed to free"
                self.n_evictions += 1
                return block
        return None

    def flush(self, pool) -> int:
        """Evict every evictable entry (drain teardown): map entries and
        pool cache references drop together, so the cache can never hand
        out a block the pool has since freed and re-allocated.  Returns how
        many blocks freed."""
        n = 0
        while self.evict_lru(pool) is not None:
            n += 1
        return n

    # ---------------------------- observability -----------------------------

    def stats(self) -> dict:
        probed = self.hit_blocks + self.miss_blocks
        return {
            "prefix_entries": len(self._map),
            "prefix_lookups": self.lookups,
            "prefix_hit_blocks": self.hit_blocks,
            "prefix_block_hit_rate": self.hit_blocks / probed if probed else 0.0,
            "prefix_evictions": self.n_evictions,
        }
