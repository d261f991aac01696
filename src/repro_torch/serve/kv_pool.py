"""Paged KV-cache block pool (host-side bookkeeping).

The port's own copy of ``repro/serve/kv_pool.py`` (the port imports nothing
of the JAX package); allocations, refcounts and counters are the
reference's, decision for decision (``tests/test_torch_paged.py``).

The dense engine preallocates a contiguous ``(slots, max_seq)`` KV row per
batch slot, so admission is capped by *worst-case* cache size: a 5-token
request strands the same HBM as a 500-token one — the memory-shaped
analogue of the paper's idle-PE problem.  Paged serving (DESIGN.md §3b)
carves the preallocated cache arrays into fixed-size *blocks*
(``pool : (n_blocks, block_size, ...)`` per attention layer, one physical
block id addressing every layer's pool, vLLM-style) and binds them to
requests on demand through per-request block tables.

This module is pure host Python — no torch.  It owns the *decision* state of
the paged subsystem, mirroring how ``serve/scheduler.py`` owns slot
decisions:

* :class:`BlockPool` — free list, per-block reference counts, per-request
  block ownership, copy-on-write forks, and the ``blocks_in_use`` watermark
  the benchmark reports.  Physical block 0 is **reserved as the sentinel**:
  empty table entries point at it, and device-side writes that fall outside
  a row's coverage are redirected into it (a trash block whose contents are
  never attendable — the causal mask annihilates them).
* block-count helpers (:func:`blocks_for`, :func:`worst_case_blocks`) shared
  by engine admission validation and tests.

Reference-count convention: a block's refcount is the number of *requests*
whose table currently maps it, plus one if the prefix cache
(``serve/prefix_cache.py``) holds it.  A block returns to the free list
exactly when its refcount reaches zero; after a full drain + cache flush,
``free + 0 == usable`` (asserted by :meth:`check_balanced`, property-tested
in ``tests/test_torch_paged.py`` / ``tests/test_torch_continuous.py``).
"""

from __future__ import annotations

SENTINEL = 0   # physical block 0: reserved trash target, never allocated


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to cover ``n_tokens`` cache positions."""
    assert n_tokens >= 0 and block_size >= 1
    return -(-n_tokens // block_size)


def worst_case_blocks(
    prompt_len: int, max_new: int, chunk_steps: int, block_size: int,
    max_seq: int, spec_k: int = 0,
) -> int:
    """Upper bound on blocks a single request can ever hold.

    Decode chunks advance a live row's position by the full ``chunk_steps``
    even on its final chunk (the scan is fixed-shape; surplus emissions are
    dropped host-side), so the highest written position is
    ``prompt_len + ceil((max_new - 1) / chunk_steps) * chunk_steps - 1`` —
    clamped to ``max_seq`` because out-of-range writes are redirected to the
    sentinel block.  Engine admission validates every request against this
    bound so a single request can always run on an otherwise-empty pool
    (preemption can then always make progress).

    Speculative mode (``spec_k >= 1``) does NOT share the chunk bound: a
    verify window starting at the last live position (``prompt_len +
    max_new - 2``, just before the final emission) writes ``spec_k`` draft
    positions past it, and coverage is trimmed back only *after* the
    window.  The supremum written position is therefore
    ``prompt_len + max_new - 1 + spec_k`` (again clamped to ``max_seq``).
    """
    if spec_k >= 1:
        hi = min(prompt_len + max_new - 1 + spec_k, max_seq)
        return blocks_for(hi, block_size)
    n_chunks = blocks_for(max(max_new - 1, 0), chunk_steps)  # ceil-div
    hi = min(prompt_len + n_chunks * chunk_steps, max_seq)
    return blocks_for(hi, block_size)


class BlockPool:
    """Fixed-size physical block allocator with refcounts and CoW."""

    def __init__(self, n_blocks: int, block_size: int):
        assert n_blocks >= 2, "need at least the sentinel + one usable block"
        assert block_size >= 1
        self.n_blocks = n_blocks
        self.block_size = block_size
        # LIFO free list: recently freed blocks are re-used first (their
        # pool pages are warm); block 0 is never in it.
        self._free = list(range(n_blocks - 1, 0, -1))
        self._ref = [0] * n_blocks
        self._owned: dict[int, list[int]] = {}   # request id -> blocks, in
                                                 # logical order
        self._cache_held: set[int] = set()       # blocks the prefix cache refs
        self.watermark = 0                        # max blocks ever in use
        self.n_allocs = 0
        self.n_cow = 0

    # ------------------------------ queries --------------------------------

    @property
    def usable(self) -> int:
        return self.n_blocks - 1                  # minus the sentinel

    def free_count(self) -> int:
        return len(self._free)

    def in_use(self) -> int:
        return self.usable - len(self._free)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def owned_blocks(self, rid: int) -> list[int]:
        return list(self._owned.get(rid, ()))

    # ---------------------------- allocation -------------------------------

    def alloc(self, rid: int, n: int) -> list[int]:
        """Allocate ``n`` fresh blocks (refcount 1 each) onto ``rid``'s
        table.  Callers must check :meth:`free_count` (and evict / preempt)
        first — an insufficient pool raises."""
        if n > len(self._free):
            raise MemoryError(
                f"pool exhausted: request {rid} needs {n} blocks, "
                f"{len(self._free)} free of {self.usable} usable"
            )
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            assert self._ref[b] == 0
            self._ref[b] = 1
        self._owned.setdefault(rid, []).extend(out)
        self.n_allocs += n
        self.watermark = max(self.watermark, self.in_use())
        return out

    def share(self, rid: int, blocks: list[int]) -> None:
        """Append already-live ``blocks`` (a prefix-cache hit) to ``rid``'s
        table, bumping each refcount.  Must precede any :meth:`alloc` for
        ``rid`` — shared prefix blocks sit at the front of the table."""
        assert rid not in self._owned, f"request {rid} already holds blocks"
        for b in blocks:
            assert b != SENTINEL and self._ref[b] > 0, (
                f"block {b} is not live (ref={self._ref[b]})"
            )
            self._ref[b] += 1
        self._owned[rid] = list(blocks)

    def release_request(self, rid: int) -> list[int]:
        """Drop ``rid``'s reference on every block it holds (retirement or
        preemption).  Returns the blocks that actually became free; blocks
        also held by the prefix cache (or by other requests' tables) stay
        live."""
        freed = []
        for b in self._owned.pop(rid, ()):  # noqa: B020
            self._ref[b] -= 1
            assert self._ref[b] >= 0
            if self._ref[b] == 0:
                self._free.append(b)
                freed.append(b)
        return freed

    def trim_request(self, rid: int, keep: int) -> list[int]:
        """Roll back ``rid``'s table to its first ``keep`` blocks, releasing
        the tail (speculative rejection: the verify window over-covered
        positions the accepted prefix never reached — DESIGN.md §9).

        The tail is always *request-exclusive fresh* blocks, never shared
        prefix: admission caps prefix reuse at ``(len - 1) // block_size``
        full blocks, so the shared-block count is at most
        ``blocks_for(prompt_len)``, and the engine only trims to
        ``keep = blocks_for(pos')`` with ``pos' >= prompt_len`` — shared
        blocks all sit at table indices ``< keep``.  Asserted below: a
        trimmed block must be exclusively ours (refcount drops to zero, the
        block frees immediately — rollback needs no CoW and no device copy;
        the garbage KV inside is unreachable once the table entry is gone).
        Returns the freed blocks.
        """
        table = self._owned.get(rid, [])
        assert 0 <= keep <= len(table), (rid, keep, len(table))
        freed = []
        for b in table[keep:]:
            assert b != SENTINEL and b not in self._cache_held, (
                f"trim would release shared/cached block {b} of request {rid}"
            )
            self._ref[b] -= 1
            assert self._ref[b] == 0, (
                f"trimmed block {b} still referenced (ref={self._ref[b]})"
            )
            self._free.append(b)
            freed.append(b)
        del table[keep:]
        if not table:
            self._owned.pop(rid, None)
        return freed

    # --------------------------- prefix-cache refs -------------------------

    def cache_ref(self, block: int) -> None:
        assert block != SENTINEL and self._ref[block] > 0
        assert block not in self._cache_held, f"block {block} double-cached"
        self._ref[block] += 1
        self._cache_held.add(block)

    def cache_unref(self, block: int) -> bool:
        """Drop the prefix cache's reference; True if the block freed."""
        assert block in self._cache_held
        self._cache_held.remove(block)
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)
            return True
        return False

    def cache_only(self, block: int) -> bool:
        """True when the prefix cache is the block's sole holder — the
        eviction candidates."""
        return block in self._cache_held and self._ref[block] == 1

    # ------------------------------- CoW ------------------------------------

    def copy_on_write(self, rid: int, logical: int) -> tuple[int, int] | None:
        """Make ``rid``'s ``logical``-th block exclusively writable.

        If the block is shared (refcount > 1 — other tables and/or the
        prefix cache still map it), allocate a fresh block, swap it into
        ``rid``'s table, and return ``(src, dst)`` so the caller can run
        the device-side block copy (``lm.copy_paged_block``).  Returns
        ``None`` when the block is already exclusive (no copy needed).

        The serving engine's admission policy (cap prefix reuse at
        ``(len-1) // block_size`` full blocks) keeps decode writes out of
        shared blocks, so serving never hits this path today; it is the
        primitive a fork/beam-search frontend needs (DESIGN.md §3b).
        """
        table = self._owned[rid]
        src = table[logical]
        assert src != SENTINEL and self._ref[src] >= 1
        if self._ref[src] == 1:
            return None
        if not self._free:
            raise MemoryError(f"pool exhausted during CoW for request {rid}")
        dst = self._free.pop()
        assert self._ref[dst] == 0
        self._ref[dst] = 1
        self._ref[src] -= 1
        table[logical] = dst
        self.n_cow += 1
        self.watermark = max(self.watermark, self.in_use())
        return src, dst

    # ---------------------------- observability -----------------------------

    def stats(self) -> dict:
        return {
            "pool_blocks": self.n_blocks,
            "block_size": self.block_size,
            "blocks_in_use": self.in_use(),
            "blocks_in_use_watermark": self.watermark,
            "blocks_cache_held": len(self._cache_held),
            "n_block_allocs": self.n_allocs,
            "n_cow_copies": self.n_cow,
        }

    def check_balanced(self, n_live_requests: int = 0) -> None:
        """Pool invariants: every block is free xor referenced, the free
        list carries no duplicates, and with no live requests every in-use
        block is held by the prefix cache alone (refcount exactly 1)."""
        assert len(set(self._free)) == len(self._free), "free-list duplicate"
        assert SENTINEL not in self._free, "sentinel escaped into free list"
        free = set(self._free)
        for b in range(1, self.n_blocks):
            if b in free:
                assert self._ref[b] == 0, f"free block {b} has refs"
            else:
                assert self._ref[b] > 0, f"leaked block {b} (no refs, not free)"
        if n_live_requests == 0:
            assert not self._owned, f"stale ownership: {sorted(self._owned)}"
            for b in range(1, self.n_blocks):
                if b not in free:
                    assert b in self._cache_held and self._ref[b] == 1, (
                        f"block {b} in use with no owner (ref={self._ref[b]})"
                    )
        # NOTE: cache references are dropped via PrefixCache.evict_lru /
        # PrefixCache.flush ONLY — map entries and pool refs must fall
        # together, or a freed-then-reallocated block could serve a stale
        # prefix hit.
