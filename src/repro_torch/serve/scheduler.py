"""Slot-level continuous-batching scheduler (host-side bookkeeping).

The port's own copy of ``repro/serve/scheduler.py`` (the port imports
nothing of the JAX package): the same classes, decisions and counters, so
the two engines schedule a workload identically
(``tests/test_torch_paged.py`` and ``tests/test_torch_speculative.py``
drive both through the same operation sequences).

The software analogue of the paper's idle-PE problem: a static batch keeps
decoding into dead rows until the whole bucket drains, exactly like a
systolic array clocking zeros through unused PEs.  Continuous batching
keeps every batch row ("slot") busy: when a request finishes (EOS or token
budget), its slot is retired and the next queued request is admitted at the
following chunk boundary.

This module is pure host-side Python — no torch.  The :class:`Engine` owns
the device state (KV caches, positions, PRNG keys, EOS latches); the
scheduler owns the *decision* state:

* :class:`SlotTable` — per-slot ``{request_id, pos, remaining, eos_hit}``
  mirroring the device arrays, plus occupancy;
* :class:`AdmissionQueue` — FIFO of waiting requests;
* :class:`ContinuousScheduler` — admission + retirement policy and the
  utilization accounting the serving benchmark reports.

Invariants (asserted by :meth:`ContinuousScheduler.check_invariants` and
exercised by ``tests/test_torch_continuous.py``): a request occupies at
most one slot, a slot holds at most one live request, every submitted
request is eventually served exactly once, and all slots are free once the
queue and table drain.
"""

from __future__ import annotations

import dataclasses
from collections import deque


@dataclasses.dataclass
class Slot:
    """One batch row of the live decode batch.

    ``eos_hit=True`` doubles as "this row is dead": empty slots and retired
    slots are latched so the device-side scan masks their emissions to
    ``pad_id`` and freezes their position.
    """

    request_id: int = -1
    pos: int = 0           # next cache write position (== tokens in cache)
    remaining: int = 0     # decode tokens still owed (first token is paid
                           # for by prefill, so this starts at max_new - 1)
    eos_hit: bool = True   # latched: empty, finished, or EOS'd
    useful_steps: int = 0  # token-steps credited to THIS occupancy — rolled
                           # back if the request is preempted (its emitted
                           # tokens are discarded and re-generated)

    @property
    def occupied(self) -> bool:
        return self.request_id >= 0


class SlotTable:
    def __init__(self, n_slots: int):
        assert n_slots >= 1
        self.slots = [Slot() for _ in range(n_slots)]

    def __len__(self) -> int:
        return len(self.slots)

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if not s.occupied]

    def occupied_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.occupied]

    def live_slots(self) -> list[int]:
        """Occupied AND not latched — rows that still produce real tokens."""
        return [i for i, s in enumerate(self.slots)
                if s.occupied and not s.eos_hit]

    def admit(self, slot: int, request_id: int, pos: int, remaining: int,
              eos_hit: bool = False) -> None:
        s = self.slots[slot]
        assert not s.occupied, f"slot {slot} already holds request {s.request_id}"
        assert request_id >= 0 and pos >= 0 and remaining >= 0
        self.slots[slot] = Slot(request_id, pos, remaining, eos_hit)

    def retire(self, slot: int) -> int:
        """Free the slot, returning the request id it held."""
        s = self.slots[slot]
        assert s.occupied, f"slot {slot} is already free"
        rid = s.request_id
        self.slots[slot] = Slot()
        return rid


class AdmissionQueue:
    """FIFO of request ids waiting for a slot."""

    def __init__(self, request_ids=()):
        self._q: deque[int] = deque(request_ids)

    def push(self, request_id: int) -> None:
        self._q.append(request_id)

    def push_front(self, request_id: int) -> None:
        """Head-of-queue insert: a preempted request re-admits before any
        newer arrivals, so preemption can't starve it (FIFO fairness up to
        the preemption itself)."""
        self._q.appendleft(request_id)

    def pop(self) -> int:
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


class ContinuousScheduler:
    """Admission + retirement policy over a :class:`SlotTable`.

    The engine calls, per iteration of its serve loop:

    1. ``admit_ready()`` — every admissible ``(slot, request_id)`` pair in
       one burst (ONE grouped prefill dispatch); then ``confirm_admit(...)``
       per pair with the device-side facts (start position, budget, whether
       the very first token already hit EOS);
    2. run one fixed-shape decode chunk;
    3. ``complete_chunk(chunk_steps, eos_hits)`` — advance per-slot
       bookkeeping, collect ``(slot, request_id, n_kept)`` for every slot,
       and retire finished ones.
    """

    def __init__(self, n_slots: int, request_ids=()):
        self.table = SlotTable(n_slots)
        self.queue = AdmissionQueue(request_ids)
        self.n_submitted = len(self.queue)
        self.served: list[int] = []
        # utilization accounting: a token-step is one slot x one decode step
        self.useful_token_steps = 0
        self.total_token_steps = 0
        self.chunks_run = 0
        # admission recency, for the paged engine's preempt-youngest policy
        self._admit_seq = 0
        self._slot_admit_seq = [0] * n_slots
        self.n_preemptions = 0

    # ------------------------------ admission ------------------------------

    def admit_ready(self) -> list[tuple[int, int]]:
        """All (slot, request_id) pairs admissible right now — distinct free
        slots zipped with queue pops, so one burst of retirements can be
        refilled by ONE grouped prefill dispatch.  Callers must
        ``confirm_admit`` every returned pair before asking again."""
        out: list[tuple[int, int]] = []
        for slot in self.table.free_slots():
            if not self.queue:
                break
            out.append((slot, self.queue.pop()))
        return out

    def confirm_admit(self, slot: int, request_id: int, pos: int,
                      remaining: int, eos_hit: bool) -> bool:
        """Record an admitted request; returns True if it is already done
        (budget of one token, or the first token was EOS) — the engine then
        calls :meth:`retire` immediately and the slot is reused without ever
        entering a chunk."""
        done = eos_hit or remaining == 0
        self.table.admit(slot, request_id, pos, remaining, eos_hit=done)
        self._admit_seq += 1
        self._slot_admit_seq[slot] = self._admit_seq
        return done

    def retire(self, slot: int) -> int:
        rid = self.table.retire(slot)
        self.served.append(rid)
        return rid

    # ------------------------------ preemption -----------------------------

    def youngest_live_slot(self) -> int | None:
        """The live slot admitted most recently — the paged engine's
        preemption victim on pool exhaustion (preempting the youngest
        wastes the least completed work and lets older requests drain,
        guaranteeing progress)."""
        live = self.table.live_slots()
        if not live:
            return None
        return max(live, key=lambda b: self._slot_admit_seq[b])

    def preempt(self, slot: int) -> int:
        """Evict a live request from its slot and push it back to the HEAD
        of the admission queue.  Its re-admission restarts generation from
        scratch (preemption-with-recompute): generation is a deterministic
        function of (request id, seed, prompt), so the regenerated stream —
        and therefore the final output — is bit-identical to the
        never-preempted run.  The caller discards the request's partial
        output buffer and frees its cache blocks."""
        s = self.table.slots[slot]
        assert s.occupied and not s.eos_hit, f"slot {slot} not preemptible"
        # the discarded tokens get re-generated and re-counted on the
        # re-run, so their token-steps become waste, not useful work —
        # without this rollback any preempting run inflates utilization
        self.useful_token_steps -= s.useful_steps
        rid = self.table.retire(slot)
        self.queue.push_front(rid)
        self.n_preemptions += 1
        return rid

    # ------------------------------- chunks --------------------------------

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.table.occupied_slots())

    def can_run_chunk(self) -> bool:
        return bool(self.table.live_slots())

    def complete_chunk(
        self, chunk_steps: int, eos_hits, eos_steps=None
    ) -> list[tuple[int, int, int, bool]]:
        """Account for one finished decode chunk.

        ``eos_hits[b]``: the device EOS latch for slot *b* at chunk end.
        ``eos_steps[b]`` (optional): the in-chunk step index of slot *b*'s
        first EOS emission (``chunk_steps`` if none) — post-EOS pad
        emissions inside the finishing chunk then count as *waste*, not
        useful token-steps, so ``mean_slot_utilization`` stays honest under
        EOS early-exit.  Returns ``(slot, request_id, n_keep, finished)``
        per occupied slot: the engine keeps the first ``n_keep`` of the
        chunk's emitted tokens for that request, and retires the slot if
        ``finished``.
        """
        out: list[tuple[int, int, int, bool]] = []
        self.chunks_run += 1
        self.total_token_steps += chunk_steps * len(self.table)
        for b in self.table.occupied_slots():
            s = self.table.slots[b]
            n_keep = min(chunk_steps, s.remaining)
            hit = bool(eos_hits[b])
            s.remaining -= n_keep
            s.pos += n_keep          # host mirror; device froze latched rows
            s.eos_hit = s.eos_hit or hit
            useful = n_keep
            if eos_steps is not None:
                useful = min(useful, int(eos_steps[b]) + 1)
            self.useful_token_steps += useful
            s.useful_steps += useful
            finished = hit or s.remaining == 0
            out.append((b, s.request_id, n_keep, finished))
        return out

    def complete_spec_window(
        self, window_steps: int, emitted_counts, eos_hits, eos_steps=None
    ) -> list[tuple[int, int, int, bool]]:
        """Account for one finished speculative window (DESIGN.md §9).

        Unlike :meth:`complete_chunk`, where every live slot advances by
        exactly ``chunk_steps``, a verify window emits a variable number of
        tokens per row: ``emitted_counts[b]`` is the device's accepted count
        ``m`` (matched drafts + the bonus token, cut at an in-window EOS; 0
        for latched rows).  A row keeps ``min(m, remaining)`` of them: the
        window can overshoot the budget on its last emission, and the host
        clamp retires the row.  ``total_token_steps`` charges the full
        ``window_steps = k + 1`` per slot, so rejected drafts count as waste
        in ``mean_slot_utilization``, comparable across spec and non-spec
        runs.  ``eos_steps`` as in :meth:`complete_chunk`.  Returns
        ``(slot, request_id, n_keep, finished)`` per occupied slot.
        """
        out: list[tuple[int, int, int, bool]] = []
        self.chunks_run += 1
        self.total_token_steps += window_steps * len(self.table)
        for b in self.table.occupied_slots():
            s = self.table.slots[b]
            n_keep = min(int(emitted_counts[b]), s.remaining)
            hit = bool(eos_hits[b])
            s.remaining -= n_keep
            s.pos += n_keep
            s.eos_hit = s.eos_hit or hit
            useful = n_keep
            if eos_steps is not None:
                useful = min(useful, int(eos_steps[b]) + 1)
            self.useful_token_steps += useful
            s.useful_steps += useful
            finished = hit or s.remaining == 0
            out.append((b, s.request_id, n_keep, finished))
        return out

    # ---------------------------- observability ----------------------------

    def mean_slot_utilization(self) -> float:
        """Fraction of slot x step capacity that produced kept tokens."""
        if self.total_token_steps == 0:
            return 1.0 if not self.n_submitted else 0.0
        return self.useful_token_steps / self.total_token_steps

    def stats(self) -> dict:
        return {
            "n_submitted": self.n_submitted,
            "n_served": len(self.served),
            "chunks_run": self.chunks_run,
            "useful_token_steps": self.useful_token_steps,
            "total_token_steps": self.total_token_steps,
            "mean_slot_utilization": self.mean_slot_utilization(),
            "n_preemptions": self.n_preemptions,
        }

    def check_invariants(self) -> None:
        rids = [s.request_id for s in self.table.slots if s.occupied]
        assert len(rids) == len(set(rids)), f"request in two slots: {rids}"
        assert not (set(rids) & set(self.served)), "served request still slotted"
        if not self.has_work():
            assert len(self.table.free_slots()) == len(self.table), "slot leak"
            assert sorted(self.served) == sorted(set(self.served)), (
                "request served twice"
            )
            assert len(self.served) == self.n_submitted, (
                f"served {len(self.served)} of {self.n_submitted}"
            )
