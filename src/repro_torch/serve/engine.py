"""Serving engines (counterpart of ``repro/serve/engine.py``).

Two serving entry points share one decode loop
(:meth:`Engine._decode_chunk`, a Python loop of ``lm.decode_step`` calls;
CUDA graphs come later):

* ``serve_requests``: static bucketing.  ``Engine.generate`` prefills a
  batch and decodes it to the end; requests are sorted by length into fixed
  batches, short batches padded with copies of their last request;
* ``serve_continuous``: continuous batching.  A slot table
  (``serve/scheduler.py``) runs fixed-length decode chunks over ``slots``
  rows and swaps finished rows for queued requests between chunks
  (``lm.prefill_into_slots`` prefills an admission group and splices its KV
  into the live rows).  With ``ServeConfig.paged`` the per-slot rows become
  a block pool with per-request block tables (``serve/kv_pool.py``),
  prefix caching (``serve/prefix_cache.py``) and preemption with recompute
  (DESIGN.md §3b); the decode chunk then reads the pool through the
  block-table gather kernel, once per chunk (``paged_read="shadow"``) or
  every step (``"step"``).  With ``ServeConfig.spec_k >= 1`` each decode
  chunk becomes a speculative window (``serve/speculative.py``): a drafter
  proposes ``spec_k`` tokens, one target pass verifies them.

Padding is right-padding with per-row ``lengths``: real tokens sit at
positions ``0..len-1``, each row takes its first token from the logits at
its own last real position, and decode starts ragged at ``pos_b = len_b``,
overwriting the pad K/V in the cache before the mask ``kv_slot <= pos_b``
can expose it.  Without ``lengths`` and with EOS off, ``generate`` uses one
scalar position for every row.

Sampling is per row, as the reference's: at ``temperature > 0`` each row's
threefry key chain is ``fold_in(PRNGKey(seed), request_id)`` split once per
emitted token (``serve/threefry.py``), never its batch position, and each
token is that row's ``categorical`` draw (``speculative.sample_tokens``).
The chains are integer hashes that never depend on a token, so the engine
keeps them on the host: a chunk's step keys are split before its first step
and uploaded in the same transfer as its other per-slot state, and the
Gumbel noise of its steps is drawn on the device in one pass per
``NOISE_STEPS`` steps; a speculative window resumes each chain after its
``m`` emissions.  A request recomputed after a preemption re-derives its
chain from its id and draws the same stream.  At ``temperature <= 0``
decoding is greedy (argmax) and no chain is split.

EOS (``eos_id >= 0``) latches per row: the EOS token is emitted, every
later step of that row emits ``pad_id`` and its position freezes.  A
request's output, greedy or sampled, is the same whether it is served alone
by ``generate``, in a static bucket or by either continuous engine.

Caveat, as the reference's: ragged decode into windowed (ring-buffer)
layers can attend stale pad slots once a row's position wraps the window
(a right-padded prompt longer than the window leaves pad K/V in the ring);
full-attention models are exactly pad-invariant.  SSM and LSTM states
(zamba2's Mamba2 layers, xlstm's mLSTM and sLSTM) are not pad-invariant
under any padding: a right-padded prompt feeds its pads through the
recurrence, in a ragged ``serve_requests`` bucket as in a
``serve_continuous`` admission padded to ``prompt_pad_multiple``.  The
port serves the JAX engine's streams there, not repaired ones.
Equal-length buckets avoid padding.

Prompts are tokens.  A model with non-token inputs (paligemma-3b's patch
prefix, musicgen-large's frames) is refused, as the reference's engine
cannot serve one either (it prefills ``{"tokens": ...}`` and dies with a
``KeyError``); such models run through ``lm.prefill`` and
``lm.decode_step``.

Mesh serving (``ServeConfig.mesh``, DESIGN.md §4a): a ``(data, model)``
``DeviceMesh`` (``launch/mesh.py``) over one process per rank, each running
this engine on the same inputs.  The engine places the parameters once
(each rank keeps its shard, ``dist/sharding.py``), builds cache shards
(dense rows on ``data``, and KV heads or an MLA latent's ``kv_lora``
columns on ``model``; a pool's blocks on ``data`` where the data axis
divides their count), and threads a
``ShardingCtx`` through every model call, which returns logits whole on
every rank.  So every rank samples the same tokens and its host
bookkeeping (scheduler, ``BlockPool``, ``PrefixCache``) makes the same
decisions; the two reads that drive them (an admission group's first
tokens, a chunk's tokens) take rank 0's copy.  The host bookkeeping never
sees device counts.  On one rank the mesh runs the unmeshed operations,
so its streams are bit-identical; across ranks the streams equal the
unmeshed engine's unless a near-tie flips, since the row-parallel
``all_reduce`` sums fp32 partials in another order, as the reference
documents.  A mesh serves token-input ``attn_kan``/``attn_mlp``/``attn_moe`` models
of full attention, GQA or MLA (deepseek-v2-lite, on the static and dense
continuous paths that it takes unmeshed), without speculative windows
(``lm.mesh_refusal``); recurrent, windowed and non-token models are
refused (ROADMAP queue 1, item 9.4.2).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import set_ieee_fp32
from repro_torch.dist.sharding import ShardingCtx
from repro_torch.models import lm
from repro_torch.serve import speculative, threefry
from repro_torch.serve.kv_pool import BlockPool, blocks_for, worst_case_blocks
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import ContinuousScheduler

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# decode steps whose Gumbel noise one batched draw makes
NOISE_STEPS = 8


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 512
    max_new_tokens: int = 64
    temperature: float = 0.0
    eos_id: int = -1             # -1: never stops early
    pad_id: int = 0              # emitted after a row latches on EOS
    compute_dtype: str = "float32"
    # Paged KV cache (DESIGN.md §3b), serve_continuous only: fixed-size
    # blocks bound to requests on demand, shared prompt prefixes stored
    # once, preempt-with-recompute when the pool runs out.  Same outputs as
    # the dense cache.
    paged: bool = False
    block_size: int = 16         # must divide max_seq
    pool_blocks: int | None = None   # physical blocks incl. the sentinel;
                                     # None -> slots·(max_seq/block_size)+1
    prefix_caching: bool = True  # off under an int8 KV cache: reused blocks
                                 # could give prefill only dequantised K/V,
                                 # and paged prefill then starts at 0
    # "shadow": gather the dense view once per chunk, decode on it, write
    # the chunk's span back; "step": read and write through the block
    # table every token (no transient view, one gather per layer per step)
    paged_read: str = "shadow"
    # Speculative decoding (DESIGN.md §9, serve/speculative.py),
    # serve_continuous only: a shrunken KAN drafter proposes spec_k tokens
    # per window and ONE target pass verifies all spec_k + 1 positions.
    # Streams, greedy or sampled, equal spec_k = 0's up to the kernels'
    # summation order.
    spec_k: int = 0              # drafts per window; 0 disables speculation
    draft: object | None = None  # a speculative.DraftModel; None derives one
                                 # from the target's parameters at init
    draft_layers: int = 1        # derived drafter: leading unit repeats kept
    draft_quant: bool = False    # derived drafter: int8 fake-quant weights
    # Mesh serving: a torch.distributed DeviceMesh with ("data", "model")
    # dims (launch/mesh.py: make_host_mesh), this process one of its ranks.
    # None: the single-device engine.
    mesh: object | None = None


def token_prompts_only(model_cfg: lm.ModelConfig) -> str:
    """Why the engine refuses a model with non-token inputs."""
    return (f"{model_cfg.name}: the engine serves token prompts only, and this model's "
            f"inputs are {model_cfg.input_kind!r}; the reference's engine prefills "
            "{'tokens': ...} and dies on it with a KeyError.  Run it through "
            "lm.forward, lm.prefill and lm.decode_step.")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class Engine:
    def __init__(self, params, model_cfg: lm.ModelConfig, serve_cfg: ServeConfig,
                 device="cuda"):
        lm.check_supported(model_cfg)
        if model_cfg.input_kind != "tokens":
            raise NotImplementedError(token_prompts_only(model_cfg))
        self.device = torch.device(device)
        if self.device.type == "cuda":
            set_ieee_fp32()
        self.model = model_cfg
        self.cfg = serve_cfg
        self._dt = DTYPES[serve_cfg.compute_dtype]
        if serve_cfg.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {serve_cfg.spec_k}")
        self.shard = None
        if serve_cfg.mesh is not None:
            why = lm.mesh_refusal(model_cfg)
            if why is None and serve_cfg.spec_k:
                why = ("speculative decoding on a mesh is not ported yet (ROADMAP queue 1, "
                       "item 9.4.2)")
            if why:
                raise ValueError(why)
            self.shard = ShardingCtx(serve_cfg.mesh)
            params = self.shard.place_params(model_cfg, params)
        self.params = _to_device(params, self.device)
        self.last_serve_stats: dict | None = None
        self.last_generate_stats: dict | None = None
        self.draft = None
        if serve_cfg.spec_k >= 1:
            if serve_cfg.draft is not None:
                self.draft = dataclasses.replace(
                    serve_cfg.draft, params=_to_device(serve_cfg.draft.params, self.device))
            else:                      # views of self.params: no weight copy
                self.draft = speculative.DraftModel.from_target(
                    self.params, model_cfg, n_layers=serve_cfg.draft_layers,
                    quant=serve_cfg.draft_quant)

    def _make_dense_caches(self, batch: int) -> dict:
        """The dense decode caches ``generate`` and the continuous engine
        serve from (this rank's shard on a mesh)."""
        return lm.init_caches(self.model, batch, self.cfg.max_seq, self._dt, self.device,
                              self.shard)

    def _make_paged_caches(self, n_blocks: int, block_size: int) -> dict:
        """The paged pools of the continuous engine (this rank's shard on a
        mesh)."""
        return lm.init_paged_caches(self.model, n_blocks, block_size, self._dt, self.device,
                                    self.shard)

    def _agree(self, t: torch.Tensor) -> torch.Tensor:
        """A device value the host decides on takes rank 0's copy on a mesh,
        in place (``t`` must be contiguous)."""
        return t if self.shard is None else self.shard.agree(t)

    def _sync(self) -> None:
        """Drain the stream, so a phase's host clock holds its device work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # kanlint: ignore[KL102] (the stats' clocks)

    def _validate_request(self, rid, prompt_len: int, max_new: int) -> None:
        if max_new < 1:
            raise ValueError(f"request {rid}: max_new must be >= 1, got {max_new}")
        if prompt_len < 1:
            raise ValueError(f"request {rid}: empty prompt (prompt_len={prompt_len})")
        if prompt_len + max_new > self.cfg.max_seq:
            raise ValueError(
                f"request {rid}: prompt_len {prompt_len} + max_new {max_new} "
                f"= {prompt_len + max_new} exceeds max_seq {self.cfg.max_seq}")

    # ------------------------------------------------------------------
    # per-row PRNG: key chain = fold_in(base, request_id), split per token
    # ------------------------------------------------------------------

    @property
    def _sampled(self) -> bool:
        return self.cfg.temperature > 0.0

    @staticmethod
    def _row_key_pairs(base_key: np.ndarray, request_ids) -> np.ndarray:
        """``(B,)`` request ids -> ``(B, 2, 2)`` int64 host keys: ``[:, 0]``
        the carried chain key, ``[:, 1]`` the first sampling key.  Row by
        row, so a solo call and any batched call agree bit for bit."""
        return threefry.split(threefry.fold_in(base_key, np.asarray(request_ids, np.int64)))

    def _keys_first(self, base_key: np.ndarray, request_ids, last_logits):
        """-> ``(carry keys (B, 2) on the host, first token (B,) int32 on the
        device)``: each row's key chain and its first token, from the logits
        at its last real prompt position.  One definition serves
        ``generate`` and continuous admission.  Greedy: no chain, argmax."""
        if not self._sampled:
            return None, self._sample(last_logits, None)
        pairs = self._row_key_pairs(base_key, request_ids)
        first = torch.as_tensor(pairs[:, 1], device=last_logits.device)
        return pairs[:, 0], self._sample(last_logits, first)

    def _sample(self, logits: torch.Tensor, step_keys) -> torch.Tensor:
        """``logits (B, vocab)``, ``step_keys (B, 2)``: the one sampling
        definition (``speculative.sample_tokens``) shared with the drafter
        and the verifier."""
        return speculative.sample_tokens(logits, step_keys, self.cfg.temperature)

    def _decode_chunk(self, steps: int, tok, caches, pos, eos_hit, eos: int, table=None,
                      step_keys=None, shard=None):
        """``steps`` decode steps from ``tok (B, 1)`` at ``pos`` (scalar, or
        ``(B,)`` per row); the counterpart of the reference's
        ``_scan_impl``.  ``step_keys (B, steps, 2)`` on the device: each
        step's sampling key per row (every row splits at every step, latched
        rows too), ``None`` when greedy; the Gumbel noise of ``NOISE_STEPS``
        steps is drawn at a time.  A row whose EOS latch is set emits
        ``pad_id`` and its per-row position freezes.  ``shard``: the caches'
        mesh context (``for_rows`` or ``for_pool``).  Returns ``(toks (steps,
        B), tok, caches, pos, eos_hit)``, the carry the next chunk resumes
        from."""
        pad = torch.full((), self.cfg.pad_id, dtype=torch.int32, device=tok.device)
        toks = []
        noise = None
        for s in range(steps):
            lg, caches = lm.decode_step(self.params, self.model, tok, caches, pos,
                                        self._dt, table, shard)
            if self._sampled and s % NOISE_STEPS == 0:
                noise = threefry.gumbel(step_keys[:, s:s + NOISE_STEPS],
                                        (self.model.vocab,))
            nxt = speculative.sample_with_noise(
                lg, None if noise is None else noise[:, s % NOISE_STEPS],
                self.cfg.temperature)
            emitted = torch.where(eos_hit, pad, nxt)
            if pos.dim() == 0:                # one shared position
                pos = pos + 1
            else:                             # latched rows freeze
                pos = torch.where(eos_hit, pos, pos + 1)
            eos_hit = eos_hit | (nxt == eos)
            tok = emitted[:, None]
            toks.append(emitted)
        if not toks:
            return tok.new_empty((0, tok.shape[0])), tok, caches, pos, eos_hit
        return torch.stack(toks), tok, caches, pos, eos_hit

    @torch.no_grad()
    def generate(
        self,
        prompts: np.ndarray,
        seed: int = 0,
        lengths: np.ndarray | None = None,
        request_ids: np.ndarray | None = None,
        max_new: int | None = None,
        eos_id: int | None = None,
    ) -> np.ndarray:
        """prompts: (B, T_prompt) int32 -> (B, max_new) int32.

        ``lengths`` (optional, (B,)): true prompt lengths of right-padded
        prompts; each row samples from the logits at its own last real token
        and decodes from its own start offset.  ``request_ids`` (optional,
        (B,), default ``arange(B)``) and ``seed`` key each row's sampling
        chain, ``fold_in(PRNGKey(seed), request_id)``: rows with the same id
        draw the same noise in any batch.  Greedy decoding does not read
        them.  ``max_new``/``eos_id`` override the config per call.
        """
        B, T = prompts.shape
        max_new = self.cfg.max_new_tokens if max_new is None else int(max_new)
        eos = self.cfg.eos_id if eos_id is None else int(eos_id)
        rids = (np.arange(B, dtype=np.int32) if request_ids is None
                else np.asarray(request_ids, np.int32))
        if rids.shape != (B,):
            raise ValueError(f"request_ids shape {rids.shape} != ({B},)")
        row_lens = np.full((B,), T) if lengths is None else np.asarray(lengths)
        for b in range(B):
            self._validate_request(int(rids[b]), int(row_lens[b]), max_new)
        if T > self.cfg.max_seq:
            raise ValueError(f"padded prompt length {T} exceeds max_seq {self.cfg.max_seq}")
        dev = self.device
        t0 = time.perf_counter()
        toks = torch.as_tensor(np.asarray(prompts, np.int64), device=dev)
        logits, caches = lm.prefill(self.params, self.model, toks,
                                    self.cfg.max_seq, self._dt, self.shard)
        rows = torch.arange(B, device=dev)
        if lengths is None:
            last = logits[:, T - 1]
            # one shared position for every row, unless EOS can latch rows
            # at different steps, which needs per-row frozen positions
            pos = (torch.tensor(T, dtype=torch.int64, device=dev) if eos < 0
                   else torch.full((B,), T, dtype=torch.int64, device=dev))
        else:
            lens = np.asarray(lengths, np.int64)
            if lens.shape != (B,) or lens.min() < 1 or lens.max() > T:
                raise ValueError(f"lengths {lens} must be (B,) within [1, {T}]")
            pos = torch.as_tensor(lens, device=dev)
            last = logits[rows, pos - 1]
        keys, tok = self._keys_first(threefry.prng_key(seed).numpy(), rids, last)
        step_keys = None
        if self._sampled:                     # every step's key, in one upload
            kts, _ = speculative.split_chain(keys, max_new - 1)
            step_keys = torch.as_tensor(kts, device=dev)
        self._sync()
        t1 = time.perf_counter()
        eos_hit = tok == eos                  # eos = -1 never matches
        toks, *_ = self._decode_chunk(max_new - 1, tok[:, None], caches, pos, eos_hit, eos,
                                      step_keys=step_keys,
                                      shard=self.shard and self.shard.for_rows(B))
        out = torch.cat([tok[None], toks]).T.cpu().numpy()
        t2 = time.perf_counter()
        self.last_generate_stats = {
            "rows": B, "prompt_len": T, "prefill_s": t1 - t0,
            "decode_s": t2 - t1, "decode_steps": max_new - 1,
        }
        return out

    def serve_requests(
        self, requests: list[np.ndarray], batch_size: int = 8, seed: int = 0
    ) -> list[np.ndarray]:
        """Bucket requests by length into fixed batches (padded with copies)
        and drain bucket by bucket; outputs in request order.  Each row's
        sampling chain is keyed by its request's index in ``requests`` (a
        padding copy by the index of the request it copies), so outputs,
        greedy or sampled, never depend on batch mates or padding."""
        order = sorted(range(len(requests)), key=lambda i: requests[i].shape[0])
        results: list[np.ndarray | None] = [None] * len(requests)
        t0 = time.perf_counter()
        buckets: list[dict] = []
        for start in range(0, len(order), batch_size):
            idxs = order[start:start + batch_size]
            bucket = [requests[i] for i in idxs]
            T = max(r.shape[0] for r in bucket)
            lens = np.asarray([r.shape[0] for r in bucket], np.int32)
            rids = np.asarray(idxs, np.int32)
            padded = np.stack(
                [np.pad(r, (0, T - r.shape[0]), constant_values=0) for r in bucket])
            while padded.shape[0] < batch_size:
                padded = np.concatenate([padded, padded[-1:]], axis=0)
                lens = np.concatenate([lens, lens[-1:]], axis=0)
                rids = np.concatenate([rids, rids[-1:]], axis=0)
            gen = self.generate(
                padded.astype(np.int32), seed=seed,
                lengths=None if bool((lens == T).all()) else lens,
                request_ids=rids,
            )
            for j, i in enumerate(idxs):
                results[i] = gen[j]
            buckets.append({"request_ids": idxs, "rows": int(padded.shape[0]),
                            "done_s": time.perf_counter() - t0,
                            **self.last_generate_stats})
        self.last_serve_stats = {
            "wall_s": time.perf_counter() - t0,
            "buckets": buckets,
            "request_latency_s": [
                next(b["done_s"] for b in buckets if i in b["request_ids"])
                for i in range(len(requests))
            ],
        }
        return results  # type: ignore[return-value]

    # ------------------------------------------------------------------
    # continuous batching
    # ------------------------------------------------------------------

    @torch.no_grad()
    def serve_continuous(
        self,
        requests: list[np.ndarray],
        slots: int = 8,
        chunk_steps: int = 8,
        seed: int = 0,
        max_new: int | list[int] | None = None,
        prompt_pad_multiple: int = 8,
    ) -> list[np.ndarray]:
        """Continuous batching: a ``slots``-row decode batch whose rows are
        recycled as soon as a request finishes (EOS latch or token budget).

        The loop alternates an admission prefill (queued requests grouped
        by padded prompt length, ``prompt_pad_multiple`` apart, one prefill
        per group) with a decode chunk of ``chunk_steps`` steps over all
        slots.  Between chunks the scheduler retires finished slots and
        admits from the FIFO queue.  ``max_new``: per-request (list) or
        global token budgets, default ``cfg.max_new_tokens``; each output
        has its budget's length, ``pad_id`` after EOS, and equals a solo
        :meth:`generate` of the request.

        With ``cfg.paged`` the KV cache is a block pool: a request enters a
        slot only when its prompt's blocks are free, shared prompt prefixes
        reuse cached blocks (prefill computes only the uncached suffix),
        and when the pool runs out the engine evicts LRU prefix entries,
        then preempts the youngest running request (requeued at the head,
        recomputed from scratch on re-admission).

        Sets ``self.last_serve_stats``: the scheduler's counters, wall
        time, per-request latency, useful tokens, ``mesh_shape`` (``{"data":
        d, "model": m}`` or None) and, paged, a ``"paged"`` sub-dict of pool
        and prefix counters, as the reference does (its ``compiles``
        describes JAX tracing and has no counterpart here).  The port adds ``prefill_s`` and
        ``decode_s`` (host time of admission prefills and decode chunks,
        each ending in a read of its tokens) and ``prefill_groups`` (``[rows,
        padded length]`` of each admission prefill), from which a caller
        can count the kernel launches a run implies.

        With ``cfg.spec_k >= 1`` every decode chunk is one speculative
        window: the drafter proposes ``spec_k`` tokens by decode steps on
        its own dense per-slot cache, sampling with the first ``spec_k``
        step keys of each row's chain, ONE ``lm.verify_window`` pass scores
        the ``W = spec_k + 1`` positions and samples the target there with
        the chain's ``W`` step keys, ``accept_window`` keeps the longest
        matching prefix plus the bonus token, each chain resumes after its
        ``m`` emissions, and (paged) the rows' block coverage is trimmed
        back to what the accepted prefix holds.
        The stats then carry the reference's ``"spec"`` sub-dict, and the
        port adds ``draft_prefill_groups`` (the drafter's admission prefills,
        as ``prefill_groups``).
        """
        n = len(requests)
        if max_new is None:
            budgets = [self.cfg.max_new_tokens] * n
        elif isinstance(max_new, int):
            budgets = [max_new] * n
        else:
            budgets = [int(m) for m in max_new]
            if len(budgets) != n:
                raise ValueError(f"{len(budgets)} budgets for {n} requests")
        eos, pad = self.cfg.eos_id, self.cfg.pad_id
        for rid, (r, m) in enumerate(zip(requests, budgets)):
            self._validate_request(rid, int(r.shape[0]), m)
        if chunk_steps < 1 or slots < 1:
            raise ValueError(f"chunk_steps ({chunk_steps}) and slots ({slots}) must be >= 1")
        dev, max_seq = self.device, self.cfg.max_seq
        spec_k = self.cfg.spec_k
        spec = spec_k >= 1
        if spec and self.draft is None:
            raise ValueError("spec_k >= 1 needs the drafter an Engine built with spec_k >= 1 "
                             "makes at init")
        W = spec_k + 1                 # verify window: the last token + drafts
        # positions one decode round writes: a window pos..pos+W-1, a chunk
        # pos..pos+chunk_steps-1
        steps_cov = W if spec else chunk_steps
        sched = ContinuousScheduler(slots, range(n))
        paged = self.cfg.paged
        prefix = None
        if paged:
            if self.cfg.paged_read not in ("shadow", "step"):
                raise ValueError(f"paged_read must be 'shadow' or 'step', "
                                 f"got {self.cfg.paged_read!r}")
            bs_blk = self.cfg.block_size
            if bs_blk < 1 or max_seq % bs_blk:
                raise ValueError(f"block_size {bs_blk} must divide max_seq {max_seq}")
            n_logical = max_seq // bs_blk
            pool_blocks = self.cfg.pool_blocks
            if pool_blocks is None:           # dense-equivalent capacity + sentinel
                pool_blocks = slots * n_logical + 1
            if pool_blocks < 2:
                raise ValueError(
                    f"pool_blocks must be >= 2 (the reserved sentinel plus at least "
                    f"one usable block), got {pool_blocks}")
            pool = BlockPool(pool_blocks, bs_blk)
            # any single request must fit an otherwise empty pool, so that
            # preemption can always make progress
            for rid, (r, m) in enumerate(zip(requests, budgets)):
                need = worst_case_blocks(int(r.shape[0]), m, chunk_steps, bs_blk, max_seq,
                                         spec_k=spec_k)
                if need > pool.usable:
                    raise ValueError(
                        f"request {rid}: worst-case footprint {need} blocks (prompt "
                        f"{r.shape[0]} + max_new {m}, block_size {bs_blk}) exceeds the "
                        f"pool's {pool.usable} usable blocks — raise pool_blocks or "
                        f"shrink the request")
            if self.cfg.prefix_caching and not lm.model_kv_quant(self.model):
                prefix = PrefixCache(bs_blk)
            caches = self._make_paged_caches(pool_blocks, bs_blk)
            shard = self.shard and self.shard.for_pool(pool_blocks)
            tables = np.zeros((slots, n_logical), np.int32)     # 0 == sentinel
            table_dev = {"arr": None, "dirty": True}           # uploaded per change
            covered = np.zeros((slots,), np.int64)             # blocks bound per slot
            slot_rid = np.full((slots,), -1, np.int64)
            prefill_tok = {"computed": 0, "saved": 0}
            key_chains: dict[int, list] = {}   # rid -> its prompt's hash chain
        else:
            caches = self._make_dense_caches(slots)
            shard = self.shard and self.shard.for_rows(slots)
        # the drafter's KV: dense per-slot rows, draft_layers deep, in the
        # paged mode too (draft_layers / n_repeats of one dense target cache)
        draft_caches = (lm.init_caches(self.draft.cfg, slots, max_seq, self._dt, dev)
                        if spec else None)
        spec_stats = {"windows": 0, "proposed": 0, "accepted": 0, "emitted": 0}
        draft_prefill_groups: list[list[int]] = []
        # host mirrors of the per-slot device state fed to each chunk; the
        # key chains live only here (they never depend on a token)
        tok = np.zeros((slots, 1), np.int32)
        pos = np.zeros((slots,), np.int64)
        keys = np.zeros((slots, 2), np.int64)
        eos_hit = np.ones((slots,), bool)      # empty slots stay latched
        base = threefry.prng_key(seed).numpy()
        bufs: list[list[int]] = [[] for _ in range(n)]
        outputs: list[np.ndarray | None] = [None] * n
        latency = [0.0] * n
        timing = {"prefill_s": 0.0, "decode_s": 0.0}
        prefill_groups: list[list[int]] = []
        t0 = time.perf_counter()

        def dev_int(a) -> torch.Tensor:           # a copy, never a view of a mirror
            return torch.tensor(np.asarray(a, np.int64), device=dev)

        def finalize(rid: int) -> None:
            got = bufs[rid][: budgets[rid]]
            out = np.full((budgets[rid],), pad, np.int32)
            out[: len(got)] = got
            outputs[rid] = out
            latency[rid] = time.perf_counter() - t0

        def draft_prefill(tokens, lens, slots_a) -> None:
            """Admission enters a slot's drafter row into lockstep: the full
            prompt overwrites the whole row, so a recycled or preempted slot
            never leaks its last occupant's drafter KV."""
            lm.prefill_into_slots(self.draft.params, self.draft.cfg, tokens, lens,
                                  slots_a, draft_caches, max_seq, self._dt)
            draft_prefill_groups.append(list(tokens.shape))

        def activate_group(pairs, lens, last) -> None:
            """Shared admission tail (dense and paged): each request's key
            chain, derived from its id (so a request recomputed after a
            preemption draws the same stream), and its first token from its
            prefill logits; then activate its slot, or retire it at once (a
            budget of one token, or a first token that is EOS)."""
            kcs, firsts = self._keys_first(base, [rid for _, rid in pairs], last)
            self._agree(firsts)
            firsts = firsts.cpu().numpy()  # kanlint: ignore[KL102] (one read per admission)
            for j, (b, rid) in enumerate(pairs):
                first = int(firsts[j])
                bufs[rid].append(first)
                hit = eos >= 0 and first == eos
                if sched.confirm_admit(b, rid, int(lens[j]), budgets[rid] - 1, hit):
                    finalize(rid)
                    sched.retire(b)
                    if paged:
                        release_slot_blocks(b)
                    eos_hit[b] = True
                else:
                    tok[b, 0] = first
                    pos[b] = int(lens[j])
                    if kcs is not None:
                        keys[b] = kcs[j]
                    eos_hit[b] = False

        def admit_all() -> None:
            while True:
                ready = sched.admit_ready()
                if not ready:
                    return
                groups: dict[int, list[tuple[int, int]]] = {}
                for b, rid in ready:
                    L = requests[rid].shape[0]
                    t_pad = min(-(-L // prompt_pad_multiple) * prompt_pad_multiple, max_seq)
                    groups.setdefault(t_pad, []).append((b, rid))
                for t_pad, grp in sorted(groups.items()):
                    t1 = time.perf_counter()
                    lens = np.asarray([requests[rid].shape[0] for _, rid in grp], np.int64)
                    padded = np.stack([np.pad(requests[rid], (0, t_pad - requests[rid].shape[0]))
                                       for _, rid in grp])
                    toks_d, lens_d = dev_int(padded), dev_int(lens)
                    last, _ = lm.prefill_into_slots(
                        self.params, self.model, toks_d, lens_d,
                        [b for b, _ in grp], caches, max_seq, self._dt, shard)
                    prefill_groups.append([len(grp), t_pad])
                    if spec:
                        draft_prefill(toks_d, lens_d, [b for b, _ in grp])
                    activate_group(grp, lens, last)
                    timing["prefill_s"] += time.perf_counter() - t1

        # ------------------------- paged machinery --------------------------

        def release_slot_blocks(b: int) -> None:
            """Drop slot b's blocks (retire or preempt): the pool drops the
            request's references (prefix-cache blocks survive) and the table
            row resets to the sentinel, where the dead row's writes land."""
            pool.release_request(int(slot_rid[b]))
            tables[b, :] = 0
            table_dev["dirty"] = True
            covered[b] = 0
            slot_rid[b] = -1

        def free_up(need: int, protect_slot: int) -> bool:
            """Make ``need`` blocks free: evict LRU prefix entries, then
            preempt the youngest live request.  False once ``protect_slot``
            itself was preempted."""
            while pool.free_count() < need:
                if prefix is not None and prefix.evict_lru(pool) is not None:
                    continue
                victim = sched.youngest_live_slot()
                if victim is None:
                    raise RuntimeError("pool exhausted with no live rows")
                rid_v = sched.preempt(victim)
                bufs[rid_v] = []          # restart from scratch on re-admission
                release_slot_blocks(victim)
                eos_hit[victim] = True
                if victim == protect_slot:
                    return False
            return True

        def admit_all_paged() -> None:
            while True:
                ready = sched.admit_ready()
                if not ready:
                    return
                # bind blocks per request; one prefill per (prefix start,
                # padded suffix length)
                groups: dict[tuple[int, int], list] = {}
                deferred: list[int] = []
                for b, rid in ready:
                    toks_r = requests[rid]
                    L = toks_r.shape[0]
                    if prefix is not None:
                        n_hit, hit_blocks, keys_r = prefix.match(toks_r, key_chains.get(rid))
                        key_chains[rid] = keys_r
                    else:
                        n_hit, hit_blocks, keys_r = 0, [], []
                    start = n_hit * bs_blk
                    n_new = blocks_for(L, bs_blk) - n_hit
                    # share first: a matched cache-only block must not be
                    # evicted while room is made for the suffix blocks
                    pool.share(rid, hit_blocks)
                    ok = pool.free_count() >= n_new
                    while not ok and prefix is not None:
                        if prefix.evict_lru(pool) is None:
                            break
                        ok = pool.free_count() >= n_new
                    if not ok:
                        # admission never preempts; blocks free as rows retire
                        pool.release_request(rid)
                        deferred.append(rid)
                        continue
                    row = hit_blocks + pool.alloc(rid, n_new)
                    if prefix is not None:
                        prefix.record_admission(n_hit, L)
                    tables[b, :] = 0
                    tables[b, : len(row)] = row
                    table_dev["dirty"] = True
                    covered[b] = len(row)
                    slot_rid[b] = rid
                    prefill_tok["saved"] += start
                    prefill_tok["computed"] += L - start
                    t_pad = min(-(-(L - start) // prompt_pad_multiple) * prompt_pad_multiple,
                                max_seq - start)
                    groups.setdefault((start, t_pad), []).append((b, rid, L, keys_r))
                for (start, t_pad), grp in sorted(groups.items()):
                    t1 = time.perf_counter()
                    lens = np.asarray([L for _, _, L, _ in grp], np.int64)
                    suffix = np.stack([np.pad(requests[rid][start:], (0, t_pad - (L - start)))
                                       for _, rid, L, _ in grp])
                    tbls = torch.as_tensor(tables[[b for b, *_ in grp]], device=dev)
                    lens_d = dev_int(lens)
                    last, _ = lm.prefill_into_pages(
                        self.params, self.model, dev_int(suffix), lens_d, tbls,
                        caches, start, self._dt, blocks_for(start + t_pad, bs_blk), shard)
                    prefill_groups.append([len(grp), t_pad])
                    if spec:
                        # the drafter has no pool and no prefix cache: its
                        # dense row takes the FULL prompt, padded to the
                        # group's common start + t_pad
                        full = np.stack([np.pad(requests[rid], (0, start + t_pad - L))
                                         for _, rid, L, _ in grp])
                        draft_prefill(dev_int(full), lens_d, [b for b, *_ in grp])
                    # register the fresh full prompt blocks for later
                    # admissions (first writer wins)
                    if prefix is not None:
                        for b, rid, L, keys_r in grp:
                            for i, key in enumerate(keys_r):
                                if prefix.insert(key, int(tables[b, i])):
                                    pool.cache_ref(int(tables[b, i]))
                    activate_group([(b, rid) for b, rid, _, _ in grp], lens, last)
                    timing["prefill_s"] += time.perf_counter() - t1
                if deferred:
                    # back to the head of the queue, in their order
                    for rid in reversed(deferred):
                        sched.queue.push_front(rid)
                    return

        def ensure_chunk_coverage() -> None:
            """Before a chunk, every live row's table must cover its
            ``chunk_steps`` writes, or a window's ``W`` (the chunk advances
            positions whatever the budget left; writes past ``max_seq`` go to
            the sentinel).  Pool
            exhaustion here evicts prefix entries, then preempts."""
            for b in list(sched.table.live_slots()):
                s = sched.table.slots[b]
                if not s.occupied or s.eos_hit:
                    continue                  # preempted or retired meanwhile
                want = blocks_for(min(int(pos[b]) + steps_cov, max_seq), bs_blk)
                need = int(want - covered[b])
                if need <= 0:
                    continue
                if not free_up(need, protect_slot=b):
                    continue                  # b itself was preempted
                fresh = pool.alloc(int(slot_rid[b]), need)
                tables[b, int(covered[b]): int(covered[b]) + need] = fresh
                table_dev["dirty"] = True
                covered[b] += need

        def run_window(tok_d, pos_d, eos_d, kts_d, chains) -> None:
            """One speculative window over every slot: ``spec_k`` drafter
            steps, ONE verify pass, the acceptance, one device-to-host read,
            then the scheduler's accounting and (paged) the trim of rejected
            coverage.  Sampled, the window's ``W`` steps of noise are drawn
            once from the step keys ``kts_d (slots, W, 2)``: the drafter takes
            the first ``spec_k``, the verifier all ``W``, and each chain
            resumes from ``chains[b, m_b]``."""
            nonlocal tok, pos, keys, eos_hit
            table = table_dev["arr"] if paged else None
            T = self.cfg.temperature
            noise = None
            if self._sampled:
                noise = threefry.gumbel(kts_d, (self.model.vocab,))   # (slots, W, V)
            draft, _ = speculative.draft_propose(
                self.draft.params, self.draft.cfg, spec_k, tok_d, draft_caches, pos_d,
                None, eos_d, T, self._dt, None if noise is None else noise[:, :spec_k])
            x = torch.cat([tok_d, draft], dim=1)                   # (slots, W)
            if paged and self.cfg.paged_read == "shadow":
                view = lm.paged_views(caches, table)
                logits, _ = lm.verify_window(self.params, self.model, x, view, pos_d,
                                             self._dt)
                lm.writeback_paged_chunk(caches, view, table, pos_d, W)
            else:
                logits, _ = lm.verify_window(self.params, self.model, x, caches, pos_d,
                                             self._dt, table)
            target = speculative.sample_with_noise(
                logits.reshape(slots * W, -1),
                None if noise is None else noise.reshape(slots * W, -1), T).reshape(slots, W)
            emitted, m, eos_l = speculative.accept_window(draft, target, eos_d, eos, pad)
            last = torch.gather(emitted, 1, torch.clamp_min(m - 1, 0)[:, None].long())
            tok_l = torch.where((m > 0)[:, None], last, tok_d)
            # one read: emitted (W), m, tok, pos and the EOS latch per slot
            host = torch.cat([emitted.long(), m[:, None].long(), tok_l.long(),
                              (pos_d + m)[:, None], eos_l[:, None].long()], dim=1).cpu().numpy()
            emitted_h, m_h = host[:, :W], host[:, W]
            tok = host[:, W + 1:W + 2].astype(np.int32)
            pos = host[:, W + 2].copy()
            eos_hit = host[:, W + 3].astype(bool)
            if chains is not None:           # resume after exactly m splits
                keys = chains[np.arange(slots), m_h]
            # accept_window cuts m at an EOS, so no pad inside m: no eos_steps
            spec_stats["windows"] += 1
            for b, rid, n_keep, finished in sched.complete_spec_window(W, m_h, eos_hit):
                spec_stats["proposed"] += spec_k
                spec_stats["accepted"] += max(0, min(int(m_h[b]) - 1, spec_k))
                spec_stats["emitted"] += n_keep
                bufs[rid].extend(int(t) for t in emitted_h[b, :n_keep])
                if finished:
                    finalize(rid)
                    sched.retire(b)
                    if paged:
                        release_slot_blocks(b)
                    eos_hit[b] = True
            if paged:
                # roll back rejected coverage: blocks past the accepted
                # frontier are the request's own fresh blocks (admission
                # caps prefix reuse below blocks_for(pos')), so the trim
                # frees them outright, with no copy
                for b in sched.table.live_slots():
                    keep = blocks_for(int(pos[b]), bs_blk)
                    if keep < covered[b]:
                        pool.trim_request(int(slot_rid[b]), keep)
                        tables[b, keep:] = 0
                        table_dev["dirty"] = True
                        covered[b] = keep

        while True:
            admit_all_paged() if paged else admit_all()
            sched.check_invariants()
            if paged:
                ensure_chunk_coverage()
            if not sched.can_run_chunk():
                if paged and sched.has_work():
                    continue                  # everything preempted: re-admit
                break
            t1 = time.perf_counter()
            if paged and table_dev["dirty"]:
                table_dev["arr"] = torch.tensor(tables, device=dev)
                table_dev["dirty"] = False
            # one upload of the per-slot state: token, position, EOS latch
            # and, sampled, the step keys of every row's chain
            steps = W if spec else chunk_steps
            state = [tok, pos[:, None], eos_hit[:, None]]
            kts = chains = None
            if self._sampled:
                kts, chains = speculative.split_chain(keys, steps)
                state.append(kts.reshape(slots, 2 * steps))
            up = dev_int(np.concatenate([np.asarray(a, np.int64) for a in state], axis=1))
            tok_d = up[:, :1].to(torch.int32)
            pos_d = up[:, 1].contiguous()
            eos_d = up[:, 2].bool()
            kts_d = up[:, 3:].reshape(slots, steps, 2) if self._sampled else None
            if spec:
                run_window(tok_d, pos_d, eos_d, kts_d, chains)
                timing["decode_s"] += time.perf_counter() - t1
                continue
            if paged and self.cfg.paged_read == "shadow":
                # gather once per chunk, decode on the dense view, write the
                # chunk's span back to the pools
                view = lm.paged_views(caches, table_dev["arr"], shard)
                toks, tok_l, view, pos_l, eos_l = self._decode_chunk(
                    chunk_steps, tok_d, view, pos_d, eos_d, eos, step_keys=kts_d,
                    shard=shard)
                lm.writeback_paged_chunk(caches, view, table_dev["arr"], pos_d, chunk_steps,
                                         shard)
            else:
                toks, tok_l, caches, pos_l, eos_l = self._decode_chunk(
                    chunk_steps, tok_d, caches, pos_d, eos_d, eos,
                    table_dev["arr"] if paged else None, kts_d, shard)
            # one read: the chunk's tokens, tok, pos and the EOS latch per slot
            host = self._agree(torch.cat([toks.T.long(), tok_l.long(), pos_l[:, None].long(),
                                          eos_l[:, None].long()], dim=1)).cpu()
            h_toks, h_tok, h_pos, h_eos = host.split([chunk_steps, 1, 1, 1], dim=1)
            toks = h_toks.T.to(toks.dtype).numpy()
            tok = h_tok.to(tok_l.dtype).numpy()
            pos = h_pos[:, 0].to(pos_l.dtype).numpy()
            eos_hit = h_eos[:, 0].to(eos_l.dtype).numpy()
            if chains is not None:           # every row split chunk_steps times
                keys = chains[:, chunk_steps]
            timing["decode_s"] += time.perf_counter() - t1
            if eos >= 0:
                # first in-chunk EOS per slot (chunk_steps if none): pads
                # after it count as waste in the utilization
                hits = toks == eos
                eos_steps = np.where(hits.any(axis=0), hits.argmax(axis=0), chunk_steps)
            else:
                eos_steps = None
            for b, rid, n_keep, finished in sched.complete_chunk(chunk_steps, eos_hit,
                                                                 eos_steps):
                bufs[rid].extend(int(t) for t in toks[:n_keep, b])
                if finished:
                    finalize(rid)
                    sched.retire(b)
                    if paged:
                        release_slot_blocks(b)
                    eos_hit[b] = True

        sched.check_invariants()
        self.last_serve_stats = {
            **sched.stats(),
            "wall_s": time.perf_counter() - t0,
            "request_latency_s": latency,
            "useful_tokens": int(sum(budget_used(bufs[i], budgets[i], eos)
                                     for i in range(n))),
            **timing,
            "prefill_groups": prefill_groups,
            "mesh_shape": None if self.shard is None else self.shard.shape,
        }
        if spec:
            self.last_serve_stats["draft_prefill_groups"] = draft_prefill_groups
            self.last_serve_stats["spec"] = {
                "spec_k": spec_k,
                "draft_layers": self.draft.n_layers,
                "draft_quant": self.draft.quant,
                "windows": spec_stats["windows"],
                "proposed_drafts": spec_stats["proposed"],
                "accepted_drafts": spec_stats["accepted"],
                "acceptance_rate": spec_stats["accepted"] / max(spec_stats["proposed"], 1),
                "emitted_tokens": spec_stats["emitted"],
            }
        if paged:
            # after the drain every block is free or held by the prefix
            # cache alone: a leaked block or a wrong refcount fails here
            pool.check_balanced(n_live_requests=0)
            self.last_serve_stats["paged"] = {
                **pool.stats(),
                **(prefix.stats() if prefix is not None else {"prefix_caching": False}),
                "prefill_tokens_computed": prefill_tok["computed"],
                "prefill_tokens_saved": prefill_tok["saved"],
            }
        return outputs  # type: ignore[return-value]


def budget_used(buf: list[int], budget: int, eos: int) -> int:
    """Tokens a request actually used: up to and including its EOS, else
    its full budget."""
    toks = buf[:budget]
    if eos >= 0 and eos in toks:
        return toks.index(eos) + 1
    return len(toks)
