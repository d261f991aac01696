"""Static batched greedy serving (counterpart of ``repro/serve/engine.py``).

``Engine.generate`` prefills a batch and then decodes it step by step in a
Python loop (one ``lm.decode_step`` per token; CUDA graphs come later).
``Engine.serve_requests`` sorts requests by length into fixed batches, pads
short batches with copies of their last request, and drains each batch.

Padding is right-padding with per-row ``lengths``: real tokens sit at
positions ``0..len-1``, each row takes its first token from the logits at
its own last real position, and decode starts ragged at ``pos_b = len_b``,
overwriting the pad K/V in the cache before the mask ``kv_slot <= pos_b``
can expose it.  Without ``lengths`` and with EOS off, decode uses one scalar
position for every row.

EOS (``eos_id >= 0``) latches per row: the EOS token is emitted, every
later step of that row emits ``pad_id`` and its position freezes.

Continuous batching, the paged KV pool, speculative decoding and sampling at
``temperature > 0`` are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import set_ieee_fp32
from repro_torch.models import lm
from repro_torch.serve import speculative

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 512
    max_new_tokens: int = 64
    temperature: float = 0.0
    eos_id: int = -1             # -1: never stops early
    pad_id: int = 0              # emitted after a row latches on EOS
    compute_dtype: str = "float32"


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class Engine:
    def __init__(self, params, model_cfg: lm.ModelConfig, serve_cfg: ServeConfig,
                 device="cuda"):
        if serve_cfg.temperature > 0.0:
            raise NotImplementedError(speculative.SAMPLING_NOT_PORTED)
        lm.check_supported(model_cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            set_ieee_fp32()
        self.model = model_cfg
        self.cfg = serve_cfg
        self._dt = DTYPES[serve_cfg.compute_dtype]
        self.params = _to_device(params, self.device)
        self.last_serve_stats: dict | None = None
        self.last_generate_stats: dict | None = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _validate_request(self, rid, prompt_len: int, max_new: int) -> None:
        if max_new < 1:
            raise ValueError(f"request {rid}: max_new must be >= 1, got {max_new}")
        if prompt_len < 1:
            raise ValueError(f"request {rid}: empty prompt (prompt_len={prompt_len})")
        if prompt_len + max_new > self.cfg.max_seq:
            raise ValueError(
                f"request {rid}: prompt_len {prompt_len} + max_new {max_new} "
                f"= {prompt_len + max_new} exceeds max_seq {self.cfg.max_seq}")

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
        prompts.  ``request_ids`` and ``seed`` key the per-row sampling
        chains of the reference; greedy decoding does not read them.
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
                                    self.cfg.max_seq, self._dt)
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
        tok = speculative.sample_tokens(last, self.cfg.temperature)
        self._sync()
        t1 = time.perf_counter()
        eos_hit = tok == eos                  # eos = -1 never matches
        pad = torch.tensor(self.cfg.pad_id, dtype=torch.int32, device=dev)
        outs = [tok]
        tok = tok[:, None]
        for _ in range(max_new - 1):
            lg, caches = lm.decode_step(self.params, self.model, tok, caches, pos,
                                        self._dt)
            nxt = speculative.sample_tokens(lg, self.cfg.temperature)
            emitted = torch.where(eos_hit, pad, nxt)
            if pos.dim() == 0:
                pos = pos + 1
            else:                             # latched rows freeze
                pos = torch.where(eos_hit, pos, pos + 1)
            eos_hit = eos_hit | (nxt == eos)
            tok = emitted[:, None]
            outs.append(emitted)
        out = torch.stack(outs, dim=1).cpu().numpy()
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
        and drain bucket by bucket; outputs in request order."""
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
