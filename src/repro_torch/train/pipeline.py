"""GPipe pipeline training (counterpart of ``repro/train/pipeline.py``).

The reference splits the layer stack (one block repeated ``n_repeats``
times) into ``S`` stages over the ``pod`` mesh axis: :func:`stage_params`
reshapes each stacked unit leaf ``(R, ...)`` to ``(S, R/S, ...)``, and the
loss runs the classic looped schedule of ``M + S - 1`` ticks, in which
stage ``s`` runs microbatch ``t - s`` at tick ``t`` when ``0 <= t - s < M``
and hands its activations to stage ``s + 1`` by ``ppermute``.  Backward is
autodiff through the loop (GPipe keeps every microbatch's activations).

Here one process runs every stage.  Stage ``s`` runs on ``devices[s]``
(by default the device that holds the parameters: the card, or the CPU),
the counterpart of the ``pod``-sharded leading axis, and the hop is
``.to(devices[s + 1])``, which copies nothing when both stages share a
device.  Stages on separate cards run one after another in this one
process: ``devices`` places the stages, it does not overlap them.  The
schedule is the reference's, without the work it masks away:
the reference embeds a microbatch on every stage at every tick, takes the
norm, the unembedding and the NLL on every stage, and runs stages whose
tick holds no microbatch, then adds the unwanted terms as exact zeros
(``where(valid, ..., 0.0)``).  Here stage 0 embeds each microbatch once,
the last stage takes the norm, the tied unembedding and the NLL once per
microbatch, and a stage with no microbatch does nothing.  It is the same
function: ``sum(nll * mask) / max(sum(mask), 1)`` with the per-microbatch
sums added in microbatch order, and ``torch.autograd`` differentiates it.

Reference semantics the port keeps (ROADMAP queue 3):

* the MoE auxiliary losses are dropped: the loss is the NLL alone, where
  ``lm.lm_loss`` adds ``0.01 * (moe_lb_loss + moe_z_loss)``;
* each microbatch is routed alone, so MoE capacity counts one microbatch's
  rows: the loss is the token-weighted mean of ``lm.forward``'s NLL over
  each microbatch taken alone, not ``lm_loss`` over the whole batch;
* ``logit_softcap`` is not applied;
* only ``batch["tokens"]`` and ``batch["labels"]`` are read: a ``mixed``
  model's ``prefix_embeddings`` are ignored (a text-only loss at positions
  ``0..T-1``), and an ``embeddings`` model, on which the reference dies
  with ``KeyError: 'tokens'``, is refused with a ``ValueError``.

``compute_dtype`` defaults to fp32, the port's convention for
``lm.forward`` and the trainer; the reference's defaults to bf16.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.convert import tree_map
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import lm


def stage_params(params: dict, n_stages: int) -> dict:
    """Reshape the stacked unit leaves ``(R, ...)`` to ``(S, R/S, ...)``
    (views); the other keys stay as they are."""
    def resh(a):
        if a.shape[0] % n_stages:
            raise ValueError(f"a unit leaf of {a.shape[0]} repeats does not split into "
                             f"{n_stages} stages")
        return a.reshape((n_stages, a.shape[0] // n_stages) + a.shape[1:])

    out = dict(params)
    out["unit"] = [tree_map(resh, p) for p in params["unit"]]
    return out


def unstage_params(params_staged: dict) -> dict:
    """Inverse of :func:`stage_params`: ``(S, R/S, ...)`` -> ``(R, ...)``
    (a staged gradient tree maps back to ``lm``'s layout the same way)."""
    out = dict(params_staged)
    out["unit"] = [tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), p)
                   for p in params_staged["unit"]]
    return out


def make_pp_loss(model_cfg: lm.ModelConfig, n_stages: int, microbatches: int,
                 devices=None, compute_dtype=torch.float32) -> Callable:
    """-> ``loss_fn(params_staged, batch) -> scalar tensor``, the pipelined
    next-token NLL of ``batch["tokens"]`` over ``batch["labels"]`` (-100
    masked), split into ``microbatches`` groups of consecutive rows.

    Refuses (``ValueError``) a unit of more than one block, a prologue, an
    epilogue or shared blocks, ``n_repeats % n_stages != 0``, an
    ``embeddings`` model, and (when called) a batch that does not split into
    ``microbatches``.  ``devices``: one device per stage (default: every
    stage on the device of the embedding table)."""
    cfg = model_cfg
    lm.check_supported(cfg)
    if len(cfg.unit) != 1:
        raise ValueError(f"{cfg.name}: the pipeline takes a unit of one block; this unit "
                         f"has {len(cfg.unit)}")
    if cfg.prologue or cfg.epilogue or cfg.shared:
        raise ValueError(f"{cfg.name}: the pipeline takes no prologue, epilogue or shared "
                         "blocks")
    if cfg.input_kind == "embeddings":
        raise ValueError(f"{cfg.name}: input_kind 'embeddings' has no tokens, and the "
                         "pipeline reads batch['tokens'] and batch['labels'] only (the "
                         "reference dies with KeyError: 'tokens')")
    if n_stages < 1 or cfg.n_repeats % n_stages:
        raise ValueError(f"{cfg.name}: {cfg.n_repeats} repeats do not split into "
                         f"{n_stages} equal stages (n_repeats % n_stages must be 0)")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, not {microbatches}")
    if devices is not None and len(devices) != n_stages:
        raise ValueError(f"{len(devices)} devices for {n_stages} stages")
    S, M = n_stages, microbatches
    blk = cfg.unit[0]
    scale = math.sqrt(cfg.d_model)

    def loss_fn(params_staged: dict, batch: dict) -> torch.Tensor:
        tokens, labels = batch["tokens"], batch["labels"]
        rows, T = tokens.shape
        if rows % M:
            raise ValueError(f"a batch of {rows} rows does not split into {M} microbatches")
        devs = ([torch.device(d) for d in devices] if devices is not None
                else [params_staged["embed"]["table"].device] * S)
        first, last = devs[0], devs[-1]
        tok = tokens.to(first).reshape(M, rows // M, T)
        lbl = labels.to(last).long().reshape(M, rows // M, T)
        # one unbind per leaf, the stages and then each stage's repeats: a
        # select per tick and repeat would build, in backward, a zero tensor
        # of the whole stacked leaf each time (lm._layers)
        stages = [lm._layers(tree_map(lambda a, d=d: a.to(d), st), cfg.n_repeats // S)
                  for st, d in zip(lm._layers(params_staged["unit"][0], S), devs)]
        positions = [torch.arange(T, device=d)[None, :] for d in devs]
        embed_in = tree_map(lambda a: a.to(first), params_staged["embed"])
        embed_out = tree_map(lambda a: a.to(last), params_staged["embed"])
        final_ln = tree_map(lambda a: a.to(last), params_staged["final_ln"])
        loss_sum = torch.zeros((), device=last)
        tok_sum = torch.zeros((), device=last)
        inbox = [None] * S
        for t in range(M + S - 1):
            outbox = [None] * S
            for s in range(max(0, t - M + 1), min(S, t + 1)):
                m = t - s
                x = (L.embed_lookup(embed_in, tok[m], compute_dtype) * scale if s == 0
                     else inbox[s])
                for p in stages[s]:
                    x, _ = B.block_apply(p, blk, x, positions=positions[s],
                                         chunk=cfg.attn_chunk)
                if s < S - 1:
                    outbox[s + 1] = x.to(devs[s + 1])
                    continue
                logits = L.unembed_logits(embed_out, L.rmsnorm(final_ln, x))
                mask = (lbl[m] >= 0).float()
                logp = torch.log_softmax(logits, dim=-1)
                nll = -logp.gather(-1, lbl[m].clamp(0, cfg.vocab - 1)[..., None])[..., 0]
                loss_sum = loss_sum + (nll * mask).sum()
                tok_sum = tok_sum + mask.sum()
            inbox = outbox
        return loss_sum / torch.clamp_min(tok_sum, 1.0)

    return loss_fn
