#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failed check raises and the script exits non-zero:

1. torch and CUDA versions, the card's name and power limit
   (``nvidia-smi``); float32 matmuls and convolutions set to IEEE fp32
   (TF32 off).
2. Build the six kernel libraries from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, ``sm_90a``, all at once), each library's own
   seconds logged.
3. Hold each kernel against its plain PyTorch version on the card: fp32 and
   bf16, with and without the base term, at the main path's shapes and a
   ragged one, on inputs that include ``x_min``, ``x_max``, knot values and
   out-of-domain values.  Time kernel, plain version and one PyTorch matmul
   over the materialised band (``library_ms``, a yardstick the port never
   calls) with CUDA events behind a spin kernel (so the host's launch rate
   does not set the time), rotating input copies so the 50 MB L2 stays
   cold as in the model; compute each kernel's bound from its shapes.  The
   fused and sparse kernels are also timed where the fp32 MNIST-KAN net of
   phase 7 launches them (2048 and 8 rows of 784 -> 64 and 64 -> 10,
   M = 13).
4. The main path: full-width kanformer-100m (random weights from a seed,
   fp32) served through ``Engine.serve_requests`` with the launch counts
   reset just before and read just after; then the same tokens through
   prefill and decode steps on the kernel path and on the plain path
   (``KAN_SAS_INFERENCE_METHOD=compact``), logits compared.
5. The same requests again, warm, and one bucket's ``generate`` under
   ``torch.profiler``: the device's busy share and time by kernel name.
6. The continuous paged path: the block-table gather kernel against its
   plain version, bitwise, fp32 and bf16, at the shadow view's stacked
   shape and the step mode's per-layer shape, timed for one leaf and for
   both leaves of a cache in one launch (the paths' call) beside its plain
   version, ``torch.index_select`` per leaf (``library_ms``) and its byte
   bound.
   Then full-width kanformer-100m serves 16 requests through
   ``Engine.serve_continuous`` four times (dense; paged, shadow reads;
   paged, step reads; paged, shadow, a pool small enough to preempt), each
   with the launch counts reset just before and checked exactly just
   after.  Every stream equals the request served alone by ``generate``,
   unless the first divergence is a near-tie (top-2 logit gap below
   ``LOGIT_ATOL`` on the static path); one admission group is
   teacher-forced through paged prefill and 4 paged decode steps on the
   kernel path and the plain path, logits compared; one warm repeat of
   the shadow run and one of the step run are profiled, and the step
   run's extra time per decode step split into device time by kernel
   name and host time.
6b. Greedy speculative decoding (``spec_k = 4``) of the same 16 requests
   through ``serve_continuous``, five runs: dense with a 1-layer drafter,
   paged with shadow reads, paged with step reads, paged with a 25-block
   pool (it must preempt), and dense with a full-depth drafter (it must
   accept at least 0.9 of its drafts, and reject no more than ``spec_k``
   drafts per near-tie of its streams).  Each run with the launch counts
   reset just before and checked exactly just after (the verify window's
   40 rows through the fused kernel, the drafter's 8 through the sparse
   one, the paged verify through the gather), every stream equal to
   phase 6's dense stream unless the first divergence is a near-tie, the
   pool balanced after the drain.  One admission group of 8 requests is
   teacher-forced through ``lm.verify_window`` and through W sequential
   decode steps, dense and paged, on the kernel path and the plain path:
   all four logits within ``LOGIT_ATOL`` of each other.  Each run is
   repeated warm, and the warm paged shadow run profiled.  Phase 3 checks
   and times both KAN kernels at the verify window's 40 rows.
6c. Sampling at ``SAMPLE_T`` = 100 (a temperature where the Gumbel noise
   beats the input token's ~500 logit lead on random weights): the threefry
   port's Random123 known answers and golden ``jax.random`` values bit-equal
   on the card, one ``(8, 32000)`` draw of bits equal to the CPU's and its
   Gumbel noise within ``GUMBEL_ATOL``; phase 4's requests through
   ``serve_requests``; the continuous cell through ``serve_continuous``
   (dense, paged shadow, paged step, the 25-block pool, which must preempt)
   and speculative windows (``spec_k = 4``, a 1-layer drafter: dense, paged
   shadow, and paged with 4-token blocks, where ``trim_request`` must free
   blocks), each with the launch counts reset just before and checked
   exactly just after and the pool balanced after the drain.  The dense
   streams equal each request served alone by ``generate``, and every other
   run's streams the dense run's, unless the first divergence is a near-tie
   of the perturbed scores (top-2 gap of ``logits / T + g`` below
   ``LOGIT_ATOL / T``; counted and printed); at least
   ``MIN_SAMPLED_SHARE`` of the dense run's tokens differ from the argmax
   of their own logits; every speculative run accepts some drafts and
   rejects some.  Warm paged shadow runs, greedy and sampled in turn, give
   ms per decode step; one sampled run is profiled beside phase 6's greedy
   one: kernels and device-busy ms per decode step, and the busy share.
7. Integer-only KAN inference of full-width MNIST-KAN ([784, 64, 10],
   G=10, P=3, random weights from seed 0): every layer quantised on the
   card and held equal to a CPU quantisation; 2048 inputs (uniform over
   [-1.2, 1.2], x_min, x_max and the knots planted) through
   ``quantized_kan_forward_fused`` per layer with tanh between (the
   dense-band int8 kernel), and 8 of them (the sparse int8 kernel), the
   fp32 net through ``kan_net_apply(method="auto")`` at 2048 rows (fused
   kernel) and 8 rows (the sparse kernel at M = 13), and the LUT path
   (``method="lut"``, the B-spline LUT kernel) at 2048 rows, each run with
   the launch counts reset just before and checked exactly just after.
   Each layer's int32 accumulator is bit-equal to the plain version on the
   card and the int8 net's logits equal the plain integer path's; the
   int8-vs-fp32 top-1 agreement and max |logit difference| are reported.
   The sparse int8 kernel at 1, 4 and 8 rows of each layer is bit-equal to
   the dense-band one and to its plain version (int32, fp32 and bf16 out);
   the LUT kernel on layer 1's 2048 x 784 inputs is exact; every ROM
   address of P = 1, 2, 3 at value scales 128/256 and 192 reads
   ``build_lut_u8``'s byte.  The three kernels are timed at MNIST-KAN
   layer 1 and CF-KAN layer 1 (2810 -> 512, G=2) beside their plain
   versions, a bf16 matmul over the materialised u8 band (``library_ms``)
   and their bounds, and the dense-band kernel also at the sparse kernel's
   two 8-row shapes (a yardstick for the sparse one); one warm int8 run is
   profiled.
8. GKAN (Table II: [200, 16, 7], G=2, P=1, random weights from seed 0)
   through ``kan_net_apply(method="auto")``: 8 rows (the sparse kernel at
   P = 1, M = 3) and 2048 rows (the fused kernel), each with the launch
   counts reset just before and checked exactly just after, and each
   within ``FP32_ATOL`` of ``method="compact"`` on the card.
9. The paper's KAN applications.  (a) MNIST-KAN trained on the card at
   ``benchmarks/quant_accuracy.train_mnist_kan()``'s defaults (250 Adam
   steps of batch 256 through the ``dense`` path, from the reference's own
   threefry draws), then its 2048 test inputs through ``dense``, ``auto``
   (the fused kernel), ``lut`` (the LUT kernel) and the int8 path quantised
   on the card (the dense-band int8 kernel), each run counted: ``auto``
   within ``FP32_ATOL`` of ``dense``, the int8 logits equal to the plain
   integer path's, the fp32 accuracy within ``ACC_TOL`` of the reference's
   ``REF_ACC``, the int8 drop printed beside the reference's and the
   paper's.  (b) ConvKAN at ResKAN18's 20 layer shapes
   (``sa_model.resnet18_convkan_gemms``, a batch of 32 CIFAR-size images),
   one ``conv_kan_apply(method="auto")`` each, 20 fused-kernel launches in
   one counted run, each layer within ``CONV_REL`` of max|y| of the plain
   version, ``im2col`` on the card equal to the CPU's; the fused kernel
   timed at every distinct shape beside its plain version, a matmul over
   the band and its bound.
10. The dense models.  Phase 6's gather check also holds the kernel, bit
   for bit, at qwen1.5-0.5b's pools (24 layers, 97 blocks of 16 tokens, 16
   KV heads, head_dim 64): fp32 k and v, and an int8 cache's four leaves
   (int8 k, v and fp32 k_scale, v_scale) in one launch, stacked and one
   layer, each timed.  (a) Full-width qwen1.5-0.5b at ``QWEN_REPEATS`` = 8
   of its 24 layers (random weights from seed 0, fp32) serves phase 4's
   requests statically: every stream equal
   to the request served alone, teacher-forced decode logits within
   ``DENSE_REL`` of max|logit| of ``lm.forward``, two requests' first 8
   tokens equal to the same weights' run on the host's CPU (streams may
   part only at a near-tie, a top-2 gap below ``DENSE_TIE`` of max|logit|).
   (b) Phase 6's continuous cell four ways (dense, paged shadow, paged step,
   the 25-block pool), (c) with an int8 KV cache dense and paged step (the
   paged streams equal to the dense ones, every gather four leaves in one
   launch, no prefix reuse; int8 against fp32 KV teacher-forced within the
   reference's ``QUANT_REL`` and ``QUANT_AGREE``; KV bytes), (d) speculative
   (``spec_k = 4``, 1-layer drafter, dense and paged shadow), each run with
   exact launch counts, the paged and speculative streams equal to (b)'s
   dense ones; warm runs of (a), (b) and (c) profiled.  (e) Full-width,
   full-depth gemma3-12b (48 layers, 40 of them windowed at 1024) serves 4
   prompts of 1100 tokens statically; its teacher-forced decode logits past
   the window within ``DENSE_REL`` of ``lm.forward``'s windowed mask, and a
   32-token history decoded through the rings equal within ``DENSE_REL`` to
   full caches and ``lm.forward``.
11. The MoE models (see the note above ``MOE_CELL``).  Phase 6's gather
   check also holds the kernel, bit for bit, at olmoe-1b-7b's pools (16
   layers, 97 blocks of 16 tokens, 16 KV heads, head_dim 128), stacked and
   one layer, each timed.  (a) Full-width olmoe-1b-7b at ``OLMOE_REPEATS``
   = 4 of its 16 layers (64 experts top-8 in each; random weights from seed
   0, fp32, 1.78 B parameters) serves phase 4's requests statically, held to its buckets
   recomputed step by step, its teacher-forced decode logits within
   ``DENSE_REL`` of ``lm.forward``'s at ``capacity_factor = E / top_k``;
   then phase 6's continuous cell dense, paged shadow, paged step, the
   25-block pool, speculative (``spec_k = 4``, 1-layer drafter) dense and
   paged shadow, and sampled at ``SAMPLE_T`` twice (repeatable), each run
   with exact launch counts and every gather of a paged run bit-equal to
   its plain version, each run's drop fraction printed and its streams'
   partings from the dense run counted; the dense, paged shadow and both
   speculative runs again at no drop, the paged and speculative streams
   equal to the dense ones and the dense ones to ``lm.forward``, up to
   near-ties; a warm bucket and a warm wave profiled.  (b) Full-width
   deepseek-v2-lite (MLA, a dense prologue, 2 shared and 64 routed experts
   top-6) at ``DEEPSEEK_REPEATS`` = 8 of its 26 MoE layers (19.9 GB of its
   62.0 in fp32) serves 4 prompts statically (held as
   (a)'s) and 8 requests through 4 dense continuous slots, at the
   published capacity and at no drop (held to ``lm.forward``); peak memory
   and the latent cache's bytes beside the GQA cache's.
12. The recurrent models (see the note above ``RECUR``), each at full width
   and depth from seed 0 in fp32 and freed before the next.  (a) zamba2-1.2b
   (32 Mamba2 layers and one shared attention block invoked at 6 depths; 1.35
   B parameters, its 6 unread stacked copies of that block included) serves
   phase 4's requests statically, held to its buckets recomputed step by
   step; 4 unpadded prompts of 128 tokens, their teacher-forced decode
   logits within ``SSM_REL`` of ``lm.forward`` and their streams equal to its
   argmax up to near-ties (``DENSE_TIE``); the SSD scan across chunks, a
   prefill of 896 tokens (7 chunks) and 127 teacher-forced decode steps
   held to ``lm.forward`` over 1024 tokens (8 chunks); phase 6's ragged
   continuous cell dense twice (equal streams), the same cell with every
   prompt 64 tokens long (nothing padded: each stream equal to its solo
   ``generate`` up to near-ties), and sampled at ``SAMPLE_T`` (and at a hot T
   if fewer than ``MIN_SAMPLED_SHARE`` of its tokens leave the argmax),
   each token equal to the draw of its recomputed logits and key chain up
   to near-ties; every run with exact launch counts (0: no kernel on this
   path); paged, speculative and verify-window serving refused.  (b)
   xlstm-1.3b at full width and ``XLSTM_REPEATS`` = 2 of its 6 units (14
   mLSTM and 2 sLSTM layers of its 42 and 6; 1.20 B parameters, 235 MB of
   state per request): the same set, with the chunked mLSTM (256 tokens, 4
   chunks of 64) held to the recurrent forward within ``XLSTM_REL`` in
   place of the long prefill.  Each prints its peak memory, its per-request
   state bytes beside its KV bytes per token, tok/s, and one warm decode
   step of 8 slots under ``torch.profiler`` (busy share, kernels per step).
13. The LM trainer and the non-token inputs (see the note above ``TRAIN``).
   (a) Full-width kanformer-100m trained through ``launch.train`` with the
   reference example's settings (batch 8, seq 64, lr 2e-3, 300 steps, a
   checkpoint every 75), every run with zero kernel launches (the KAN FFN
   trains on its ``dense`` path): the mean loss of the last 10 steps at
   least ``LOSS_DROP`` below the first 10's, the three newest checkpoints
   kept, ms per warm step, tokens/s and peak memory; the 20-step restart
   drill resumes at step 300; 10 steps + save + restore + 10 against 20
   straight steps (``RESUME_ATOL_LR``, ``RESUME_RTOL``; the batches after
   the resume equal the straight run's bit for bit); 20 steps at bf16
   compute, the loss falling; 3 steps (batch 2 x 64) on the card against
   the same steps on this machine's CPU (``CARD_CPU_RTOL``); (b) the trained weights
   serve phase 4's requests statically with exact launch counts of kernels
   1 and 2, the kernel path within ``LOGIT_ATOL`` of the plain path; one
   warm training step profiled.  (c) Full-width, full-depth paligemma-3b
   (2.51 B, 18 layers, MQA): 256 patch embeddings + 32 text tokens, prefill
   and 16 greedy decode steps from position 288 teacher-forced against
   ``lm.forward`` within ``DENSE_REL``; (d) musicgen-large (3.23 B, 48
   layers): 128 frame embeddings prefilled, 32 decoded as ``(B, 1, d)`` and
   as ``(B, d)`` rows (equal), against ``lm.forward`` within ``DENSE_REL``;
   (e) one AdamW step of each at full width and depth: loss, gradient norm
   and parameters finite, ``ntokens`` the text labels alone, peak memory.
14. GPipe pipeline training (``train/pipeline.py``; see the note above
   ``PIPE``), one card running every stage.  (a) Full-width kanformer-100m
   (8 repeats), phase 13's batch of 8 x 64, ``S`` = 2 and 4 stages at ``M``
   = 4 microbatches and ``S`` = 2 at ``M`` = 8: the pipelined loss within
   ``PIPE_LOSS_RTOL`` of ``lm.lm_loss`` on the same weights and batch, and
   each gradient leaf, mapped back from the staged layout, within
   ``PIPE_GRAD_REL`` of its max|g| of ``train.step.loss_and_grads`` summed
   over the same microbatches (its gap to the whole batch's recorded); each
   schedule again at fp64 compute, each leaf within ``PIPE_GRAD_REL`` of
   its max|g| of the whole batch's ``loss_and_grads`` at fp64; a bf16 run
   finite.  (b) qwen1.5-0.5b at full width and depth (24 repeats), ``S = M
   = 4``, the same checks.  (c) olmoe-1b-7b at full width, 4 of its 16
   repeats, ``S`` = 2, ``M`` = 4: the loss within ``PIPE_LOSS_RTOL`` of
   ``lm.forward``'s token-weighted NLL over each microbatch alone (the
   reference drops the auxiliary losses and routes each microbatch alone),
   the gradients finite, the drop fractions of the whole batch and of the
   microbatches.  Every run counted: no kernel.  Each run's warm ms beside
   the plain ``loss_and_grads``', kernels per step, peak memory, the bubble
   ``(S-1)/(M+S-1)``, and ``costs.model_flops`` as a share of the fp32
   peak (phase 13's warm step prints its share too).
15. A JSON line with every ported kernel's numbers, the card's line, and as
   the last line ``{"ok": true, "device": {...}}``, printed after phase 18.
16. The port's kanlint on the card, where there is no JAX
   (``repro_torch.analysis``): ``python -m repro_torch.analysis --check
   src/repro_torch`` in a subprocess (the static rules, the registry half
   and the card half of KL2xx) must exit 0 with 0 new findings; then the
   card half again in this process: every registry plan equal to its
   library's ``<library>_plan`` export on every problem of the suite
   (PERF.md section 6's shapes and each kernel's admitted extremes), every
   plan within the card's shared-memory, grid and thread budgets, every
   instantiation's registers x threads within a block's and its spills
   within its own record (``kernels/spills.py``; ``ptxas -v``, the log kept
   beside each library); a row per instantiation the main shapes take (registers,
   static and dynamic shared memory, threads, spills), and every spilling
   instantiation by name.  Any finding fails the phase.
17. Mesh serving (``ServeConfig.mesh``; see the note above ``MESH``),
   full-width kanformer-100m from seed 0: phase 4's 8 requests sampled at
   ``SAMPLE_T`` through ``serve_requests`` (batch 4) and the continuous
   cell's 16 requests with budgets cut to ``MESH["budget"]`` through
   ``serve_continuous`` dense, paged shadow (prefix caching) and paged
   step.  (a) The unmeshed engine, then a 1x1 mesh on a one-rank NCCL
   group in this process: every stream bit-equal, every run's launch counts
   equal to the unmeshed run's and to its stats' expectation, a prefix hit.
   (b) The 2x2 rehearsal: four ranks spawned on this one card over gloo
   (``launch.mesh.run_ranks(share_card=True)``) serve the same cells plus
   a 26-block pool that the data axis splits; each rank's launches exact at
   its local shapes (dense rows split over data), its shard shapes those of
   the battery's distribution proofs (``wq`` heads / 2, dense ``k`` rows
   and KV heads / 2, the 26-block pool's blocks / 2, the default 97-block
   pool whole), every rank's streams equal to rank 0's and to the
   unmeshed run's unless the first divergence is a near-tie (top-2 gap
   below ``LOGIT_ATOL``; sampled: of the perturbed scores, times T).  Ms per
   dense decode step unmeshed, 1x1 and in the rehearsal (host-staged
   collectives on one card: not a scale-out figure) beside the card's line.
   olmoe-1b-7b at full width and ``MESH_OLMOE_REPEATS`` = 2 of its 16
   layers (experts on the model axis, routing over the global batch): (a)
   the static sampled cell and continuous dense on 1x1, streams, drop
   fractions and launches (none) equal to the unmeshed engine's; (b) every
   rehearsal cell in the same spawn as kanformer's, each rank's expert
   shards (``wi`` (2, 32, 2048, 1024)) and their bytes, its launches exact
   at its local shapes (kernel 5 on the paged runs), its drop fractions
   equal to rank 0's, its streams equal to rank 0's and to the unmeshed
   run of the same cell unless the first divergence is a logits near-tie
   (``DENSE_TIE``; sampled ``LOGIT_ATOL`` x T) or a router near-tie
   (``MESH_ROUTER_TIE``), the parting step recomputed and its smallest
   router-probability gap printed.  deepseek-v2-lite (MLA) at full width,
   its dense prologue and ``MESH_DEEPSEEK_REPEATS`` = 1 of its 26 MoE
   layers: the static sampled cell and continuous dense (its latent does
   not page), (a) on 1x1 as olmoe's and (b) in the same spawn, each rank's
   shards the reference's placement (``wq`` (1, 2048, 8, 192), ``w_dkv``
   (1, 2048, 288), ``kv_norm`` (1, 256), the dense cache's ``ckv`` (1, 4,
   192, 288): rows over data and 288 of the latent's 576 columns over model;
   32 of 64 experts; the prologue's ffn 5472), its latent cache's bytes a
   quarter of the unmeshed one's, its streams held as olmoe's.
18. Training on a mesh (``train/step.py``'s ``shard``, ZeRO-sharded AdamW,
   ``launch/elastic.py``; see the note above ``MESH_TRAIN``).  (a)
   Full-width kanformer-100m takes ``launch.train``'s recipe for 4 steps of
   batch 8 x 64, unmeshed and on a 1x1 mesh of a one-rank NCCL group
   (``launch.train`` trains on ``(1, world size)`` in a group): losses,
   parameters and ``m``/``v`` bit-equal, launch counts equal (none); ms per
   step and kernels per step (one more step of each under a device-only
   profiler); both trained models serve phase 4's requests statically with
   exact launch counts of kernels 1 and 2 and equal streams.  (b) The 2x2
   rehearsal: four ranks spawned on this one card over gloo train
   kanformer-100m (3 steps, full depth) and qwen1.5-0.5b (2 steps,
   ``QWEN_REPEATS`` layers) at full width from seed 0, each rank's losses
   equal to rank 0's and within ``MESH_LOSS_RTOL`` of the unmeshed run on
   the same weights and batches,
   its parameters held to the unmeshed run's slices (``MESH_BULK``,
   ``MESH_MAX_LR``), no launch, its ZeRO ``m`` shapes those of
   ``tree_zero_specs`` and its ``m`` + ``v`` bytes against the whole.  (c)
   kanformer's checkpoint from the rehearsal at step 2 restored on 1x1 with
   ``restore_elastic`` (bit-equal to the whole checkpoint) and continued to
   step 3: bit-equal to the unmeshed continuation, its loss within
   ``MESH_LOSS_RTOL`` of the rehearsal's straight run and its parameters
   held to the unmeshed straight run's.  Ms per step unmeshed, 1x1 and in
   the rehearsal (not a scale-out figure) beside the card's line.
   olmoe-1b-7b at full width, ``MESH_OLMOE_REPEATS`` layers, batch 8 x 64:
   2 steps unmeshed and on 1x1 bit-equal (losses, parameters, ``m``/``v``;
   no launch; ms and kernels per step), and 2 rehearsal steps held as
   qwen's, with the experts' ``m`` + ``v`` bytes per rank; deepseek-v2-lite
   at ``MESH_DEEPSEEK_REPEATS`` (MLA: heads on model, the latent projection
   gathered whole) the same.  The rehearsal
   also takes one kanformer step with the int8 wire format (its scale's
   ``all_reduce`` MAX over ``model``, gloo on CUDA tensors) and one with
   bf16 parameters under ZeRO (``MESH_TRAIN_VARIANTS``), each held to the
   same step unmeshed (the bf16 one's fp32 master to ``MESH_BF16_BULK``,
   its parameters the master's rounding).

Needs one CUDA card; exits non-zero without one, and when run outside a
checkout of the repository.  Imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,    # CUDA cores, no tensor cores
              "bfloat16": 989e12,  # dense tensor cores
              "int8": 1979e12}     # dense tensor cores, TOPS
FP32_ATOL = 1e-4                   # fp32 sums in another order, |y| ~ 2
BF16_REL = 2.0 ** -7               # one bf16 ulp of max|y| (8 mantissa bits)
LOGIT_ATOL = 2e-3                  # fp32 logits ~|20| after 8 blocks
L2_FLUSH_BYTES = 120e6             # > 2x the 50 MB L2

KERNELS = {
    "kan_fused_gemm": {
        "source": "src/repro_torch/kernels/csrc/kan_fused_gemm.cu",
        "replaces": "src/repro/kernels/kan_fused_gemm.py:52",
        "main_shape": [512, 512, 1024],     # prefill: 4 x 128 rows, c1 layer
    },
    "kan_sparse_gemm": {
        "source": "src/repro_torch/kernels/csrc/kan_sparse_gemm.cu",
        "replaces": "src/repro/kernels/kan_sparse_gemm.py:69",
        "main_shape": [4, 512, 1024],       # decode: 4 rows, c1 layer
    },
    "gather_blocks": {
        "source": "src/repro_torch/kernels/csrc/paged_gather.cu",
        "replaces": "src/repro/kernels/paged_gather.py:45",
        "main_shape": "shadow",             # k and v of one chunk's stacked view
    },
    "kan_int8_gemm": {
        "source": "src/repro_torch/kernels/csrc/kan_int8_gemm.cu",
        "replaces": "src/repro/kernels/kan_int8_gemm.py:45",
        "main_shape": [2048, 784, 64],      # MNIST-KAN layer 1, 2048 inputs
        "path": "int8_2048",
    },
    "kan_sparse_int8_gemm": {
        "source": "src/repro_torch/kernels/csrc/kan_sparse_int8_gemm.cu",
        "replaces": "src/repro/kernels/kan_sparse_gemm.py:167",
        "main_shape": [8, 784, 64],         # MNIST-KAN layer 1, 8 inputs
        "path": "int8_8",
    },
    "bspline_lut": {
        "source": "src/repro_torch/kernels/csrc/bspline_lut.cu",
        "replaces": "src/repro/kernels/bspline_lut.py:25",
        "main_shape": [2048, 784],          # MNIST-KAN layer 1's inputs
        "path": "lut_2048",
    },
}
# the device symbols of the port's kernels, as the profiler names them
PORT_KERNEL_SYMBOLS = ("kan_fused_kernel", "kan_sparse_kernel", "paged_gather_kernel",
                       "kan_int8_kernel", "kan_sparse_int8_kernel", "bspline_lut_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def spin_cycles_per_ms(torch) -> float:
    """Clock cycles per ms of ``torch.cuda._sleep``, the spin kernel that
    holds the stream in :func:`time_ms`."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    torch.cuda.synchronize()
    return 1e7 / start.elapsed_time(end)


def time_ms(torch, fns, cycles_per_ms: float, reps: int = 30) -> float:
    """Mean device ms per call over ``reps`` calls cycling through ``fns``
    (one closure per input copy), timed with CUDA events after a warm-up.

    A call whose kernels are shorter than its host-side launch cost would
    otherwise be timed at the host's launch rate; so a spin kernel holds
    the stream, for twice as long as the calls took untimed, while the
    host enqueues every call, and the events time the device's work only.
    Where the host was slower than that (a pause of the host, not of the
    card), the run is taken again behind a spin twice as long, at most
    five times.
    """
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    untimed_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for factor in (2, 4, 8, 16, 32):
        torch.cuda._sleep(int(cycles_per_ms * (factor * untimed_ms + 5)))
        start.record()
        for i in range(reps):
            fns[i % len(fns)]()
        end.record()
        held = not end.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
    raise RuntimeError("the spin kernel ended before the host enqueued every call")


def special_inputs(torch, rows, K, dtype, grid, seed):
    """tanh of normals (the FFN feeds tanh'd activations), with x_min,
    x_max, every knot and out-of-domain values planted at the front."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.tanh(torch.randn(rows, K, generator=g, device="cuda"))
    plant = [grid.x_min, grid.x_max, *grid.knots().tolist(), -3.0, 2.5, -1.0001, 1.0001]
    flat = x.view(-1)
    n = min(len(plant), flat.numel())
    flat[:n] = torch.tensor(plant[:n], device="cuda")
    return x.to(dtype)


def check_kernels(torch, grid):
    from repro_torch.core.bspline import SplineGrid
    from repro_torch.kernels import kan_fused_gemm as F
    from repro_torch.kernels import kan_sparse_gemm as S
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import band_scatter, compact_basis_inblock

    M, P = grid.n_basis, grid.P
    plain = {"kan_fused_gemm": F.kan_fused_gemm_reference,
             "kan_sparse_gemm": S.kan_sparse_gemm_reference}
    wrapper = {"kan_fused_gemm": ops.kan_fused_gemm,
               "kan_sparse_gemm": ops.kan_sparse_gemm}
    # (kernel, rows, K, N): the main path's layer shapes (c1: 512 -> 1024,
    # c2: 1024 -> 512; prefill at 4 x 128 rows, decode at 1, 4, 8 rows)
    # and one ragged shape for each kernel
    # The verify window of phase 6b (8 slots x W = 5) gives both layers 40
    # rows: the fused kernel's shape there, and a yardstick for the sparse one
    cases = [("kan_fused_gemm", r, K, N) for r in (512, SPEC_ROWS)
             for K, N in ((512, 1024), (1024, 512))]
    cases += [("kan_fused_gemm", 13, 100, 200)]
    cases += [("kan_sparse_gemm", r, K, N) for r in (1, 4, 8, SPEC_ROWS)
              for K, N in ((512, 1024), (1024, 512))]
    cases += [("kan_sparse_gemm", 13, 100, 200)]
    results = {name: {"max_abs_err": 0.0, "timed": []} for name in plain}
    seed = 0
    for name, rows, K, N in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for with_base in (True, False):
                seed += 1
                g = torch.Generator(device="cuda").manual_seed(1000 + seed)
                x = special_inputs(torch, rows, K, dtype, grid, seed)
                c = (0.02 * torch.randn(K, M, N, generator=g, device="cuda")).to(dtype)
                w = ((0.02 * torch.randn(K, N, generator=g, device="cuda")).to(dtype)
                     if with_base else None)
                y = wrapper[name](x, c, grid, w)
                if not torch.equal(y, wrapper[name](x, c, grid, w)):
                    raise RuntimeError(f"{name} {rows}x{K}->{N}: two calls differ")
                torch.cuda.synchronize()
                ref = plain[name](x, c, grid, w)
                err = (y.float() - ref.float()).abs().max().item()
                if not torch.isfinite(y.float()).all():
                    raise RuntimeError(f"{name} {rows}x{K}->{N}: non-finite output")
                tol = (FP32_ATOL if dtype == torch.float32
                       else BF16_REL * ref.float().abs().max().item())
                ok = err <= tol
                log(f"[check] {name} rows={rows} K={K} N={N} {str(dtype)[6:]} "
                    f"base={with_base} max_abs_err={err:.3e} tol={tol:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError(f"{name} disagrees with its plain version")
                if dtype == torch.float32:
                    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
                if with_base and rows != 13 and (dtype == torch.float32 or rows in (512, 4)):
                    results[name]["timed"].append((rows, K, N, dtype, grid))
    # the fused and sparse kernels where the fp32 MNIST-KAN net launches
    # them (phase 7: 2048 and 8 inputs, G=10, M=13; checked there against
    # the plain path)
    mnist = SplineGrid(-1.0, 1.0, MNIST["G"], MNIST["P"])
    for name, rows in (("kan_fused_gemm", MNIST["rows"]),
                       ("kan_sparse_gemm", MNIST["decode_rows"])):
        results[name]["timed"] += [
            (rows, K, N, torch.float32, mnist)
            for K, N in zip(MNIST["layers"][:-1], MNIST["layers"][1:])]

    # timing at the main path's shapes: both FFN layers, fp32 at every row
    # count, bf16 at prefill's 512 and decode's 4 rows
    cycles_per_ms = spin_cycles_per_ms(torch)
    for name in plain:
        for rows, K, N, dtype, grid in results[name]["timed"]:
            M = grid.n_basis
            dname = str(dtype)[6:]
            esize = torch.tensor([], dtype=dtype).element_size()
            set_bytes = (K * M * N + K * N) * esize
            n_sets = max(1, math.ceil(L2_FLUSH_BYTES / set_bytes))
            g = torch.Generator(device="cuda").manual_seed(7)
            x = special_inputs(torch, rows, K, dtype, grid, 99)
            sets = [((0.02 * torch.randn(K, M, N, generator=g, device="cuda")).to(dtype),
                     (0.02 * torch.randn(K, N, generator=g, device="cuda")).to(dtype))
                    for _ in range(n_sets)]
            vals, k = compact_basis_inblock(x, grid)
            band = band_scatter(vals, k, M).to(dtype).reshape(rows, K * M)
            a_lib = torch.cat([band, torch.clamp_min(x, 0)], dim=1)
            w_lib = [torch.cat([c.reshape(K * M, N), w], dim=0) for c, w in sets]
            ms = time_ms(torch, [lambda c=c, w=w: wrapper[name](x, c, grid, w)
                                 for c, w in sets], cycles_per_ms)
            plain_ms = time_ms(torch, [lambda c=c, w=w: plain[name](x, c, grid, w)
                                       for c, w in sets], cycles_per_ms, reps=10)
            lib_ms = time_ms(torch, [lambda wl=wl: torch.matmul(a_lib, wl) for wl in w_lib],
                             cycles_per_ms)
            # one function for both kernels: P+1 basis products and one base
            # product per input and output (the fused kernel's dense band
            # multiplies M-(P+1) zeros more, which the bound does not count)
            flops = 2.0 * rows * K * (P + 2) * N
            xb, yb = rows * K * esize, rows * N * esize
            if name == "kan_fused_gemm":
                nbytes = xb + set_bytes + yb
            else:
                touched = torch.zeros(K, M, dtype=torch.bool, device="cuda")
                for i in range(P + 1):
                    touched[torch.arange(K, device="cuda")[None, :].expand(rows, K),
                            (k.long() - P + i)] = True
                n_touched = int(touched.sum().item())
                nbytes = xb + (n_touched * N + K * N) * esize + yb
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(t_ops, t_bytes)
            entry = {"shape": [rows, K, N], "M": M, "dtype": dname, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bound,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "flops": flops, "bytes": nbytes}
            results[name].setdefault("timings", []).append(entry)
            log(f"[time] {name} rows={rows} K={K} N={N} M={M} {dname}: kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} "
                f"({entry['bound_by']}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return results


# Phase 6: the continuous paged path.  The cell: 16 requests, prompt
# lengths in 32..128, every other one starting with the same 64-token
# prefix (4 blocks), budgets in 8..48, 8 slots, 8-step chunks, 16-token
# blocks, max_seq 192, EOS off.
CONT = {"n_req": 16, "slots": 8, "chunk_steps": 8, "block_size": 16, "max_seq": 192,
        "prefix_len": 64}
CONT_RUNS = [("dense", {}), ("paged_shadow", {"paged": True}),
             ("paged_step", {"paged": True, "paged_read": "step"}),
             ("paged_preempt", {"paged": True, "pool_blocks": 25})]
# the gather at its two main-path uses, both leaves (k, v) in one launch:
# the 8 stacked layers of the shadow view, and one layer in step mode; pool
# of the default size (8 slots x 12 logical blocks + sentinel)
GATHER_USES = {"shadow": (True, 8), "step": (False, 8)}
GATHER_POOL = (97, 16, 8, 64)                 # (n_blocks, block_size, KV, D)
GATHER_LEAVES = ("k", "v")
# Phase 6b: the same cell served speculatively; "full" is the target's depth
SPEC_K = 4
SPEC_ROWS = CONT["slots"] * (SPEC_K + 1)       # the verify window's rows
SPEC_RUNS = [("spec_dense", {"draft_layers": 1}),
             ("spec_paged_shadow", {"paged": True}),
             ("spec_paged_step", {"paged": True, "paged_read": "step"}),
             ("spec_paged_preempt", {"paged": True, "pool_blocks": 25}),
             ("spec_full_drafter", {"draft_layers": "full"})]


def continuous_requests(np, vocab: int):
    """The continuous cell's requests and budgets, from seed 12."""
    rs = np.random.RandomState(12)
    prefix = rs.randint(0, vocab, CONT["prefix_len"]).astype(np.int32)
    lens = rs.randint(32, 129, CONT["n_req"])
    budgets = [int(b) for b in rs.randint(8, 49, CONT["n_req"])]
    reqs = []
    for i, L in enumerate(lens):
        r = rs.randint(0, vocab, L).astype(np.int32)
        if i % 2:
            n = min(int(L), CONT["prefix_len"])
            r[:n] = prefix[:n]
        reqs.append(r)
    return reqs, budgets


def engine_table(torch, np, slots: int, n_logical: int, n_blocks: int, seed: int):
    """A block table as the engine builds one: each slot maps its first
    logical blocks to live blocks of its own, the rest to the sentinel."""
    rs = np.random.RandomState(seed)
    ids = rs.permutation(np.arange(1, n_blocks))[: slots * n_logical].reshape(slots, n_logical)
    for b in range(slots):
        ids[b, rs.randint(3, n_logical + 1):] = 0
    return torch.tensor(ids.astype(np.int32), device="cuda")


def gather_bytes(torch, pools, table, stacked: bool) -> int:
    """The bytes a gather of ``pools`` (leaves of one table) must move: for
    each leaf every distinct block the table names, read once per layer,
    and its view, written once; the table, read once."""
    total = table.numel() * 4
    for p in pools:
        n_blocks = p.shape[1 if stacked else 0]
        n_distinct = int(torch.unique(table.reshape(-1).long().clamp(0, n_blocks - 1)).numel())
        block = math.prod(p.shape[2 if stacked else 1:]) * p.element_size()
        total += (p.shape[0] if stacked else 1) * (n_distinct + table.numel()) * block
    return total


def check_gather(torch, np):
    """The gather kernel against its plain version, bitwise, and timed at
    both uses: for one leaf, and as the paths call it, both leaves of a
    cache (``k`` and ``v``) in one launch."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_gather as PG

    cycles_per_ms = spin_cycles_per_ms(torch)
    n_blocks, bs = GATHER_POOL[:2]
    result = {"max_abs_err": 0.0, "timings": []}
    for use, (stacked, layers) in GATHER_USES.items():
        table = engine_table(torch, np, CONT["slots"], CONT["max_seq"] // bs, n_blocks, 5)
        idx = table.reshape(-1).long().clamp(0, n_blocks - 1)
        ax = 1 if stacked else 0
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            shape = ((layers,) if stacked else ()) + GATHER_POOL
            esize = torch.tensor([], dtype=dtype).element_size()
            n_sets = max(1, math.ceil(L2_FLUSH_BYTES / (math.prod(shape) * esize)))
            g = torch.Generator(device="cuda").manual_seed(11)
            caches = [{name: torch.randn(shape, generator=g, device="cuda").to(dtype)
                       for name in GATHER_LEAVES} for _ in range(n_sets)]
            got = ops.gather_views(caches[0], table, stacked)
            torch.cuda.synchronize()
            want = PG.gather_views_reference(caches[0], table, stacked)
            err = max((got[n].float() - want[n].float()).abs().max().item() for n in want)
            ok = list(got) == list(want) and all(torch.equal(got[n], want[n]) for n in want)
            log(f"[check] gather_views {use} leaves {list(want)} pool={list(shape)} "
                f"table={list(table.shape)} {dname} bitwise_equal={ok} max_abs_err={err:.1e}")
            if not ok:
                raise RuntimeError("gather_views disagrees with its plain version")
            result["max_abs_err"] = max(result["max_abs_err"], err)
            for leaves in (1, 2):
                subs = [{n: c[n] for n in GATHER_LEAVES[:leaves]} for c in caches]
                ms = time_ms(torch, [lambda c=c: ops.gather_views(c, table, stacked)
                                     for c in subs], cycles_per_ms)
                plain_ms = time_ms(torch, [lambda c=c: PG.gather_views_reference(c, table, stacked)
                                           for c in subs], cycles_per_ms)
                lib_ms = time_ms(torch, [lambda c=c: [torch.index_select(p, ax, idx)
                                                      for p in c.values()] for c in subs],
                                 cycles_per_ms)
                nbytes = gather_bytes(torch, list(subs[0].values()), table, stacked)
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                entry = {"use": use, "leaves": leaves, "pool": list(shape),
                         "table": list(table.shape), "dtype": dname, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "library": f"index_select x{leaves} (one per leaf)", "bound_ms": bound,
                         "bound_by": "bytes", "bytes": nbytes,
                         "distinct_blocks": int(torch.unique(idx).numel())}
                result["timings"].append(entry)
                log(f"[time] gather_views {use} {leaves} {'leaves' if leaves > 1 else 'leaf'} "
                    f"(one launch) {dname}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms={lib_ms:.4f} ({entry['library']}) bound_ms={bound:.4f} "
                    f"(bytes: {nbytes / 1e6:.2f} MB, {entry['distinct_blocks']} distinct blocks)")
    check_gather_dense(torch, np, result, cycles_per_ms)
    check_gather_dense(torch, np, result, cycles_per_ms, pool=OLMOE_POOL, tag="olmoe",
                       quant=False)
    return result


# Phase 10's pools: qwen1.5-0.5b's k/v at the continuous cell's pool (24
# layers, 97 blocks of 16 tokens, 16 KV heads, head_dim 64), fp32 (k, v)
# and int8 (k, v int8 with their fp32 k_scale, v_scale: four leaves, two
# element sizes, in one launch)
QWEN_POOL = (24, 97, 16, 16, 64)
# Phase 11's: olmoe-1b-7b's k/v at the same cell (16 layers, 16 KV heads,
# head_dim 128), fp32
OLMOE_POOL = (16, 97, 16, 16, 128)


def check_gather_dense(torch, np, result: dict, cycles_per_ms: float, pool=QWEN_POOL,
                       tag="qwen", quant=True) -> None:
    """The gather at a model's pool shapes (qwen's by default), shadow
    (stacked, every layer) and step (one layer) reads: fp32 k and v, and
    (``quant``) the four leaves of an int8 cache, each bit-equal to the
    plain version and timed (kernel, plain version, ``index_select`` per
    leaf, byte bound)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_gather as PG

    layers, n_blocks, bs, kv, hd = pool
    table = engine_table(torch, np, CONT["slots"], CONT["max_seq"] // bs, n_blocks, 5)
    idx = table.reshape(-1).long().clamp(0, n_blocks - 1)
    g = torch.Generator(device="cuda").manual_seed(23)
    kinds = [("float32", {"k": torch.randn(pool, generator=g, device="cuda"),
                          "v": torch.randn(pool, generator=g, device="cuda")})]
    if quant:
        q8 = {n: torch.randint(-127, 128, pool, generator=g, device="cuda",
                               dtype=torch.int8) for n in ("k", "v")}
        for n in ("k", "v"):
            q8[n + "_scale"] = torch.rand(pool[:-1], generator=g, device="cuda") / 127
        kinds.append(("int8+float32", q8))
    for use, stacked in ((f"{tag}_shadow", True), (f"{tag}_step", False)):
        ax = 1 if stacked else 0
        for dname, cache in kinds:
            # a step read's copies: the 24 layers in turn (L2 stays cold)
            subs = [cache] if stacked else [{n: a[i] for n, a in cache.items()}
                                            for i in range(layers)]
            c = subs[0]
            got = ops.gather_views(c, table, stacked)
            torch.cuda.synchronize()
            want = PG.gather_views_reference(c, table, stacked)
            ok = list(got) == list(want) and all(torch.equal(got[n], want[n]) for n in want)
            err = max((got[n].float() - want[n].float()).abs().max().item() for n in want)
            log(f"[check] gather_views {use} leaves {[f'{n}:{str(a.dtype)[6:]}' for n, a in c.items()]} "
                f"pool={list(c['k'].shape)} table={list(table.shape)} bitwise_equal={ok} "
                f"max_abs_err={err:.1e}")
            if not ok:
                raise RuntimeError(f"gather_views ({use}, {dname}) disagrees with its plain version")
            result["max_abs_err"] = max(result["max_abs_err"], err)
            ms = time_ms(torch, [lambda c=c: ops.gather_views(c, table, stacked) for c in subs],
                         cycles_per_ms)
            plain_ms = time_ms(torch, [lambda c=c: PG.gather_views_reference(c, table, stacked)
                                       for c in subs], cycles_per_ms)
            lib_ms = time_ms(torch, [lambda c=c: [torch.index_select(p, ax, idx)
                                                  for p in c.values()] for c in subs],
                             cycles_per_ms)
            nbytes = gather_bytes(torch, list(c.values()), table, stacked)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            entry = {"use": use, "leaves": len(c), "pool": list(c["k"].shape),
                     "table": list(table.shape), "dtype": dname, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library": f"index_select x{len(c)} (one per leaf)",
                     "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes,
                     "distinct_blocks": int(torch.unique(idx).numel())}
            result["timings"].append(entry)
            log(f"[time] gather_views {use} {len(c)} leaves (one launch) {dname}: "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"({entry['library']}) bound_ms={bound:.4f} (bytes: {nbytes / 1e6:.2f} MB)")


def expected_launches(model, stats: dict, run: dict, slots: int = CONT["slots"],
                      chunk_steps: int = CONT["chunk_steps"]) -> dict:
    """The launches a continuous run implies, from its own stats: per
    admission prefill two KAN layers per block (fused or sparse, by its row
    count) and, paged, one gather per layer (both leaves in one launch);
    per decode step two KAN layers per block at ``slots`` rows; per chunk,
    shadow reads, one gather per unit block (its leaves and stacked layers
    in one launch) and per prologue or epilogue block, or step reads, one
    per layer per step.

    A speculative run (``stats["spec"]``) decodes in windows instead: per
    drafter admission prefill two KAN layers per drafter block; per window
    ``spec_k`` drafter steps at ``slots`` rows and one verify pass of the
    whole target at ``slots·W`` rows; paged, per window one gather per
    unit block (shadow) or one per layer (step)."""
    from repro_torch.core import kan_layer as KL
    from repro_torch.kernels import ops

    def kernel(rows: int) -> str:
        return "kan_" + KL.resolve_inference_method("cuda", rows) + "_gemm"

    blocks = model.prologue + model.unit * model.n_repeats + model.epilogue
    per_layer = 2 * sum(b.kind == "attn_kan" for b in model.unit)   # MLP FFNs: none
    kan, layers = 2 * sum(b.kind == "attn_kan" for b in blocks), len(blocks)
    want = dict.fromkeys(ops.LAUNCHES, 0)
    paged = run.get("paged", False)
    # a shadow read gathers each prologue and epilogue block on its own
    shadow = len(model.prologue) + len(model.unit) + len(model.epilogue)
    reads = (layers if run.get("paged_read") == "step" else shadow) if paged else 0
    for k, t_pad in stats["prefill_groups"]:
        want[kernel(k * t_pad)] += kan
        want["gather_blocks"] += layers if paged else 0
    if "spec" in stats:
        sp = stats["spec"]
        draft = per_layer * sp["draft_layers"]
        for k, t_pad in stats["draft_prefill_groups"]:
            want[kernel(k * t_pad)] += draft
        want[kernel(slots)] += sp["windows"] * sp["spec_k"] * draft
        want[kernel(slots * (sp["spec_k"] + 1))] += sp["windows"] * kan
        want["gather_blocks"] += sp["windows"] * reads
        return want
    steps = stats["chunks_run"] * chunk_steps
    want[kernel(slots)] += steps * kan
    if paged:
        step_reads = run.get("paged_read") == "step"
        want["gather_blocks"] += steps * layers if step_reads else stats["chunks_run"] * reads
    return want


def stream_gaps(torch, np, params, cfg, prompt, stream, device="cuda"):
    """The top-2 logit gap (static path, one prefill) of every token of
    ``stream``: entry ``j`` is the gap of the logits that predict
    ``stream[j]`` from ``prompt`` and ``stream[:j]``."""
    from repro_torch.models import lm

    seq = np.concatenate([prompt, stream[:-1]]).astype(np.int64)
    logits, _ = lm.prefill(params, cfg, torch.as_tensor(seq[None], device=device), len(seq))
    top = torch.topk(logits[0, len(prompt) - 1:], 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu().numpy()


def continuous_path(torch, np):
    import dataclasses

    from repro_torch.configs import kanformer_100m
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_gather as PG
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.kv_pool import blocks_for

    cfg = kanformer_100m.config().model
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    reqs, budgets = continuous_requests(np, cfg.vocab)
    lens = [len(r) for r in reqs]
    base = ServeConfig(max_seq=CONT["max_seq"], max_new_tokens=max(budgets),
                       block_size=CONT["block_size"])
    log(f"[cont] {CONT['n_req']} requests, prompt lengths {lens}, budgets {budgets}, "
        f"every other one starting with the same {CONT['prefix_len']}-token prefix; "
        f"slots {CONT['slots']}, chunk_steps {CONT['chunk_steps']}, block_size "
        f"{CONT['block_size']}, max_seq {CONT['max_seq']}, eos off")

    def serve(eng):
        return eng.serve_continuous(reqs, slots=CONT["slots"],
                                    chunk_steps=CONT["chunk_steps"], max_new=budgets)

    runs, engines = {}, {}
    for name, extra in CONT_RUNS:
        eng = engines[name] = Engine(params, cfg, dataclasses.replace(base, **extra),
                                     device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        outs = serve(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        st = eng.last_serve_stats
        want = expected_launches(cfg, st, extra)
        log(f"[cont] {name}: launches {launches}, expected {want}")
        if launches != want:
            raise RuntimeError(f"{name}: launch counts {launches} != expected {want}")
        pg = st.get("paged", {})
        lat = sorted(st["request_latency_s"])
        m = {"tok_s": st["useful_tokens"] / wall, "wall_s": wall,
             "latency_mean_s": sum(lat) / len(lat),
             "latency_p95_s": lat[min(len(lat) - 1, math.ceil(0.95 * len(lat)) - 1)],
             "useful_tokens": st["useful_tokens"],
             "mean_slot_utilization": st["mean_slot_utilization"],
             "chunks": st["chunks_run"], "n_preemptions": st["n_preemptions"],
             "prefill_groups": len(st["prefill_groups"]),
             "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
             "decode_ms_per_step": st["decode_s"] * 1e3 / (st["chunks_run"] * CONT["chunk_steps"]),
             "prefill_tokens_computed": pg.get("prefill_tokens_computed", sum(lens)),
             "prefill_tokens_saved": pg.get("prefill_tokens_saved", 0),
             "prefix_hit_blocks": pg.get("prefix_hit_blocks", 0),
             "prefix_evictions": pg.get("prefix_evictions", 0),
             "blocks_watermark": pg.get("blocks_in_use_watermark"),
             "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": launches}
        log(f"[cont] {name}: {m['useful_tokens']} tokens in {wall:.3f} s: {m['tok_s']:.1f} tok/s; "
            f"latency mean {m['latency_mean_s']:.3f} s p95 {m['latency_p95_s']:.3f} s; "
            f"slot utilization {m['mean_slot_utilization']:.3f}; chunks {m['chunks']} "
            f"({m['decode_ms_per_step']:.3f} ms per decode step); admission prefills "
            f"{m['prefill_groups']} ({m['prefill_s'] * 1e3:.1f} ms); preemptions "
            f"{m['n_preemptions']}; prefill tokens computed {m['prefill_tokens_computed']} "
            f"saved {m['prefill_tokens_saved']}; prefix hit blocks {m['prefix_hit_blocks']} "
            f"evictions {m['prefix_evictions']}; block watermark {m['blocks_watermark']}; "
            f"peak_mem_GB={m['peak_mem_bytes'] / 1e9:.3f}")
        if extra.get("paged") and m["prefill_tokens_saved"] <= 0:
            raise RuntimeError(f"{name}: no prefix hit")
        if name == "paged_preempt" and m["n_preemptions"] < 1:
            raise RuntimeError(f"{name}: the tight pool preempted nothing")
        for o, b in zip(outs, budgets):
            if o.shape != (b,) or o.min() < 0 or o.max() >= cfg.vocab:
                raise RuntimeError(f"{name}: bad output {o}")
        runs[name] = (outs, m)

    # every stream against the request served alone on the static path;
    # a divergence must start at a near-tie of the static path's logits
    static = Engine(params, cfg, base, device="cuda")
    solo = [static.generate(r[None], max_new=b)[0] for r, b in zip(reqs, budgets)]
    gaps = {}

    def top2_gap(i: int, j: int) -> float:
        if i not in gaps:
            gaps[i] = stream_gaps(torch, np, params, cfg, reqs[i], solo[i])
        return float(gaps[i][j])

    divergences = []
    for name, (outs, _) in runs.items():
        for i, (o, s_) in enumerate(zip(outs, solo)):
            diff = np.nonzero(o != s_)[0]
            if diff.size:
                j = int(diff[0])
                gap = top2_gap(i, j)
                divergences.append({"run": name, "request": i, "step": j, "top2_gap": gap})
                log(f"[cont] {name}: request {i} diverges from its solo stream at step {j}; "
                    f"top-2 logit gap on the static path {gap:.3e} (tol {LOGIT_ATOL:.1e})")
                if gap >= LOGIT_ATOL:
                    raise RuntimeError(f"{name}: request {i} diverges at step {j}, not a near-tie")
    n_equal = sum(np.array_equal(a, b) for outs, _ in runs.values() for a, b in zip(outs, solo))
    log(f"[cont] streams equal to the solo static stream: {n_equal} of "
        f"{len(runs) * len(reqs)}; near-tie divergences: {len(divergences)}")

    # one admission group teacher-forced through the paged prefill and 4
    # paged decode steps: kernel path against plain path
    group = list(range(4))
    bs = CONT["block_size"]
    n_logical = CONT["max_seq"] // bs
    need = [blocks_for(lens[i] + 4, bs) for i in group]
    tables = np.zeros((len(group), n_logical), np.int32)
    nxt = 1
    for r, n in enumerate(need):
        tables[r, :n] = np.arange(nxt, nxt + n)
        nxt += n
    t_pad = -(-max(lens[i] for i in group) // 8) * 8
    toks = torch.as_tensor(np.stack([np.pad(reqs[i], (0, t_pad - lens[i])) for i in group])
                           .astype(np.int64), device="cuda")
    glens = torch.as_tensor(np.asarray([lens[i] for i in group], np.int64), device="cuda")
    tbl = torch.as_tensor(tables, device="cuda")
    forced = [torch.as_tensor(np.asarray([solo[i][s] for i in group], np.int64),
                              device="cuda")[:, None] for s in range(4)]
    kernel_gather = ops.gather_views

    def run(plain: bool):
        if plain:
            os.environ["KAN_SAS_INFERENCE_METHOD"] = "compact"
            ops.gather_views = PG.gather_views_reference
        try:
            caches = lm.init_paged_caches(cfg, nxt, bs, torch.float32, "cuda")
            last, caches = lm.prefill_into_pages(params, cfg, toks, glens, tbl, caches, 0,
                                                 torch.float32, blocks_for(t_pad, bs))
            got = [last]
            pos = glens.clone()
            for s in range(4):
                lg, caches = lm.decode_step(params, cfg, forced[s], caches, pos,
                                            torch.float32, tbl)
                got.append(lg)
                pos = pos + 1
            return torch.stack(got)
        finally:
            os.environ.pop("KAN_SAS_INFERENCE_METHOD", None)
            ops.gather_views = kernel_gather

    kern, ref = run(False), run(True)
    err = (kern - ref).abs().max().item()
    agree = (kern.argmax(-1) == ref.argmax(-1)).float().mean().item()
    if not (torch.isfinite(kern).all() and kern.shape == (5, len(group), cfg.vocab)):
        raise RuntimeError("paged logits not finite or of the wrong shape")
    log(f"[cont] paged kernel vs plain path logits (prefill + 4 decode steps, "
        f"{len(group)} rows): max_abs_err={err:.3e} tol={LOGIT_ATOL:.1e} "
        f"greedy_agreement={agree:.3f}")
    if err > LOGIT_ATOL:
        raise RuntimeError("paged kernel path logits disagree with the plain path")

    # one warm repeat of the shadow and the step run, then each under the
    # profiler
    warm = {}
    for name in ("paged_shadow", "paged_step"):
        eng = engines[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = serve(eng)
        torch.cuda.synchronize()
        warm_wall = time.perf_counter() - t0
        if any(not np.array_equal(a, o) for a, o in zip(again, runs[name][0])):
            raise RuntimeError(f"a second {name} run gave other tokens")
        st = eng.last_serve_stats
        warm[name] = {"tok_s": st["useful_tokens"] / warm_wall, "wall_s": warm_wall,
                      "decode_steps": st["chunks_run"] * CONT["chunk_steps"],
                      "decode_ms_per_step": st["decode_s"] * 1e3
                      / (st["chunks_run"] * CONT["chunk_steps"]),
                      "prefill_s": st["prefill_s"]}
        log(f"[cont] {name} warm: {warm[name]['tok_s']:.1f} tok/s, "
            f"{warm[name]['decode_ms_per_step']:.3f} ms per decode step, admission prefills "
            f"{warm[name]['prefill_s'] * 1e3:.1f} ms")
    profs = {name: profile_call(
        torch, lambda name=name: serve(engines[name]),
        lambda name=name: f"one {name} run ({warm[name]['decode_steps']} decode steps)",
        keep_names=True) for name in warm}
    extra = step_reads_extra(profs, warm)
    return {"runs": {k: m for k, (_, m) in runs.items()}, "divergences": divergences,
            "logit_max_abs_err": err, "greedy_agreement": agree,
            "warm_shadow": warm["paged_shadow"], "warm_step": warm["paged_step"],
            "profile": profs["paged_shadow"], "profile_step": profs["paged_step"],
            "step_reads_extra": extra}, runs["dense"][0]


def step_reads_extra(profs: dict, warm: dict) -> dict:
    """What a paged decode step with step reads costs beyond one with
    shadow reads: the warm runs' host-clock decode ms per step, and from
    the two profiled runs (the same admissions and decode steps) the device
    busy time and the kernels by name whose count or time grew most, per
    decode step."""
    a, b = profs["paged_shadow"], profs["paged_step"]
    if a.get("busy_share") is None or b.get("busy_share") is None:
        return {}
    na, nb = warm["paged_shadow"]["decode_steps"], warm["paged_step"]["decode_steps"]
    names_a, names_b = a.pop("by_name"), b.pop("by_name")
    diff = {}
    for name in set(names_a) | set(names_b):
        ta, ca = names_a.get(name, (0.0, 0))
        tb, cb = names_b.get(name, (0.0, 0))
        diff[name] = ((tb / nb - ta / na) / 1e3, cb / nb - ca / na)
    out = {"decode_ms": warm["paged_step"]["decode_ms_per_step"]
           - warm["paged_shadow"]["decode_ms_per_step"],
           "busy_ms": b["busy_ms"] / nb - a["busy_ms"] / na,
           "kernels": b["kernels"] / nb - a["kernels"] / na}
    out["by_name"] = [{"name": n[:200], "ms": t, "count": c} for n, (t, c) in
                      sorted(diff.items(), key=lambda kv: -abs(kv[1][1]))[:10]]
    log(f"[cont] step reads beyond shadow reads, per decode step: decode wall "
        f"{out['decode_ms']:+.3f} ms (warm runs, host clock); device busy "
        f"{out['busy_ms']:+.3f} ms and kernels {out['kernels']:+.1f} (profiled runs)")
    for e in out["by_name"]:
        log(f"[cont]   {e['count']:+7.2f} launches {e['ms'] * 1e3:+8.2f} us  {e['name'][:110]}")
    return out


def speculative_path(torch, np, dense=None, device="cuda", cfg=None):
    """Phase 6b (any miss raises): the continuous cell served with greedy
    speculative windows, five runs, each held to its exact launch counts
    and every stream to ``dense`` (phase 6's dense streams; computed here
    when None); then one admission group teacher-forced through the verify
    window and through sequential decode steps.  ``device="cpu"`` with a
    reduced ``cfg`` rehearses it on the kernels' plain versions."""
    import dataclasses

    from repro_torch.configs import kanformer_100m
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_gather as PG
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.kv_pool import blocks_for

    cfg = cfg or kanformer_100m.config().model
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    params = lm.init_params(cfg, seed=0, device=device, dtype=torch.float32)
    reqs, budgets = continuous_requests(np, cfg.vocab)
    lens = [len(r) for r in reqs]
    base = ServeConfig(max_seq=CONT["max_seq"], max_new_tokens=max(budgets),
                       block_size=CONT["block_size"], spec_k=SPEC_K)

    def serve(eng):
        return eng.serve_continuous(reqs, slots=CONT["slots"],
                                    chunk_steps=CONT["chunk_steps"], max_new=budgets)

    if dense is None:
        dense = serve(Engine(params, cfg, dataclasses.replace(base, spec_k=0), device=device))
    gaps = {}

    def gap(i: int, j: int) -> float:
        if i not in gaps:
            gaps[i] = stream_gaps(torch, np, params, cfg, reqs[i], dense[i], device)
        return float(gaps[i][j])

    log(f"[spec] the continuous cell's {CONT['n_req']} requests, spec_k {SPEC_K} "
        f"(verify windows of {SPEC_ROWS} rows), {CONT['slots']} slots, eos off")
    runs, divergences, engines, streams = {}, [], {}, {}
    for name, extra in SPEC_RUNS:
        if extra.get("draft_layers") == "full":
            extra = dict(extra, draft_layers=cfg.n_repeats)
        eng = engines[name] = Engine(params, cfg, dataclasses.replace(base, **extra),
                                     device=device)
        sync()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        outs = serve(eng)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        st = eng.last_serve_stats
        sp = st["spec"]
        want = (expected_launches(cfg, st, extra) if device == "cuda"
                else dict.fromkeys(ops.LAUNCHES, 0))
        log(f"[spec] {name}: launches {launches}, expected {want}")
        if launches != want:
            raise RuntimeError(f"{name}: launch counts {launches} != expected {want}")
        pg = st.get("paged", {})
        if pg and pg["blocks_in_use"] != pg["blocks_cache_held"]:
            raise RuntimeError(f"{name}: the pool is not balanced after the drain: {pg}")
        m = {"tok_s": st["useful_tokens"] / wall, "wall_s": wall,
             "useful_tokens": st["useful_tokens"], "draft_layers": sp["draft_layers"],
             "windows": sp["windows"], "ms_per_window": st["decode_s"] * 1e3 / sp["windows"],
             "proposed_drafts": sp["proposed_drafts"], "accepted_drafts": sp["accepted_drafts"],
             "acceptance_rate": sp["acceptance_rate"],
             "emitted_per_window": sp["emitted_tokens"] / sp["windows"],
             "mean_slot_utilization": st["mean_slot_utilization"],
             "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
             "n_preemptions": st["n_preemptions"], "blocks_watermark": pg.get(
                 "blocks_in_use_watermark"),
             "peak_mem_bytes": torch.cuda.max_memory_allocated() if device == "cuda" else None,
             "launches": launches}
        log(f"[spec] {name}: {m['useful_tokens']} tokens in {wall:.3f} s: {m['tok_s']:.1f} tok/s; "
            f"windows {m['windows']} ({m['ms_per_window']:.3f} ms host per window); drafts "
            f"proposed {m['proposed_drafts']} accepted {m['accepted_drafts']} (rate "
            f"{m['acceptance_rate']:.4f}); {m['emitted_per_window']:.2f} tokens per window; "
            f"admission prefills {m['prefill_s'] * 1e3:.1f} ms; preemptions "
            f"{m['n_preemptions']}; block watermark {m['blocks_watermark']}; peak_mem_GB="
            f"{(m['peak_mem_bytes'] or 0) / 1e9:.3f}")
        for i, (o, b) in enumerate(zip(outs, budgets)):
            if o.shape != (b,) or o.min() < 0 or o.max() >= cfg.vocab:
                raise RuntimeError(f"{name}: bad output {o}")
            diff = np.nonzero(o != dense[i])[0]
            if diff.size:
                j = int(diff[0])
                g = gap(i, j)
                divergences.append({"run": name, "request": i, "step": j, "top2_gap": g})
                log(f"[spec] {name}: request {i} diverges from the dense stream at step {j}; "
                    f"top-2 logit gap {g:.3e} (tol {LOGIT_ATOL:.1e})")
                if g >= LOGIT_ATOL:
                    raise RuntimeError(f"{name}: request {i} diverges at step {j}, not a near-tie")
        if name == "spec_paged_preempt" and m["n_preemptions"] < 1:
            raise RuntimeError(f"{name}: the tight pool preempted nothing")
        if name == "spec_full_drafter":
            # a draft is rejected only where the drafter (sparse kernel, 8
            # rows) and the verify pass (fused kernel, 40 rows) order a
            # near-tie differently; each such token rejects <= spec_k drafts
            for i in range(len(reqs)):
                gap(i, 0)
            ties = int(sum((gaps[i][1:] < LOGIT_ATOL).sum() for i in range(len(reqs))))
            rejected = m["proposed_drafts"] - m["accepted_drafts"]
            m["near_ties"] = ties
            log(f"[spec] {name}: {rejected} drafts rejected; {ties} near-ties in its streams")
            if m["acceptance_rate"] < 0.9 or rejected > SPEC_K * ties:
                raise RuntimeError(f"{name}: acceptance {m['acceptance_rate']:.4f} with "
                                   f"{rejected} rejections and {ties} near-ties")
        runs[name], streams[name] = m, outs
    log(f"[spec] near-tie divergences from the dense streams: {len(divergences)}")

    # each run again, warm (the counted runs paid the first calls' set-up),
    # then one warm spec_paged_shadow run under the profiler, beside phase
    # 6's profiled paged_shadow run of the same requests
    for name, eng in engines.items():
        sync()
        t0 = time.perf_counter()
        again = serve(eng)
        sync()
        wall = time.perf_counter() - t0
        if any(not np.array_equal(a, o) for a, o in zip(again, streams[name])):
            raise RuntimeError(f"a second {name} run gave other tokens")
        st = eng.last_serve_stats
        runs[name]["warm"] = {"tok_s": st["useful_tokens"] / wall, "wall_s": wall,
                              "ms_per_window": st["decode_s"] * 1e3 / st["spec"]["windows"],
                              "prefill_s": st["prefill_s"]}
        log(f"[spec] {name} warm: {runs[name]['warm']['tok_s']:.1f} tok/s, "
            f"{runs[name]['warm']['ms_per_window']:.3f} ms host per window, admission "
            f"prefills {st['prefill_s'] * 1e3:.1f} ms")
    profile = (profile_call(
        torch, lambda: serve(engines["spec_paged_shadow"]),
        lambda: f"one spec_paged_shadow run ({runs['spec_paged_shadow']['windows']} windows)")
        if device == "cuda" else None)

    # one admission group (8 requests, 40 verify rows) teacher-forced
    # through the verify window and through W sequential decode steps,
    # dense and paged, on the kernel path and on the plain path
    group = list(range(CONT["slots"]))
    W = SPEC_K + 1
    bs = CONT["block_size"]
    n_logical = CONT["max_seq"] // bs
    t_pad = -(-max(lens[i] for i in group) // 8) * 8
    toks = torch.as_tensor(np.stack([np.pad(reqs[i], (0, t_pad - lens[i])) for i in group])
                           .astype(np.int64), device=device)
    glens = torch.as_tensor(np.asarray([lens[i] for i in group], np.int64), device=device)
    window = torch.as_tensor(np.stack([dense[i][:W] for i in group]).astype(np.int64),
                             device=device)
    tables = np.zeros((len(group), n_logical), np.int32)
    for r, i in enumerate(group):
        n = blocks_for(lens[i] + W, bs)
        tables[r, :n] = 1 + r * n_logical + np.arange(n)
    tbl = torch.as_tensor(tables, device=device)
    kernel_gather = ops.gather_views

    def forced(plain: bool, paged: bool):
        if plain:
            os.environ["KAN_SAS_INFERENCE_METHOD"] = "compact"
            ops.gather_views = PG.gather_views_reference
        try:
            out = []
            for verify in (True, False):
                if paged:
                    caches = lm.init_paged_caches(cfg, 1 + len(group) * n_logical, bs,
                                                  torch.float32, device)
                    lm.prefill_into_pages(params, cfg, toks, glens, tbl, caches, 0,
                                          torch.float32, blocks_for(t_pad, bs))
                else:
                    _, caches = lm.prefill(params, cfg, toks, CONT["max_seq"])
                table = tbl if paged else None
                if verify:
                    lg, _ = lm.verify_window(params, cfg, window, caches, glens,
                                             torch.float32, table)
                else:
                    pos, steps = glens.clone(), []
                    for j in range(W):
                        lg, caches = lm.decode_step(params, cfg, window[:, j:j + 1], caches,
                                                    pos, torch.float32, table)
                        steps.append(lg)
                        pos = pos + 1
                    lg = torch.stack(steps, dim=1)
                out.append(lg)
            return out
        finally:
            os.environ.pop("KAN_SAS_INFERENCE_METHOD", None)
            ops.gather_views = kernel_gather

    errs = {}
    for paged in (False, True):
        kv, ks = forced(False, paged)
        pv, ps = forced(True, paged)
        for lg in (kv, ks, pv, ps):
            if lg.shape != (len(group), W, cfg.vocab) or not torch.isfinite(lg).all():
                raise RuntimeError("verify-window logits not finite or of the wrong shape")
        mode = "paged" if paged else "dense"
        errs[mode] = {"verify_vs_sequential": (kv - ks).abs().max().item(),
                      "kernel_vs_plain_verify": (kv - pv).abs().max().item(),
                      "kernel_vs_plain_sequential": (ks - ps).abs().max().item(),
                      "plain_verify_vs_sequential": (pv - ps).abs().max().item()}
        log(f"[spec] teacher-forced {len(group)} rows x W={W} ({mode}): max_abs_err "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs[mode].items())
            + f" (tol {LOGIT_ATOL:.1e}); greedy agreement verify vs sequential "
            f"{(kv.argmax(-1) == ks.argmax(-1)).float().mean().item():.3f}")
        if max(errs[mode].values()) > LOGIT_ATOL:
            raise RuntimeError(f"verify-window logits ({mode}) disagree beyond LOGIT_ATOL")
    return {"runs": runs, "divergences": divergences, "teacher_forced": errs,
            "profile": profile}


# Phase 6c: sampling at temperature > 0.  On random weights the full-width
# logits favour the input token by ~500 (phase 4's max|logit| ~530), so at
# T <= 10 every draw is the argmax; at SAMPLE_T the largest of 32000 Gumbel
# draws (~11) beats the ~5 the input token gets from its logit.
SAMPLE_T = 100.0
SAMPLE_SEED = 7
MIN_SAMPLED_SHARE = 0.5             # sampled tokens off the argmax of their logits
GUMBEL_ATOL = 1e-5                  # 4 float32 ulps at 16, the noise's top
WARM_PAIRS = 3                      # warm greedy and sampled runs in turn
# A rejected draft frees a 16-token block only where its window crossed
# into a block the accepted prefix does not reach; with 4-token blocks a
# window of W = 5 always crosses one, so that run is where rejected
# coverage is seen to be rolled back by trim_request
SAMPLE_SPEC_RUNS = [("spec_dense", {"spec_k": SPEC_K}),
                    ("spec_paged_shadow", {"spec_k": SPEC_K, "paged": True}),
                    ("spec_paged_blocks4", {"spec_k": SPEC_K, "paged": True, "block_size": 4})]
# Random123's known answers for threefry2x32_20: key, counter, output
THREEFRY_KAT = [((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
                ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
                ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0))]
# jax.random of jax 0.9.0 (jax_threefry_partitionable=True) for f =
# fold_in(PRNGKey(42), 7), uniforms as their float32 bits; the CPU tests hold
# these constants to jax (tests/test_torch_sampling.py)
THREEFRY_GOLDEN = {
    "prng_key": [[0, 0], [0, 42], [0, 5]],            # seeds 0, 42, 2**32 + 5
    "fold_in": [2547012911, 1371500959],
    "split": [[1029767004, 2691955506], [3913626572, 2520847663], [675592481, 2815174185]],
    "bits": [2635269230, 2130978531, 2408095496, 2660435744, 2228758927, 2222243316],
    "uniform": [1058870020, 1056835660, 1057982622, 1058968326],
    "uniform_ab": [1069889056, 1066934226, 1068557958, 1070036514],   # [-0.3, 2.7)
}
THREEFRY_GOLDEN_GUMBEL = [0.7165005207061768, 0.35544317960739136, 0.5471303462982178,
                          0.7361504435539246]


def check_threefry(torch, np, device="cuda"):
    """The threefry port on ``device`` (any miss raises): Random123's known
    answers and the golden ``jax.random`` values bit for bit (Gumbel noise
    within ``GUMBEL_ATOL``), and one ``(8, 32000)`` draw of bits, and its
    noise, against the same draw on the CPU."""
    from repro_torch.serve import threefry as tf
    from repro_torch.serve.engine import Engine

    for key, ctr, want in THREEFRY_KAT:
        got = tf.threefry2x32(*(torch.full((), v, dtype=torch.int64, device=device)
                                for v in key + ctr))
        if tuple(int(g) for g in got) != want:
            raise RuntimeError(f"threefry2x32{key + ctr} = {got}, not {want}")
    f = tf.fold_in(tf.prng_key(42, device), 7)
    got = {"prng_key": [tf.prng_key(s, device).tolist() for s in (0, 42, 2 ** 32 + 5)],
           "fold_in": f.tolist(), "split": tf.split(f, 3).tolist(),
           "bits": tf.random_bits_u32(f, (6,)).tolist(),
           "uniform": tf.uniform(f, (4,)).view(torch.int32).tolist(),
           "uniform_ab": tf.uniform(f, (4,), -0.3, 2.7).view(torch.int32).tolist()}
    for name, want in THREEFRY_GOLDEN.items():
        if got[name] != want:
            raise RuntimeError(f"threefry {name} on {device}: {got[name]} != jax's {want}")
    g_err = max(abs(a - b) for a, b in zip(tf.gumbel(f, (4,)).tolist(), THREEFRY_GOLDEN_GUMBEL))
    host = Engine._row_key_pairs(tf.prng_key(SAMPLE_SEED).numpy(), np.arange(8))[:, 1]
    keys = {d: torch.as_tensor(host, device=d) for d in (device, "cpu")}
    bits = {d: tf.random_bits_u32(k, (8, 32000)) for d, k in keys.items()}
    noise = {d: tf.gumbel(k, (8, 32000)) for d, k in keys.items()}
    equal = torch.equal(bits[device].cpu(), bits["cpu"])
    n_err = (noise[device].cpu() - noise["cpu"]).abs().max().item()
    log(f"[sample] threefry known answers {len(THREEFRY_KAT)}/{len(THREEFRY_KAT)} and golden "
        f"values {len(THREEFRY_GOLDEN)}/{len(THREEFRY_GOLDEN)} bit-equal on {device}; golden "
        f"Gumbel max_abs_err={g_err:.1e}; (8, 32000) bits on {device} equal to the CPU's: "
        f"{equal}; noise max_abs_err={n_err:.1e} (tol {GUMBEL_ATOL:.0e})")
    if not equal or max(g_err, n_err) > GUMBEL_ATOL:
        raise RuntimeError("the threefry draw on the device disagrees with the CPU's")
    return {"known_answers": len(THREEFRY_KAT), "golden": len(THREEFRY_GOLDEN),
            "bits_equal_cpu": equal, "gumbel_golden_err": g_err, "noise_max_abs_err": n_err}


def sampled_gaps(torch, np, params, cfg, prompt, stream, rid, seed, temperature, device):
    """For each token of a sampled ``stream`` (request ``rid``), its logits
    teacher-forced through one prefill: the top-2 gap of its perturbed
    scores ``logits / T + g`` with that token's key
    (``speculative.perturbed_top2_gap``), whether it differs from the
    argmax of its own logits, and the token those scores draw; then
    max|logit| of the stream."""
    from repro_torch.models import lm
    from repro_torch.serve import speculative as sp
    from repro_torch.serve import threefry as tf
    from repro_torch.serve.engine import Engine

    seq = np.concatenate([prompt, stream[:-1]]).astype(np.int64)
    logits, _ = lm.prefill(params, cfg, torch.as_tensor(seq[None], device=device), len(seq))
    lg = logits[0, len(prompt) - 1:]
    pair = Engine._row_key_pairs(tf.prng_key(seed).numpy(), [rid])[0]
    kts = np.concatenate([pair[None, 1], sp.split_chain(pair[None, 0], len(stream) - 1)[0][0]])
    noise = tf.gumbel(torch.as_tensor(kts, device=device), (cfg.vocab,))
    gaps = sp.perturbed_top2_gap(lg, noise, temperature).cpu().numpy()
    off = lg.argmax(-1).cpu().numpy() != stream
    drawn = sp.sample_with_noise(lg, noise, temperature).cpu().numpy()
    return gaps, off, drawn, lg.abs().amax().item()


def sampling_path(torch, np, greedy=None, device="cuda", cfg=None, temperature=SAMPLE_T):
    """Phase 6c (any miss raises): the threefry port's known answers on the
    card, then phase 4's requests through ``serve_requests`` and the
    continuous cell through ``serve_continuous`` (dense, paged shadow, paged
    step, the 25-block pool) and speculative windows (a 1-layer drafter:
    dense, paged shadow, paged shadow with 4-token blocks), all sampled at
    ``temperature``, each run with the launch counts reset just before and
    checked exactly just after and the pool balanced after the drain.
    ``greedy``: phase 6's result, for the profiled comparison.
    ``device="cpu"`` with a reduced ``cfg`` rehearses it on the kernels'
    plain versions (every count 0)."""
    import dataclasses

    from repro_torch.configs import kanformer_100m
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve import kv_pool
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = cfg or kanformer_100m.config().model
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    out = {"temperature": temperature, "seed": SAMPLE_SEED,
           "threefry": check_threefry(torch, np, device)}
    params = lm.init_params(cfg, seed=0, device=device, dtype=torch.float32)

    def counted(name, fn, want_fn):
        sync()
        ops.reset_launches()
        t0 = time.perf_counter()
        outs = fn()
        sync()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        want = want_fn() if device == "cuda" else dict.fromkeys(ops.LAUNCHES, 0)
        log(f"[sample] {name}: launches {launches}, expected {want}")
        if launches != want:
            raise RuntimeError(f"{name}: launch counts {launches} != expected {want}")
        for o in outs:
            if o.min() < 0 or o.max() >= cfg.vocab:
                raise RuntimeError(f"{name}: bad output {o}")
        return outs, wall, launches

    # phase 4's requests through the static engine
    batch, max_new = 4, 32
    rs = np.random.RandomState(0)
    lens4 = rs.randint(32, 129, 8)
    reqs4 = [rs.randint(0, cfg.vocab, L).astype(np.int32) for L in lens4]
    static = Engine(params, cfg, ServeConfig(max_seq=int(lens4.max()) + max_new + 8,
                                             max_new_tokens=max_new, temperature=temperature),
                    device=device)
    per_pass = 2 * len(cfg.unit) * cfg.n_repeats
    _, wall, launches = counted(
        "static", lambda: static.serve_requests(reqs4, batch_size=batch, seed=SAMPLE_SEED),
        lambda: dict(dict.fromkeys(ops.LAUNCHES, 0),
                     kan_fused_gemm=len(static.last_serve_stats["buckets"]) * per_pass,
                     kan_sparse_gemm=len(static.last_serve_stats["buckets"]) * (max_new - 1)
                     * per_pass))
    def per_step(buckets) -> float:
        return (sum(b["decode_s"] for b in buckets) * 1e3
                / sum(b["decode_steps"] for b in buckets))

    cold = per_step(static.last_serve_stats["buckets"])
    t0 = time.perf_counter()                       # warm, beside phase 4's warm run
    static.serve_requests(reqs4, batch_size=batch, seed=SAMPLE_SEED)
    sync()
    warm_wall = time.perf_counter() - t0
    out["static"] = {"tok_s": 8 * max_new / wall, "wall_s": wall, "launches": launches,
                     "decode_ms_per_step": cold, "warm_tok_s": 8 * max_new / warm_wall,
                     "warm_decode_ms_per_step": per_step(static.last_serve_stats["buckets"])}
    log(f"[sample] static: {8 * max_new} tokens in {wall:.3f} s: {out['static']['tok_s']:.1f} "
        f"tok/s, {cold:.3f} ms per decode step; warm {out['static']['warm_tok_s']:.1f} tok/s, "
        f"{out['static']['warm_decode_ms_per_step']:.3f} ms per decode step")

    # the continuous cell, four ways, then three speculative runs
    reqs, budgets = continuous_requests(np, cfg.vocab)
    base = ServeConfig(max_seq=CONT["max_seq"], max_new_tokens=max(budgets),
                       block_size=CONT["block_size"], temperature=temperature)

    def serve(eng):
        return eng.serve_continuous(reqs, slots=CONT["slots"], chunk_steps=CONT["chunk_steps"],
                                    max_new=budgets, seed=SAMPLE_SEED)

    runs, streams, engines = {}, {}, {}
    trims = []
    trim = kv_pool.BlockPool.trim_request

    def counting_trim(pool, rid, keep):            # blocks each trim frees
        freed = trim(pool, rid, keep)
        trims.append(len(freed))
        return freed

    for name, extra in CONT_RUNS + SAMPLE_SPEC_RUNS:
        eng = engines[name] = Engine(params, cfg, dataclasses.replace(base, **extra),
                                     device=device)
        del trims[:]
        kv_pool.BlockPool.trim_request = counting_trim
        try:
            outs, wall, launches = counted(name, lambda: serve(eng),
                                           lambda: expected_launches(cfg, eng.last_serve_stats,
                                                                     extra))
        finally:
            kv_pool.BlockPool.trim_request = trim
        st = eng.last_serve_stats
        pg, sp = st.get("paged", {}), st.get("spec")
        steps = sp["windows"] if sp else st["chunks_run"] * CONT["chunk_steps"]
        m = {"tok_s": st["useful_tokens"] / wall, "wall_s": wall, "launches": launches,
             "decode_s": st["decode_s"], "prefill_s": st["prefill_s"],
             ("windows" if sp else "decode_steps"): steps,
             ("ms_per_window" if sp else "decode_ms_per_step"): st["decode_s"] * 1e3 / steps,
             "n_preemptions": st["n_preemptions"], "blocks_freed_by_trims": sum(trims),
             "trims_freeing": sum(1 for t in trims if t)}
        if sp:
            m.update(acceptance_rate=sp["acceptance_rate"], proposed_drafts=sp["proposed_drafts"],
                     accepted_drafts=sp["accepted_drafts"],
                     emitted_per_window=sp["emitted_tokens"] / sp["windows"])
        log(f"[sample] {name}: {st['useful_tokens']} tokens in {wall:.3f} s: {m['tok_s']:.1f} "
            f"tok/s; " + (f"windows {steps} ({m['ms_per_window']:.3f} ms host per window), "
                          f"acceptance {sp['acceptance_rate']:.4f} ({sp['accepted_drafts']} of "
                          f"{sp['proposed_drafts']} drafts), {m['emitted_per_window']:.2f} tokens "
                          f"per window" if sp else
                          f"{steps} decode steps ({m['decode_ms_per_step']:.3f} ms each)")
            + f"; preemptions {st['n_preemptions']}; blocks freed by trims {sum(trims)}")
        if pg and pg["blocks_in_use"] != pg["blocks_cache_held"]:
            raise RuntimeError(f"{name}: the pool is not balanced after the drain: {pg}")
        if name.endswith("preempt") and st["n_preemptions"] < 1:
            raise RuntimeError(f"{name}: the tight pool preempted nothing")
        if sp and not 0.0 < sp["acceptance_rate"] < 1.0:
            raise RuntimeError(f"{name}: acceptance {sp['acceptance_rate']} is not in (0, 1)")
        if name == "spec_paged_blocks4" and sum(trims) < 1:
            raise RuntimeError(f"{name}: no rejection was rolled back by trim_request")
        runs[name], streams[name] = m, outs

    # the dense run against each request served alone by generate, every
    # other run against the dense run; a divergence must start at a near-tie
    # of the perturbed scores, a top-2 gap of logits / T + g below
    # LOGIT_ATOL / T
    alone = Engine(params, cfg, base, device=device)
    solo = [alone.generate(r[None], request_ids=np.array([i]), max_new=b, seed=SAMPLE_SEED)[0]
            for i, (r, b) in enumerate(zip(reqs, budgets))]
    tie_tol = LOGIT_ATOL / temperature
    divergences = []
    for name, outs in [("dense_vs_solo", streams["dense"])] + [
            (n, o) for n, o in streams.items() if n != "dense"]:
        want = solo if name == "dense_vs_solo" else streams["dense"]
        for i, (o, w) in enumerate(zip(outs, want)):
            diff = np.nonzero(o != w)[0]
            if diff.size:
                j = int(diff[0])
                g = float(sampled_gaps(torch, np, params, cfg, reqs[i], w, i, SAMPLE_SEED,
                                       temperature, device)[0][j])
                divergences.append({"run": name, "request": i, "step": j, "gap": g})
                log(f"[sample] {name}: request {i} diverges at step {j}; perturbed top-2 gap "
                    f"{g:.3e} (near-tie below {tie_tol:.1e})")
                if g >= tie_tol:
                    raise RuntimeError(f"{name}: request {i} diverges at step {j}, not a near-tie")
    # the dense run's tokens against the argmax of their own logits
    gaps, off, _, _ = zip(*(sampled_gaps(torch, np, params, cfg, r, o, i, SAMPLE_SEED,
                                         temperature, device)
                            for i, (r, o) in enumerate(zip(reqs, streams["dense"]))))
    share = float(np.concatenate(off).mean())
    near = int(sum((g < tie_tol).sum() for g in gaps))
    n_tok = sum(len(g) for g in gaps)
    log(f"[sample] T={temperature}: {share:.4f} of {n_tok} sampled tokens differ from the "
        f"argmax of their own logits (floor {MIN_SAMPLED_SHARE}); near-ties among them {near}; "
        f"near-tie divergences {len(divergences)} over {len(streams)} runs")
    if share < MIN_SAMPLED_SHARE:
        raise RuntimeError(f"only {share:.4f} of the sampled tokens differ from the argmax")
    out.update(runs=runs, sampled_share=share, near_ties=near, sampled_tokens=n_tok,
               divergences=divergences)

    # warm paged shadow runs, greedy and sampled in turn (WARM_PAIRS each,
    # the same admissions and decode steps: the host's drift between calls
    # falls on both), then one sampled run under the profiler beside phase
    # 6's profiled greedy one
    eng = engines["paged_shadow"]
    twin = Engine(params, cfg, dataclasses.replace(base, paged=True, temperature=0.0),
                  device=device)
    per_step = {"greedy": [], "sampled": []}
    for _ in range(WARM_PAIRS):
        for kind, e in (("greedy", twin), ("sampled", eng)):
            again = serve(e)
            if kind == "sampled" and any(not np.array_equal(a, o) for a, o in
                                         zip(again, streams["paged_shadow"])):
                raise RuntimeError("a second sampled paged_shadow run gave other tokens")
            st = e.last_serve_stats
            steps = st["chunks_run"] * CONT["chunk_steps"]
            per_step[kind].append(st["decode_s"] * 1e3 / steps)
    mean = {k: sum(v) / len(v) for k, v in per_step.items()}
    out["warm_shadow"] = {"decode_steps": steps, "decode_ms_per_step": per_step,
                          "ratio_of_means": mean["sampled"] / mean["greedy"]}
    log(f"[sample] warm paged_shadow runs in turn, ms per decode step: greedy "
        f"{[round(x, 3) for x in per_step['greedy']]}, sampled "
        f"{[round(x, 3) for x in per_step['sampled']]}; sampled over greedy "
        f"{mean['sampled'] / mean['greedy']:.3f}")
    if device == "cuda":
        prof = profile_call(torch, lambda: serve(eng),
                            lambda: f"one sampled paged_shadow run ({steps} decode steps)")
        out["profile"] = prof
        g = (greedy or {}).get("profile", {})
        if prof.get("busy_share") is not None and g.get("kernels"):
            out["vs_greedy"] = {
                "kernels_per_step": prof["kernels"] / steps,
                "greedy_kernels_per_step": g["kernels"] / steps,
                "busy_ms_per_step": prof["busy_ms"] / steps,
                "greedy_busy_ms_per_step": g["busy_ms"] / steps,
                "busy_share": prof["busy_share"], "greedy_busy_share": g["busy_share"]}
            v = out["vs_greedy"]
            log(f"[sample] profiled sampled paged_shadow run vs phase 6's greedy one: "
                f"{v['kernels_per_step']:.1f} vs {v['greedy_kernels_per_step']:.1f} kernels and "
                f"{v['busy_ms_per_step']:.3f} vs {v['greedy_busy_ms_per_step']:.3f} ms of device "
                f"busy time per decode step (admissions included); busy "
                f"{v['busy_share']:.3f} vs {v['greedy_busy_share']:.3f} of the wall")
    return out


def main_path(torch, np):
    from repro_torch.configs import kanformer_100m
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = kanformer_100m.config().model
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    n_params = sum(t.numel() for blk in [params["embed"], params["final_ln"]]
                   for t in blk.values())
    n_params += sum(t.numel() for t in params["unit"][0]["attn"].values())
    n_params += sum(t.numel() for sub in ("ln1", "ln2", "kan")
                    for t in params["unit"][0][sub].values())
    batch, max_new, n_req = 4, 32, 8
    rs = np.random.RandomState(0)
    lens = rs.randint(32, 129, n_req)
    reqs = [rs.randint(0, cfg.vocab, L).astype(np.int32) for L in lens]
    max_seq = int(lens.max()) + max_new + 8
    eng = Engine(params, cfg, ServeConfig(max_seq=max_seq, max_new_tokens=max_new),
                 device="cuda")
    log(f"[main] kanformer-100m full width: d={cfg.d_model} layers={cfg.n_repeats} "
        f"kan_ff={cfg.unit[0].kan_ff} vocab={cfg.vocab} params={n_params / 1e6:.1f}M fp32; "
        f"{n_req} requests, prompt lengths {sorted(lens.tolist())}, batch {batch}, "
        f"max_new {max_new}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = eng.serve_requests(reqs, batch_size=batch, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    stats = eng.last_serve_stats
    n_buckets = len(stats["buckets"])
    per_pass = 2 * cfg.n_repeats                  # 2 KAN layers x blocks
    want = dict(dict.fromkeys(ops.LAUNCHES, 0), kan_fused_gemm=n_buckets * per_pass,
                kan_sparse_gemm=n_buckets * (max_new - 1) * per_pass)
    log(f"[main] launches {launches}, expected {want}")
    if launches != want:
        raise RuntimeError(f"launch counts {launches} != expected {want}")
    for o in outs:
        if o.shape != (max_new,) or o.min() < 0 or o.max() >= cfg.vocab:
            raise RuntimeError(f"bad output {o}")
    total_new = sum(len(o) for o in outs)
    for b in stats["buckets"]:
        log(f"[main] bucket rows={b['rows']} prompt_len={b['prompt_len']} "
            f"prefill_ms={b['prefill_s'] * 1e3:.2f} decode_ms_per_step="
            f"{b['decode_s'] * 1e3 / b['decode_steps']:.3f}")
    prefill_ms = sum(b["prefill_s"] for b in stats["buckets"]) * 1e3 / n_buckets
    decode_ms = (sum(b["decode_s"] for b in stats["buckets"]) * 1e3
                 / sum(b["decode_steps"] for b in stats["buckets"]))
    log(f"[main] {n_req} requests, {total_new} tokens in {wall:.3f} s: "
        f"{total_new / wall:.1f} tok/s; prefill_ms (mean per bucket)={prefill_ms:.2f} "
        f"decode_ms_per_step={decode_ms:.3f} peak_mem_GB={peak / 1e9:.3f}")

    # kernel path vs plain path on the same tokens: prefill of the first
    # bucket, then 4 decode steps teacher-forced with the served tokens
    kern, ref, toks, order = kernel_vs_plain(torch, np, eng.params, cfg, reqs, outs, batch,
                                             max_seq)
    err = (kern - ref).abs().max().item()
    agree = (kern.argmax(-1) == ref.argmax(-1)).float().mean().item()
    if not (torch.isfinite(kern).all() and kern.shape == (5, batch, cfg.vocab)):
        raise RuntimeError("main-path logits not finite or of the wrong shape")
    log(f"[main] kernel vs plain path logits (prefill + 4 decode steps): "
        f"max_abs_err={err:.3e} tol={LOGIT_ATOL:.1e} max|logit|="
        f"{ref.abs().max().item():.2f} greedy_agreement={agree:.3f}")
    if err > LOGIT_ATOL:
        raise RuntimeError("kernel path logits disagree with the plain path")

    # the same requests again, warm (the counted run above paid the first
    # calls' lazy set-up), then one bucket under the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.serve_requests(reqs, batch_size=batch, seed=0)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    if any(not np.array_equal(a, o) for a, o in zip(again, outs)):
        raise RuntimeError("a second serve_requests run gave other tokens")
    wb = eng.last_serve_stats["buckets"]
    warm = {"tok_s": total_new / warm_wall,
            "prefill_ms": sum(b["prefill_s"] for b in wb) * 1e3 / len(wb),
            "decode_ms_per_step": sum(b["decode_s"] for b in wb) * 1e3
            / sum(b["decode_steps"] for b in wb)}
    log(f"[main] warm: {total_new} tokens in {warm_wall:.3f} s: {warm['tok_s']:.1f} tok/s; "
        f"prefill_ms (mean per bucket)={warm['prefill_ms']:.2f} "
        f"decode_ms_per_step={warm['decode_ms_per_step']:.3f}")
    prompts = toks.cpu().numpy().astype(np.int32)
    prof = profile_generate(torch, eng, prompts, lens[order].astype(np.int32))
    return launches, {"tok_s": total_new / wall, "prefill_ms": prefill_ms,
                      "decode_ms_per_step": decode_ms, "peak_mem_bytes": peak,
                      "logit_max_abs_err": err, "greedy_agreement": agree,
                      "warm": warm, "profile": prof}


def kernel_vs_plain(torch, np, params, cfg, reqs, outs, batch, max_seq, device="cuda"):
    """The first static bucket (the ``batch`` shortest prompts, right-padded)
    prefilled, then 4 decode steps teacher-forced with the served tokens
    ``outs``, on the kernel path and on the plain path
    (``KAN_SAS_INFERENCE_METHOD=compact``) -> ``(kernel logits, plain
    logits, each (5, batch, vocab); the padded prompts; the bucket's
    request indices)``."""
    from repro_torch.models import lm

    lens = np.array([len(r) for r in reqs])
    order = sorted(range(len(reqs)), key=lambda i: lens[i])[:batch]
    T = int(max(lens[i] for i in order))
    toks = torch.as_tensor(np.stack([np.pad(reqs[i], (0, T - len(reqs[i])))
                                     for i in order]).astype(np.int64), device=device)
    rl = torch.as_tensor(lens[order], device=device)
    forced = [torch.as_tensor(np.stack([outs[i][s] for i in order]).astype(np.int64),
                              device=device)[:, None] for s in range(4)]

    def run(method):
        if method:
            os.environ["KAN_SAS_INFERENCE_METHOD"] = method
        try:
            logits, caches = lm.prefill(params, cfg, toks, max_seq)
            got = [logits[torch.arange(batch, device=device), rl - 1]]
            pos = rl.clone()
            for s in range(4):
                lg, caches = lm.decode_step(params, cfg, forced[s], caches, pos)
                got.append(lg)
                pos = pos + 1
            return torch.stack(got)
        finally:
            os.environ.pop("KAN_SAS_INFERENCE_METHOD", None)

    return run(None), run("compact"), toks, order


def profile_generate(torch, eng, prompts, lens):
    """One warm ``Engine.generate`` of a bucket under ``torch.profiler``."""
    def what():
        gs = eng.last_generate_stats
        return (f"one bucket ({gs['rows']} rows, prompt_len {gs['prompt_len']}, "
                f"{gs['decode_steps']} decode steps)")
    return profile_call(torch, lambda: eng.generate(prompts, lengths=lens), what)


def profile_call(torch, fn, what, keep_names: bool = False):
    """``fn`` once unprofiled, then once under ``torch.profiler``: device
    busy time (the union of all kernel intervals) and device time by kernel
    name.  The profiler slows the host, so the busy share is given against
    the wall time of the same call run without it, and against the
    profiled wall.  ``what()`` names the call in the log; ``keep_names`` keeps
    every kernel name's (us, count) in the result."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        log("[profile] the profiler saw no device events: busy share not measured")
        return {"busy_share": None}
    busy, end, by_name = 0.0, -1.0, {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e - s, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    log(f"[profile] {what()}: wall {plain_wall_us / 1e3:.2f} ms unprofiled, "
        f"{wall_us / 1e3:.2f} ms profiled; device busy {busy / 1e3:.2f} ms = "
        f"{busy / plain_wall_us:.3f} of the unprofiled wall ({busy / wall_us:.3f} of the "
        f"profiled); {len(spans)} kernels")
    for name, (t, n) in top:
        log(f"[profile]   {t / 1e3:9.3f} ms  {n:5d}x  {name[:110]}")
    # the port's own kernels, each with its share of the device's busy time
    ours = {}
    for name, (t, n) in by_name.items():
        for kern in PORT_KERNEL_SYMBOLS:
            if kern in name:
                t0_, n0 = ours.get(kern, (0.0, 0))
                ours[kern] = (t0_ + t, n0 + n)
    for kern, (t, n) in sorted(ours.items()):
        log(f"[profile]   port kernel {kern}: {t / 1e3:.3f} ms in {n} launches = "
            f"{t / busy:.4f} of the device's busy time")
    return {"wall_ms": plain_wall_us / 1e3, "profiled_wall_ms": wall_us / 1e3,
            "busy_ms": busy / 1e3, "busy_share": busy / plain_wall_us,
            "busy_share_profiled": busy / wall_us, "kernels": len(spans),
            "top": [{"name": n[:200], "ms": t / 1e3, "count": c} for n, (t, c) in top],
            "port_kernels": {k: {"ms": t / 1e3, "count": n} for k, (t, n) in ours.items()},
            **({"by_name": by_name} if keep_names else {})}


# Phase 7: integer-only KAN inference of full-width MNIST-KAN (Table II,
# the paper's §V int8 claim), the cell of the int8 kernels and the LUT one.
MNIST = {"layers": (784, 64, 10), "G": 10, "P": 3, "rows": 2048, "decode_rows": 8}
CFKAN_L1 = {"K": 2810, "N": 512, "G": 2}        # CF-KAN's widest layer, P = 3
ROM_GRIDS = ((2, 1), (3, 2), (10, 3))            # P = 1, 2, 3


def net_inputs(torch, grid, rows, K, device, seed=13):
    """Uniform over [-1.2, 1.2] (past the domain on both sides) with x_min,
    x_max and every knot planted at the front."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(rows, K, generator=g, device=device) * 2.4 - 1.2
    plant = [grid.x_min, grid.x_max, *grid.knots().tolist()]
    x.view(-1)[: len(plant)] = torch.tensor(plant, dtype=torch.float32, device=device)
    return x


def counted(torch, name, fn, want, device, tag="int8"):
    """``fn()`` with the launch counts reset just before and checked
    exactly just after (on the CPU the wrappers launch nothing); ``want``
    may be a function, called after ``fn`` (counts read from its stats)."""
    from repro_torch.kernels import ops

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if callable(want):
        want = want()
    expected = dict(dict.fromkeys(ops.LAUNCHES, 0), **(want if device == "cuda" else {}))
    log(f"[{tag}] {name}: {wall * 1e3:.2f} ms, launches "
        f"{ {k: v for k, v in launches.items() if v} }, expected "
        f"{ {k: v for k, v in expected.items() if v} }")
    if launches != expected:
        raise RuntimeError(f"{name}: launch counts {launches} != expected {expected}")
    return out, {"wall_ms": wall * 1e3, "launches": launches}


def int8_path(torch, np, device="cuda", layers=MNIST["layers"], rows=MNIST["rows"]):
    """Phase 7's checks (any miss raises); ``device="cpu"`` with narrow
    ``layers`` rehearses them on the kernels' plain versions."""
    from repro_torch.core import kan_layer as KL
    from repro_torch.core import quantization as Q
    from repro_torch.core.bspline import SplineGrid, build_lut
    from repro_torch.examples import mnist_kan as MK
    from repro_torch.kernels import bspline_lut as L
    from repro_torch.kernels import kan_int8_gemm as I8
    from repro_torch.kernels import kan_sparse_gemm as S
    from repro_torch.kernels import ops

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    cfg = KL.KANNetConfig(layers=tuple(layers), G=MNIST["G"], P=MNIST["P"])
    grid = cfg.grid()
    params = KL.init_kan_net(cfg, seed=0, device=device)
    n_params = sum(t.numel() for p in params for t in p.values())
    sync()
    t0 = time.perf_counter()
    qlayers = MK.quantize_net(cfg, params)
    sync()
    quant_ms = (time.perf_counter() - t0) * 1e3
    for i, (p, ql) in enumerate(zip(params, qlayers)):
        cpu = Q.quantize_kan_layer({k: v.cpu() for k, v in p.items()}, grid)
        for f in ("coeff_q", "coeff_i8", "coeff_scale", "base_w_q", "base_w_scale", "lut_u8"):
            if not torch.equal(getattr(cpu, f), getattr(ql, f).cpu()):
                raise RuntimeError(f"layer {i}: {f} quantised on {device} != on the CPU")
    log(f"[int8] MNIST-KAN {list(layers)} G={grid.G} P={grid.P}: {n_params} fp32 parameters, "
        f"quantised on {device} in {quant_ms:.2f} ms; coeff_q, base_w_q and the scales "
        f"equal a CPU quantisation of the same weights")

    x = net_inputs(torch, grid, rows, layers[0], device)
    lut = torch.as_tensor(build_lut(grid.P), device=device)
    dr, nl = MNIST["decode_rows"], len(qlayers)

    runs = {}
    y8, runs["int8_2048"] = counted(torch, f"int8 net, {rows} rows",
                                    lambda: MK.int8_net_apply(qlayers, x),
                                    {"kan_int8_gemm": nl}, device)
    y8s, runs["int8_8"] = counted(torch, f"int8 net, {dr} rows",
                                  lambda: MK.int8_net_apply(qlayers, x[:dr]),
                                  {"kan_sparse_int8_gemm": nl}, device)
    yf, runs["fp32_auto_2048"] = counted(
        torch, f"fp32 net auto, {rows} rows", lambda: KL.kan_net_apply(params, x, cfg, "auto"),
        {"kan_fused_gemm": nl}, device)
    yfs, runs["fp32_auto_8"] = counted(
        torch, f"fp32 net auto, {dr} rows",
        lambda: KL.kan_net_apply(params, x[:dr], cfg, "auto"), {"kan_sparse_gemm": nl}, device)
    yl, runs["lut_2048"] = counted(
        torch, f"fp32 net lut, {rows} rows",
        lambda: KL.kan_net_apply(params, x, cfg, "lut", lut=lut), {"bspline_lut": nl}, device)
    out_shape = (rows, layers[-1])
    for name, y in (("int8", y8), ("fp32", yf), ("lut", yl)):
        if y.shape != out_shape or y.dtype != torch.float32 or not torch.isfinite(y).all():
            raise RuntimeError(f"{name} logits not finite or not {out_shape} float32")

    # the kernel paths against the plain ones on the same device
    h_in, plain, h = [], x, x
    for i, ql in enumerate(qlayers):
        if i:
            h, plain = torch.tanh(h), torch.tanh(plain)
        h_in.append(h)
        plain = Q.quantized_kan_forward(ql, plain)
        x_q = ql.qg.x_quant.quantize(h)
        cq = ql.coeff_i8
        acc = ops.kan_int8_gemm(x_q, ql.lut_u8, cq, grid, lut_scale=ql.qg.lut_scale)
        want = I8.kan_int8_gemm_reference(x_q, cq, grid, S=ql.qg.S, lut_scale=ql.qg.lut_scale)
        if acc.dtype != torch.int32 or not torch.equal(acc, want):
            raise RuntimeError(f"layer {i}: int32 accumulator != the plain version's")
        log(f"[int8] layer {i}: int32 accumulator {tuple(acc.shape)} bit-equal to the plain "
            f"version (max |acc| {acc.abs().max().item()})")
        h = Q.quantized_kan_forward_fused(ql, h)
    if not torch.equal(y8, plain):
        raise RuntimeError("int8 logits != the plain integer path's (table fetch, slabs)")
    if not torch.equal(y8s, y8[:dr]):
        raise RuntimeError("int8 logits at 8 rows (sparse int8) != at 2048 rows (dense band)")
    compact = KL.kan_net_apply(params, x, cfg, "compact")
    err_f = (yf - compact).abs().max().item()
    err_fs = (yfs - compact[:dr]).abs().max().item()
    log(f"[int8] fp32 net auto vs compact (plain): {rows} rows max_abs_err={err_f:.3e}, "
        f"{dr} rows (sparse kernel, M={grid.n_basis}) max_abs_err={err_fs:.3e} "
        f"tol={FP32_ATOL:.1e}")
    if max(err_f, err_fs) > FP32_ATOL:
        raise RuntimeError("fp32 net kernel path disagrees with the plain path")
    agree = (y8.argmax(-1) == yf.argmax(-1)).float().mean().item()
    d_int8 = (y8 - yf).abs().max().item()
    agree_lut = (yl.argmax(-1) == yf.argmax(-1)).float().mean().item()
    d_lut = (yl - yf).abs().max().item()
    log(f"[int8] int8 vs fp32 logits: top-1 agreement {agree:.4f}, max |dlogit| {d_int8:.4e} "
        f"(max |logit| {yf.abs().max().item():.4f}); lut vs fp32: top-1 agreement "
        f"{agree_lut:.4f}, max |dlogit| {d_lut:.4e}")

    # kernel 3 against kernel 4 and its plain version at decode rows
    checked = 0
    for i, ql in enumerate(qlayers):
        cq = ql.coeff_i8
        sc = ql.coeff_scale.reshape(-1) / torch.full((), ql.qg.lut_scale,
                                                      dtype=torch.float32, device=device)
        for r in (1, 4, 8):
            x_q = ql.qg.x_quant.quantize(h_in[i][:r])
            for kw in ({}, dict(scale=sc), dict(scale=sc, out_dtype=torch.bfloat16)):
                a = ops.kan_sparse_int8_gemm(x_q, ql.lut_u8, cq, grid,
                                             lut_scale=ql.qg.lut_scale, **kw)
                b = ops.kan_int8_gemm(x_q, ql.lut_u8, cq, grid, lut_scale=ql.qg.lut_scale, **kw)
                c = S.kan_sparse_int8_gemm_reference(x_q, cq, grid, S=ql.qg.S,
                                                     lut_scale=ql.qg.lut_scale, **kw)
                if not (torch.equal(a, b) and torch.equal(a, c)):
                    raise RuntimeError(f"layer {i}, {r} rows, {kw.get('out_dtype', 'int32')}: "
                                       f"sparse int8 != dense band or plain")
                checked += 1
    log(f"[int8] sparse int8 kernel bit-equal to the dense-band kernel and its plain version: "
        f"{checked} cases (layers x 1/4/8 rows x int32/fp32/bf16 out)")

    # kernel 6 on layer 1's inputs
    vals, k = ops.bspline_lut(x, lut, grid)
    rv, rk = L.bspline_lut_reference(x.reshape(-1), lut, grid)
    if not (torch.equal(k.reshape(-1), rk) and torch.equal(vals.reshape(-1, grid.P + 1), rv)):
        raise RuntimeError("bspline_lut disagrees with its plain version")
    log(f"[int8] bspline_lut on {x.numel()} inputs: k equal, vals exact")

    # every ROM address through both int8 kernels
    n_rom = 0
    for G, P in ROM_GRIDS:
        g = SplineGrid(-1.0, 1.0, G, P)
        x_q, qmax, coeff = I8.rom_probe(g, 256)
        u = (G + 2 * P) * x_q[:, 0].numpy().astype(np.int64)
        kk = np.clip(u // qmax, P, g.n_basis - 1)
        addrs = set(((np.clip(u - qmax * kk, 0, qmax) * 255) // qmax).tolist())
        if addrs != set(range(256)):
            raise RuntimeError(f"P={P}: the ROM probe misses addresses")
        for scale in sorted({Q.lut_value_scale(P), 256, 192}):
            lut8 = torch.as_tensor(Q.build_lut_u8(P, 256, scale))
            want = ops.kan_int8_gemm(x_q, lut8, coeff, g, qmax=qmax)      # table fetch, CPU
            for fn in (ops.kan_int8_gemm, ops.kan_sparse_int8_gemm):
                got = fn(x_q.to(device), lut8.to(device), coeff.to(device), g, qmax=qmax)
                if not torch.equal(got.cpu(), want):
                    raise RuntimeError(f"P={P} scale={scale}: ROM values != build_lut_u8")
            n_rom += 1
    log(f"[int8] ROM: all 256 addresses of {n_rom} tables (P = 1, 2, 3; value scales "
        f"128/256 and 192) read build_lut_u8's bytes through both int8 kernels")
    return {"runs": runs, "quantize_ms": quant_ms, "top1_agreement": agree,
            "max_abs_dlogit": d_int8, "lut_top1_agreement": agree_lut,
            "lut_max_abs_dlogit": d_lut, "fp32_kernel_vs_plain_err": max(err_f, err_fs),
            "rom_tables_checked": n_rom, "sparse_int8_cases": checked,
            "int8_net": lambda: MK.int8_net_apply(qlayers, x)}


def time_int8_kernels(torch, np):
    """Kernels 3, 4 and 6 at MNIST-KAN layer 1 and CF-KAN layer 1, with the
    dequant epilogue to fp32 as the int8 path runs them: kernel, plain
    version, a bf16 matmul over the materialised u8 band (``library_ms``;
    exact operands, a time yardstick only) and the bound."""
    from repro_torch.core import quantization as Q
    from repro_torch.core.bspline import SplineGrid, build_lut
    from repro_torch.kernels import bspline_lut as L
    from repro_torch.kernels import kan_int8_gemm as I8
    from repro_torch.kernels import kan_sparse_gemm as S
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import band_scatter, int8_compact_values_inblock

    cycles_per_ms = spin_cycles_per_ms(torch)
    K1, N1 = MNIST["layers"][:2]
    cases = [("kan_int8_gemm", 2048, K1, N1, MNIST["G"]),
             ("kan_int8_gemm", 2048, CFKAN_L1["K"], CFKAN_L1["N"], CFKAN_L1["G"]),
             ("kan_int8_gemm", 8, K1, N1, MNIST["G"]),           # yardsticks for kernel 3
             ("kan_int8_gemm", 8, CFKAN_L1["K"], CFKAN_L1["N"], CFKAN_L1["G"]),
             ("kan_sparse_int8_gemm", 8, K1, N1, MNIST["G"]),
             ("kan_sparse_int8_gemm", 2048, K1, N1, MNIST["G"]),
             ("kan_sparse_int8_gemm", 8, CFKAN_L1["K"], CFKAN_L1["N"], CFKAN_L1["G"])]
    wrapper = {"kan_int8_gemm": ops.kan_int8_gemm, "kan_sparse_int8_gemm": ops.kan_sparse_int8_gemm}
    plain = {"kan_int8_gemm": I8.kan_int8_gemm_reference,
             "kan_sparse_int8_gemm": S.kan_sparse_int8_gemm_reference}
    results = {n: {"max_abs_err": 0.0, "timings": []} for n in (*wrapper, "bspline_lut")}
    for name, rows, K, N, G in cases:
        grid = SplineGrid(-1.0, 1.0, G, 3)
        M, P = grid.n_basis, grid.P
        qg = Q.QuantizedGrid.make(grid)
        lut8 = torch.as_tensor(Q.build_lut_u8(P, qg.S), device="cuda")
        set_bytes = rows * K * 4 + K * M * N
        n_sets = max(1, math.ceil(L2_FLUSH_BYTES / set_bytes))
        g = torch.Generator(device="cuda").manual_seed(rows + K)
        sets = []
        for _ in range(n_sets):
            x = torch.rand(rows, K, generator=g, device="cuda") * 2.4 - 1.2
            cq = torch.randint(-127, 128, (K, M, N), generator=g, device="cuda",
                               dtype=torch.int8)
            sets.append((qg.x_quant.quantize(x), cq))
        sc = torch.rand(N, generator=g, device="cuda") * 1e-3
        kw = dict(scale=sc, lut_scale=qg.lut_scale)
        ms = time_ms(torch, [lambda a=a, c=c: wrapper[name](a, lut8, c, grid, **kw)
                             for a, c in sets], cycles_per_ms)
        plain_ms = time_ms(torch, [lambda a=a, c=c: plain[name](a, c, grid, scale=sc,
                                                                lut_scale=qg.lut_scale)
                                   for a, c in sets], cycles_per_ms, reps=10)
        bvals, k = int8_compact_values_inblock(sets[0][0], grid, qg.S, 255, qg.lut_scale)
        band = band_scatter(bvals.float(), k, M).to(torch.bfloat16).reshape(rows, K * M)
        w_lib = [c.to(torch.bfloat16).reshape(K * M, N) for _, c in sets]
        lib_ms = time_ms(torch, [lambda w=w: torch.matmul(band, w) for w in w_lib],
                         cycles_per_ms)
        ops_ = 2.0 * rows * K * (P + 1) * N
        if name == "kan_int8_gemm":
            coeff_bytes = K * M * N
        else:                            # the int8 rows the inputs' windows touch
            touched = torch.zeros(K, M, dtype=torch.bool, device="cuda")
            jj = torch.arange(K, device="cuda")[None, :].expand(rows, K)
            for i in range(P + 1):
                touched[jj, k.long() - P + i] = True
            coeff_bytes = int(touched.sum().item()) * N
        nbytes = rows * K * 4 + coeff_bytes + N * 4 + rows * N * 4
        t_ops = ops_ / PEAK_FLOPS["int8"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        entry = {"shape": [rows, K, N], "M": M, "dtype": "float32", "ms": ms,
                 "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": max(t_ops, t_bytes),
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                 "ops": ops_, "bytes": nbytes}
        results[name]["timings"].append(entry)
        log(f"[time] {name} rows={rows} K={K} N={N} M={M}: kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={entry['bound_ms']:.4f} "
            f"({entry['bound_by']}: {ops_ / 1e9:.3f} G int8 ops, {nbytes / 1e6:.2f} MB)")

    grid = SplineGrid(-1.0, 1.0, MNIST["G"], MNIST["P"])
    lut = torch.as_tensor(build_lut(grid.P), device="cuda")
    n = MNIST["rows"] * K1
    n_sets = max(1, math.ceil(L2_FLUSH_BYTES / (n * 4)))
    xs = [net_inputs(torch, grid, MNIST["rows"], K1, "cuda", seed=30 + i).reshape(-1)
          for i in range(n_sets)]
    ms = time_ms(torch, [lambda x=x: ops.bspline_lut(x, lut, grid) for x in xs], cycles_per_ms)
    plain_ms = time_ms(torch, [lambda x=x: L.bspline_lut_reference(x, lut, grid) for x in xs],
                       cycles_per_ms, reps=10)
    nbytes = n * 4 + lut.numel() * 4 + n * (grid.P + 1) * 4 + n * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    results["bspline_lut"]["timings"].append(
        {"shape": [MNIST["rows"], K1], "dtype": "float32", "ms": ms, "plain_ms": plain_ms,
         "library_ms": None, "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes})
    log(f"[time] bspline_lut n={n} S={lut.shape[0]}: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms=None bound_ms={bound:.4f} (bytes: {nbytes / 1e6:.2f} MB)")
    return results


# Phase 8: GKAN (benchmarks/workloads.py, Table II), the P = 1 workload
GKAN = {"layers": (200, 16, 7), "G": 2, "P": 1, "rows": 2048, "decode_rows": 8}


def gkan_path(torch, device="cuda", rows=GKAN["rows"]):
    """GKAN through ``kan_net_apply(method="auto")`` at 8 rows (the sparse
    kernel) and ``rows`` rows (the fused kernel), each against
    ``method="compact"`` on the same device; any miss raises."""
    from repro_torch.core import kan_layer as KL

    cfg = KL.KANNetConfig(layers=GKAN["layers"], G=GKAN["G"], P=GKAN["P"])
    grid = cfg.grid()
    params = KL.init_kan_net(cfg, seed=0, device=device)
    x = net_inputs(torch, grid, rows, GKAN["layers"][0], device, seed=16)
    n_layers = len(GKAN["layers"]) - 1
    runs, errs = {}, {}
    for n, kernel in ((GKAN["decode_rows"], "kan_sparse_gemm"), (rows, "kan_fused_gemm")):
        y, runs[f"gkan_{n}"] = counted(
            torch, f"GKAN {list(GKAN['layers'])} G={grid.G} P={grid.P} auto, {n} rows",
            lambda n=n: KL.kan_net_apply(params, x[:n], cfg, "auto"), {kernel: n_layers},
            device, tag="gkan")
        want = KL.kan_net_apply(params, x[:n], cfg, "compact")
        if y.shape != (n, GKAN["layers"][-1]) or not torch.isfinite(y).all():
            raise RuntimeError(f"GKAN logits at {n} rows not finite or of the wrong shape")
        errs[n] = (y - want).abs().max().item()
        log(f"[gkan] {n} rows ({kernel}, M={grid.n_basis}) vs compact: "
            f"max_abs_err={errs[n]:.3e} tol={FP32_ATOL:.1e}")
        if errs[n] > FP32_ATOL:
            raise RuntimeError(f"GKAN at {n} rows: the kernel path disagrees with compact")
    return {"runs": runs, "max_abs_err": max(errs.values())}


# Phase 9(a): MNIST-KAN trained at benchmarks/quant_accuracy.train_mnist_kan()'s
# defaults, then the §V int8 gap.  The reference's figures come from the JAX
# package on the CPU (jax 0.9.0, default threefry):
#   PYTHONPATH=src:. JAX_PLATFORMS=cpu python -c "from benchmarks import
#   quant_accuracy as qa; cfg, p, (X, Y) = qa.train_mnist_kan();
#   print(qa.accuracy_fp(cfg, p, X, Y), qa.accuracy_int8(cfg, p, X, Y))"
# which prints 0.93212890625 (1909 of 2048) and 0.931640625 (1908).
MNIST_TRAIN = {"steps": 250, "bs": 256, "lr": 3e-3, "seed": 0}
REF_ACC = {"fp32": 1909 / 2048, "int8": 1908 / 2048}
ACC_TOL = 0.01                     # the card's fp32 accuracy within 1.0 pt of REF_ACC
PAPER_DROP = 0.01                  # paper §V: int8 accuracy under 1 pt below fp32


def mnist_train_path(torch, np, device="cuda", layers=MNIST["layers"],
                     steps=MNIST_TRAIN["steps"], card=""):
    """Phase 9(a) (any miss raises): ``train_mnist_kan`` on ``device``
    through the ``dense`` path, then the 2048 test inputs through
    ``dense``, ``auto`` (the fused kernel), ``lut`` (the LUT kernel) and the
    int8 path quantised on ``device`` (the dense-band int8 kernel), each run
    counted.  ``auto`` within ``FP32_ATOL`` of ``dense``, the int8 logits
    equal to the plain integer path's, and at the reference's width and
    steps the fp32 accuracy within ``ACC_TOL`` of ``REF_ACC``.
    ``device="cpu"`` with a narrow ``layers`` and few ``steps`` rehearses
    the checks on the kernels' plain versions."""
    from repro_torch.core import kan_layer as KL
    from repro_torch.data import pipeline as dp
    from repro_torch.examples import mnist_kan as MK

    full = tuple(layers) == MNIST["layers"] and steps == MNIST_TRAIN["steps"]
    nl = len(layers) - 1

    def train_fn():
        return MK.train_mnist_kan(steps=steps, bs=MNIST_TRAIN["bs"], lr=MNIST_TRAIN["lr"],
                                  seed=MNIST_TRAIN["seed"], G=MNIST["G"], P=MNIST["P"],
                                  layers=layers, device=device)

    (cfg, params, (Xte, Yte)), train = counted(
        torch, f"train_mnist_kan {list(layers)}, {steps} steps (dense, autograd)", train_fn,
        {}, device, tag="mnist")
    t0 = time.perf_counter()                 # the host's share: the data sets and the start
    dp.mnist_like(8192, seed=1, noise=2.4, dim=layers[0])
    dp.mnist_like(2048, seed=2, noise=2.4, dim=layers[0])
    MK.init_kan_net_threefry(cfg, seed=MNIST_TRAIN["seed"], device="cpu")
    host_ms = (time.perf_counter() - t0) * 1e3
    ms_step = (train["wall_ms"] - host_ms) / max(steps, 1)
    log(f"[mnist] trained {steps} steps in {train['wall_ms'] / 1e3:.3f} s of wall, of which "
        f"{host_ms / 1e3:.3f} s draw 8192 + 2048 synthetic inputs and the threefry start on "
        f"the host: {ms_step:.3f} ms per step on {device} {card}")
    x = torch.as_tensor(Xte, device=device)
    runs = {"train": train}
    with torch.no_grad():
        yd, runs["dense"] = counted(torch, "trained net dense, 2048 rows",
                                    lambda: KL.kan_net_apply(params, x, cfg, "dense"), {},
                                    device, tag="mnist")
        ya, runs["auto"] = counted(torch, "trained net auto, 2048 rows",
                                   lambda: KL.kan_net_apply(params, x, cfg, "auto"),
                                   {"kan_fused_gemm": nl}, device, tag="mnist")
        yl, runs["lut"] = counted(torch, "trained net lut, 2048 rows",
                                  lambda: KL.kan_net_apply(params, x, cfg, "lut"),
                                  {"bspline_lut": nl}, device, tag="mnist")
        qlayers = MK.quantize_net(cfg, params)
        y8, runs["int8"] = counted(torch, "trained net int8, 2048 rows",
                                   lambda: MK.int8_net_apply(qlayers, x),
                                   {"kan_int8_gemm": nl}, device, tag="mnist")
        y8_plain = MK.int8_net_apply(qlayers, x, fused=False)
    for name, y in (("dense", yd), ("auto", ya), ("lut", yl), ("int8", y8)):
        if y.shape != (len(Xte), layers[-1]) or not torch.isfinite(y).all():
            raise RuntimeError(f"trained MNIST-KAN {name} logits not finite or of the wrong shape")
    err_auto = (ya - yd).abs().max().item()
    log(f"[mnist] auto vs dense: max_abs_err={err_auto:.3e} tol={FP32_ATOL:.1e} "
        f"(max |logit| {yd.abs().max().item():.4f})")
    if err_auto > FP32_ATOL:
        raise RuntimeError("trained MNIST-KAN: auto disagrees with dense")
    if not torch.equal(y8, y8_plain):
        raise RuntimeError("trained MNIST-KAN: int8 logits != the plain integer path's")
    acc = {name: MK.accuracy(y, Yte) for name, y in
           (("fp32", yd), ("auto", ya), ("lut", yl), ("int8", y8))}
    drop = acc["fp32"] - acc["int8"]
    ref_drop = REF_ACC["fp32"] - REF_ACC["int8"]
    log(f"[mnist] accuracy on 2048 test inputs: fp32 (dense) {acc['fp32'] * 100:.4f} %, auto "
        f"{acc['auto'] * 100:.4f} %, lut {acc['lut'] * 100:.4f} %, int8 {acc['int8'] * 100:.4f} %; "
        f"the reference (JAX, CPU) fp32 {REF_ACC['fp32'] * 100:.4f} %, int8 "
        f"{REF_ACC['int8'] * 100:.4f} %")
    log(f"[mnist] int8 drop {drop * 100:.4f} pt against the reference's {ref_drop * 100:.4f} pt "
        f"and the paper's claim < {PAPER_DROP * 100:.0f} pt "
        f"({'met' if drop < PAPER_DROP else 'MISSED'}); int8 logits equal the plain integer "
        f"path's on {device}")
    if full:
        miss = abs(acc["fp32"] - REF_ACC["fp32"])
        log(f"[mnist] fp32 accuracy {miss * 100:.4f} pt from the reference's "
            f"(tol {ACC_TOL * 100:.1f} pt)")
        if miss > ACC_TOL:
            raise RuntimeError("trained MNIST-KAN: fp32 accuracy misses the reference's")
    out = {"runs": runs, "accuracy": acc, "int8_drop": drop, "reference_accuracy": REF_ACC,
           "auto_vs_dense_err": err_auto, "train_s": train["wall_ms"] / 1e3,
           "train_host_data_s": host_ms / 1e3, "train_ms_per_step": ms_step, "steps": steps}
    if device == "cuda":                     # the whole training again, then under the profiler
        out["profile_train"] = profile_call(
            torch, train_fn, lambda: f"train_mnist_kan, {steps} steps (warm)")
    return out


# Phase 9(b): ConvKAN at ResKAN18's 20 layer shapes (Table II; CIFAR-size
# images, a batch of 32: 512 to 32,768 rows per layer).
RESKAN = {"G": 3, "P": 3, "img": 32, "batch": 32}
# K reaches 4608: an output sums 5 x 4608 fp32 products in the kernel's
# order, against the plain version's; on the CPU two such orders (compact
# and the plain band) differ by 2.1e-7 of max|y| at K = 4608, and this is
# 70 x that
CONV_REL = 2.0 ** -16


def reskan_layers(img: int = RESKAN["img"]) -> list[dict]:
    """The 20 conv layers of ``sa_model.resnet18_convkan_gemms``: the first
    conv of each later stage and the three 1 x 1 downsample convs take their
    input at twice the output size with stride 2; pad 1 for 3 x 3, 0 for
    1 x 1."""
    from repro_torch.core import sa_model as SM

    out = []
    for w in SM.resnet18_convkan_gemms(G=RESKAN["G"], P=RESKAN["P"], img=img):
        name = w.name.split(".")[-1]
        k = 1 if name.startswith("down") else 3
        cin, s = w.K // (k * k), math.isqrt(w.BS)
        stride = 1 if name == "conv1" or cin == w.N_out else 2
        out.append({"name": name, "cin": cin, "cout": w.N_out, "k": k, "stride": stride,
                    "pad": k // 2, "s_in": s * stride, "s": s, "K": w.K})
    return out


def reskan_path(torch, device="cuda", batch=RESKAN["batch"], img=RESKAN["img"]):
    """Phase 9(b) (any miss raises): each ResKAN18 layer once through
    ``conv_kan_apply(method="auto")`` on its own random input in [-1, 1] with
    random weights (seeded), the 20 layers in one counted run; each layer
    within ``CONV_REL`` of max|y| of the fused kernel's plain version on the
    same patches; ``im2col`` on ``device`` equal to the CPU's for one layer
    of each kind.  On the card, the fused kernel timed at every distinct
    shape.  ``device="cpu"`` with a small ``batch`` and ``img`` rehearses
    the checks."""
    from repro_torch.core import kan_layer as KL
    from repro_torch.core.bspline import SplineGrid
    from repro_torch.kernels import kan_fused_gemm as F

    grid = SplineGrid(-1.0, 1.0, RESKAN["G"], RESKAN["P"])
    layers = reskan_layers(img)
    gen = torch.Generator(device=device).manual_seed(17)
    xs, ps = [], []
    for ly in layers:
        xs.append(torch.rand(batch, ly["s_in"], ly["s_in"], ly["cin"], generator=gen,
                             device=device) * 2 - 1)
        ps.append(KL.init_kan_layer(KL.KANLayerConfig(ly["K"], ly["cout"], grid), gen))

    def conv(i, method="auto"):
        ly = layers[i]
        return KL.conv_kan_apply(ps[i], xs[i], grid, kh=ly["k"], kw=ly["k"],
                                 stride=ly["stride"], pad=ly["pad"], method=method)

    ys, run = counted(torch, f"ResKAN18 20 ConvKAN layers, batch {batch} of {img} x {img}",
                      lambda: [conv(i) for i in range(len(layers))],
                      {"kan_fused_gemm": len(layers)}, device, tag="reskan")
    errs, kinds = [], {}
    for i, (ly, y) in enumerate(zip(layers, ys)):
        patches = KL.im2col(xs[i], ly["k"], ly["k"], ly["stride"], ly["pad"])
        want = F.kan_fused_gemm_reference(patches.reshape(-1, ly["K"]), ps[i]["coeff"], grid,
                                          ps[i]["base_w"]).reshape(y.shape)
        if y.shape != (batch, ly["s"], ly["s"], ly["cout"]) or not torch.isfinite(y).all():
            raise RuntimeError(f"ResKAN18 {ly['name']}: output not finite or of the wrong shape")
        scale = want.abs().max().item()
        err = (y - want).abs().max().item() / scale
        errs.append(err)
        log(f"[reskan] {ly['name']:<6} {ly['cin']:>3} -> {ly['cout']:>3} k={ly['k']} "
            f"s={ly['stride']} {ly['s_in']:>2} -> {ly['s']:>2}: rows={batch * ly['s'] ** 2} "
            f"K={ly['K']} max|y|={scale:.4f} max_abs_err/max|y|={err:.3e} tol={CONV_REL:.2e}")
        if err > CONV_REL:
            raise RuntimeError(f"ResKAN18 {ly['name']}: the kernel path disagrees with the "
                               "plain version")
        kind = (ly["name"] == "conv1", ly["k"], ly["stride"])
        if kind not in kinds:
            kinds[kind] = torch.equal(patches.cpu(), KL.im2col(
                xs[i].cpu(), ly["k"], ly["k"], ly["stride"], ly["pad"]))
            if not kinds[kind]:
                raise RuntimeError(f"ResKAN18 {ly['name']}: im2col on {device} != on the CPU")
    log(f"[reskan] im2col on {device} equal to the CPU's for {len(kinds)} kinds of layer "
        f"(conv1, 3 x 3 stride 1, 3 x 3 stride 2, 1 x 1 stride 2)")
    out = {"runs": {"reskan18": run}, "max_rel_err": max(errs), "im2col_kinds_equal": len(kinds),
           "layers": [dict(ly, rows=batch * ly["s"] ** 2, rel_err=e)
                      for ly, e in zip(layers, errs)]}
    if device == "cuda":
        out["profile"] = profile_call(torch, lambda: [conv(i) for i in range(len(layers))],
                                      lambda: "the 20 ResKAN18 layers (warm)")
        out.update(time_reskan(torch, layers, xs, batch, grid))
    return out


def time_reskan(torch, layers, xs, batch, grid):
    """The fused kernel at every distinct ResKAN18 shape, fp32: kernel, plain
    version, one matmul over the materialised band (``library_ms``) and the
    bound, rotating (x, C, Wb) sets past the L2, the first set the patches
    of a layer of that shape; then the 20 layers' kernel ms summed."""
    from repro_torch.core import kan_layer as KL
    from repro_torch.kernels import kan_fused_gemm as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import band_scatter, compact_basis_inblock

    cycles_per_ms = spin_cycles_per_ms(torch)
    M, P = grid.n_basis, grid.P
    shape_of = [(batch * ly["s"] ** 2, ly["K"], ly["cout"]) for ly in layers]
    timings, by_shape = [], {}
    for (rows, K, N), i in sorted({sh: i for i, sh in enumerate(shape_of)}.items()):
        ly = layers[i]
        g = torch.Generator(device="cuda").manual_seed(rows + K + N)
        set_bytes = (rows * K + K * M * N + K * N) * 4
        n_sets = min(30, max(1, math.ceil(L2_FLUSH_BYTES / set_bytes)))
        first = KL.im2col(xs[i], ly["k"], ly["k"], ly["stride"], ly["pad"]).reshape(rows, K)
        sets = [(first if j == 0 else torch.rand(rows, K, generator=g, device="cuda") * 2 - 1,
                 0.02 * torch.randn(K, M, N, generator=g, device="cuda"),
                 0.02 * torch.randn(K, N, generator=g, device="cuda")) for j in range(n_sets)]
        ms = time_ms(torch, [lambda s=s: ops.kan_fused_gemm(s[0], s[1], grid, s[2])
                             for s in sets], cycles_per_ms)
        plain_ms = time_ms(torch, [lambda s=s: F.kan_fused_gemm_reference(s[0], s[1], grid, s[2])
                                   for s in sets], cycles_per_ms, reps=10)
        x0 = sets[0][0]
        vals, k = compact_basis_inblock(x0, grid)
        a_lib = torch.cat([band_scatter(vals, k, M).reshape(rows, K * M),
                           torch.clamp_min(x0, 0)], dim=1)
        del vals, k
        w_lib = [torch.cat([c.reshape(K * M, N), w], dim=0) for _, c, w in sets]
        lib_ms = time_ms(torch, [lambda wl=wl: torch.matmul(a_lib, wl) for wl in w_lib],
                         cycles_per_ms)
        del a_lib, w_lib, sets
        flops = 2.0 * rows * K * (P + 2) * N
        nbytes = (rows * K + K * M * N + K * N + rows * N) * 4
        t_ops = flops / PEAK_FLOPS["float32"] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        n_layers = shape_of.count((rows, K, N))
        entry = {"shape": [rows, K, N], "M": M, "dtype": "float32", "ms": ms,
                 "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": max(t_ops, t_bytes),
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes", "flops": flops,
                 "bytes": nbytes, "path": "reskan18", "layers": n_layers}
        timings.append(entry)
        by_shape[(rows, K, N)] = ms
        log(f"[time] kan_fused_gemm ResKAN18 rows={rows} K={K} N={N} M={M} x{n_layers}: "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={entry['bound_ms']:.4f} ({entry['bound_by']}: {flops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB)")
        torch.cuda.empty_cache()
    total = sum(by_shape[sh] for sh in shape_of)
    log(f"[time] kan_fused_gemm over the 20 ResKAN18 layers: {total:.4f} ms of kernel time "
        f"(sum of each layer's shape's kernel_ms)")
    return {"timings": timings, "kernel_ms_total": total}


# Phase 10: the dense models of ROADMAP item 6.  qwen1.5-0.5b (the
# conventional-DNN control: a SwiGLU MLP where kanformer has a KAN FFN) at
# full width through every serving path, int8 KV caches on two of them,
# and gemma3-12b at full width and depth on the static path, past its
# window.  Tolerances are relative to max|logit| of the logits compared
# (fp32 sums in another order; derived on the CPU, PERF.md §6):
# qwen1.5-0.5b's depth in phase 10 and in phase 18's rehearsal: 8 of its 24
# layers at full width.  With phase 18 (mesh training) added and qwen at
# full depth the whole script took 1282.1 s of command time on a slow host
# (H100 80GB HBM3, 700 W; phase 10 246.8 s, ~218 s of it qwen's cells) and
# ~1077 s on another; the cut keeps every check and exact launch count.
QWEN_REPEATS = 8
DENSE_REL = 1e-4                   # teacher-forced decode vs lm.forward
DENSE_TIE = 1e-4                   # streams may part only at a top-2 gap below this
QUANT_REL, QUANT_AGREE = 0.1, 0.9  # int8 KV vs fp32 KV (the reference's bounds)
GEMMA = {"extra": 76, "batch": 4, "new": 32, "hist": 32}   # prompts: window + 76 tokens
QUANT_TOKENS = 48                  # int8 vs fp32 KV: tokens teacher-forced from position 0
# the profiled warm runs of (b) and (c): the cell's first wave of requests
# (one per slot), each cut to one chunk of tokens: the profiler's own cost
# grows with the kernels it records (~0.5 ms each), ~2000 per decode step
PROFILE_WAVE = {"requests": CONT["slots"], "tokens": CONT["chunk_steps"]}
DENSE_QUANT_RUNS = [("int8_dense", {}), ("int8_paged_step", {"paged": True, "paged_read": "step"})]
DENSE_SPEC_RUNS = [("spec_dense", {"spec_k": SPEC_K, "draft_layers": 1}),
                   ("spec_paged_shadow", {"spec_k": SPEC_K, "draft_layers": 1, "paged": True})]


def rel_gaps(torch, np, params, cfg, prompt, stream, device):
    """Entry ``j``: the top-2 gap of the logits (``lm.forward`` of the
    prompt and ``stream[:j]``) that predict ``stream[j]``, over max|logit|."""
    from repro_torch.models import lm

    seq = np.concatenate([prompt, stream[:-1]]).astype(np.int64)
    logits, _ = lm.forward(params, cfg, torch.as_tensor(seq[None], device=device))
    lg = logits[0, len(prompt) - 1:]
    top = torch.topk(lg, 2, dim=-1).values
    return ((top[:, 0] - top[:, 1]) / lg.abs().amax()).cpu().numpy()


def held_streams(torch, np, tag, outs, ref, params, cfg, reqs, device, gaps, exact=False,
                 group="dense"):
    """Each of ``outs`` equal to ``ref``, unless (``exact`` False) the first
    divergence is a near-tie of ``ref``'s logits; returns the divergences."""
    divs = []
    for i, (o, r) in enumerate(zip(outs, ref)):
        diff = np.nonzero(o != r)[0]
        if not diff.size:
            continue
        j = int(diff[0])
        if exact:
            raise RuntimeError(f"{tag}: request {i} diverges at step {j}")
        if i not in gaps:
            gaps[i] = rel_gaps(torch, np, params, cfg, reqs[i], r, device)
        g = float(gaps[i][j])
        divs.append({"run": tag, "request": i, "step": j, "top2_gap_rel": g})
        log(f"[{group}] {tag}: request {i} diverges at step {j}; top-2 gap {g:.3e} of "
            f"max|logit| (tol {DENSE_TIE:.0e})")
        if g >= DENSE_TIE:
            raise RuntimeError(f"{tag}: request {i} diverges at step {j}, not a near-tie")
    return divs


def continuous_run(torch, np, params, model, base, extra, cell, label, device, tag,
                   hold_gathers=False, stamp=lambda: ""):
    """One ``serve_continuous`` run of ``cell = (requests, budgets, slots)``
    on a new engine (``base`` with ``extra`` applied), any miss raises: the
    launch counts reset just before and checked exactly just after (from
    the run's own stats), the pool balanced after the drain, every output
    in range, a prefix hit wherever a paged run caches prefixes, and a
    preemption wherever ``extra`` sets a pool size.  MoE drops are metered;
    with ``hold_gathers`` every gather of a paged run is held bit for bit
    against its plain version, and on the card their count against kernel
    5's launches.  Returns ``(engine, outputs, metrics)``."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_gather as PG
    from repro_torch.serve.engine import Engine

    cuda = device == "cuda"
    reqs, budgets, slots = cell
    paged = extra.get("paged", False)
    eng = Engine(params, model, dataclasses.replace(base, **extra), device=device)
    real_gather, held = ops.gather_views, [0]

    def spy(cache, table, stacked=False):
        got = real_gather(cache, table, stacked)
        want = PG.gather_views_reference(cache, table, stacked)
        if list(got) != list(want) or not all(torch.equal(got[n], want[n]) for n in want):
            raise RuntimeError(f"{label}: a gather of the run disagrees with its plain version")
        held[0] += 1
        return got

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if hold_gathers and paged:
        ops.gather_views = spy
    try:
        with DropMeter() as meter:
            outs, c = counted(
                torch, label, lambda: eng.serve_continuous(
                    reqs, slots=slots, chunk_steps=CONT["chunk_steps"], max_new=budgets),
                lambda: expected_launches(model, eng.last_serve_stats, extra, slots), device,
                tag=tag)
    finally:
        ops.gather_views = real_gather
    st = eng.last_serve_stats
    pg = st.get("paged", {})
    if pg and pg["blocks_in_use"] != pg["blocks_cache_held"]:
        raise RuntimeError(f"{label}: the pool is not balanced after the drain: {pg}")
    for o, b in zip(outs, budgets):
        if o.shape != (b,) or o.min() < 0 or o.max() >= model.vocab:
            raise RuntimeError(f"{label}: bad output {o}")
    wall = c["wall_ms"] / 1e3
    steps = st["spec"]["windows"] if "spec" in st else st["chunks_run"] * CONT["chunk_steps"]
    m = {"tok_s": st["useful_tokens"] / wall, "wall_s": wall,
         "useful_tokens": st["useful_tokens"], "chunks": st["chunks_run"],
         "decode_ms_per_step": st["decode_s"] * 1e3 / steps, "prefill_s": st["prefill_s"],
         "n_preemptions": st["n_preemptions"],
         "prefill_tokens_saved": pg.get("prefill_tokens_saved", 0),
         "prefix_caching": "prefix_hit_blocks" in pg,
         "prefill_groups": [list(g) for g in st["prefill_groups"]],
         "blocks_watermark": pg.get("blocks_in_use_watermark"),
         "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None,
         "launches": c["launches"]}
    if "spec" in st:
        m.update({k: st["spec"][k] for k in ("windows", "proposed_drafts",
                                             "accepted_drafts", "acceptance_rate")})
    drops = ""
    if meter.calls:
        m.update(meter.summary())
        drops = (f"; moe_drop_frac {m['moe_drop_frac']:.4f} ({m['dropped_choices']} of "
                 f"{m['routed_choices']} choices, {m['calls_with_drops']} of {m['calls']} moe "
                 f"calls)")
    if hold_gathers and paged:
        m["gathers_held_bitwise"] = held[0]
        drops += f"; gathers held bit-equal {held[0]}"
    log(f"[{tag}] {label}: {m['useful_tokens']} tokens in {wall:.3f} s: {m['tok_s']:.2f} "
        f"tok/s; {m['decode_ms_per_step']:.3f} ms per decode "
        f"{'window' if 'spec' in st else 'step'}; admission prefills "
        f"{m['prefill_s'] * 1e3:.1f} ms; preemptions {m['n_preemptions']}; prefill tokens "
        f"saved {m['prefill_tokens_saved']}; block watermark {m['blocks_watermark']}"
        f"{'; acceptance %.4f' % m['acceptance_rate'] if 'spec' in st else ''}{drops}; "
        f"peak_mem_GB={(m['peak_mem_bytes'] or 0) / 1e9:.3f} {stamp()}")
    if paged and m["prefix_caching"] and m["prefill_tokens_saved"] <= 0:
        raise RuntimeError(f"{label}: no prefix hit")
    if extra.get("pool_blocks") and m["n_preemptions"] < 1:
        raise RuntimeError(f"{label}: the tight pool preempted nothing")
    if cuda and hold_gathers and paged and held[0] != c["launches"]["gather_blocks"]:
        raise RuntimeError(f"{label}: {held[0]} gathers held, "
                           f"{c['launches']['gather_blocks']} launched")
    return eng, outs, m


def tree_bytes(tree) -> int:
    from repro_torch.convert import flatten_with_paths

    return sum(t.numel() * t.element_size() for t in flatten_with_paths(tree).values())


def teacher_forced(torch, params, cfg, t, max_seq, start=None):
    """Logits that predict each next token of ``t (B, T)``: with ``start``
    None, decode steps fed every token from position 0 (``(B, T, vocab)``,
    as ``lm.forward(t)``); else a prefill of ``t[:, :start]`` then decode
    steps fed the rest (``(B, T - start, vocab)``, as ``lm.forward(t)[:,
    start - 1:T - 1]``)."""
    from repro_torch.models import lm

    B, T = t.shape
    if start is None:
        caches, got, s0, end = lm.init_caches(cfg, B, max_seq, torch.float32, t.device), [], 0, T
    else:
        logits, caches = lm.prefill(params, cfg, t[:, :start], max_seq)
        got, s0, end = [logits[:, start - 1]], start, T - 1
        del logits
    pos = torch.tensor(s0, device=t.device)
    for s in range(s0, end):
        lg, caches = lm.decode_step(params, cfg, t[:, s:s + 1], caches, pos)
        got.append(lg)
        pos = pos + 1
    return torch.stack(got, 1)


def rel_err(a, b) -> float:
    return ((a - b).abs().amax() / b.abs().amax()).item()


def qwen_path(torch, np, device="cuda", cfg=None):
    """Phase 10 (a)-(d), any miss raises: qwen1.5-0.5b (random weights from
    seed 0, fp32) served statically, continuously (dense, paged shadow,
    paged step, a 25-block pool), with int8 KV caches (dense, paged step)
    and speculatively (a 1-layer drafter, dense and paged shadow), each run
    counted exactly.  ``device="cpu"`` with a reduced ``cfg`` rehearses it
    on the plain versions."""
    from repro_torch.configs import qwen1_5_0_5b
    from repro_torch.configs.common import ArchConfig, enable_kv_quant
    from repro_torch.convert import flatten_with_paths
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig, _to_device

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_start = time.perf_counter()

    def stamp() -> str:
        return f"(at {time.perf_counter() - t_start:.1f} s)"

    cfg = cfg or qwen1_5_0_5b.build(n_layers=QWEN_REPEATS).model
    qcfg = enable_kv_quant(ArchConfig(model=cfg, family="dense")).model
    params = lm.init_params(cfg, seed=0, device=device, dtype=torch.float32)
    out = {"params": sum(t.numel() for t in flatten_with_paths(params).values())}

    def counted_run(tag, fn, want):
        """:func:`counted` with the peak device memory of the run."""
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        res, m = counted(torch, tag, fn, want, device, tag="dense")
        return (res, m["wall_ms"] / 1e3, m["launches"],
                torch.cuda.max_memory_allocated() if cuda else None)

    # (a) the static cell: phase 4's requests
    batch, max_new, n_req = 4, 32, 8
    rs = np.random.RandomState(0)
    lens = rs.randint(32, 129, n_req)
    reqs = [rs.randint(0, cfg.vocab, L).astype(np.int32) for L in lens]
    max_seq = int(lens.max()) + max_new + 8
    eng = Engine(params, cfg, ServeConfig(max_seq=max_seq, max_new_tokens=max_new), device=device)
    log(f"[dense] qwen1.5-0.5b full width: d={cfg.d_model} layers={cfg.n_repeats} "
        f"d_ff={cfg.unit[0].d_ff} heads={cfg.unit[0].attn.n_heads} vocab={cfg.vocab} "
        f"params={out['params'] / 1e6:.1f}M fp32; {n_req} requests, prompt lengths "
        f"{sorted(lens.tolist())}, batch {batch}, max_new {max_new}")
    outs, wall, launches, peak = counted_run(
        "static", lambda: eng.serve_requests(reqs, batch_size=batch, seed=0), {})
    for o in outs:
        if o.shape != (max_new,) or o.min() < 0 or o.max() >= cfg.vocab:
            raise RuntimeError(f"static: bad output {o}")
    bk = eng.last_serve_stats["buckets"]
    total = sum(len(o) for o in outs)
    a = {"tok_s": total / wall, "wall_s": wall, "peak_mem_bytes": peak, "launches": launches,
         "prefill_ms": sum(b["prefill_s"] for b in bk) * 1e3 / len(bk),
         "decode_ms_per_step": sum(b["decode_s"] for b in bk) * 1e3
         / sum(b["decode_steps"] for b in bk)}
    gaps = {}
    solo = [eng.generate(r[None], max_new=max_new)[0] for r in reqs]
    a["divergences"] = held_streams(torch, np, "static vs solo", outs, solo, params, cfg, reqs,
                                    device, gaps)
    # teacher-forced decode of the first bucket's rows against lm.forward
    errs = []
    for i in sorted(range(n_req), key=lambda i: lens[i])[:batch]:
        t = torch.as_tensor(np.concatenate([reqs[i], outs[i]]).astype(np.int64)[None],
                            device=device)
        dec = teacher_forced(torch, params, cfg, t, max_seq, start=int(lens[i]))
        fwd, _ = lm.forward(params, cfg, t)
        errs.append(rel_err(dec, fwd[:, int(lens[i]) - 1:-1]))
    a["decode_vs_forward_rel"] = max(errs)
    log(f"[dense] static: teacher-forced decode vs lm.forward, {batch} requests x {max_new} "
        f"tokens: max err {a['decode_vs_forward_rel']:.3e} of max|logit| (tol {DENSE_REL:.0e}) "
        f"{stamp()}")
    if not a["decode_vs_forward_rel"] <= DENSE_REL:
        raise RuntimeError("qwen decode logits disagree with lm.forward")
    # two requests x 8 tokens on the host's CPU, the same weights
    cpu = Engine(_to_device(params, "cpu"), cfg, ServeConfig(max_seq=max_seq, max_new_tokens=8),
                 device="cpu")
    cpu_outs = [cpu.generate(reqs[i][None], max_new=8)[0] for i in (0, 1)]
    a["cpu_divergences"] = held_streams(torch, np, "card vs CPU", [outs[0][:8], outs[1][:8]],
                                        cpu_outs, params, cfg, reqs[:2], device, {})
    del cpu
    log(f"[dense] static: the first 8 tokens of 2 requests on the host's CPU: "
        f"{len(a['cpu_divergences'])} near-tie divergences {stamp()}")
    if cuda:
        t0 = time.perf_counter()
        eng.serve_requests(reqs, batch_size=batch, seed=0)
        sync()
        a["warm_tok_s"] = total / (time.perf_counter() - t0)
        wb = eng.last_serve_stats["buckets"]
        a["warm_decode_ms_per_step"] = (sum(b["decode_s"] for b in wb) * 1e3
                                        / sum(b["decode_steps"] for b in wb))
        order = sorted(range(n_req), key=lambda i: lens[i])[:batch]
        T = int(max(lens[i] for i in order))
        prompts = np.stack([np.pad(reqs[i], (0, T - lens[i])) for i in order]).astype(np.int32)
        a["profile"] = profile_generate(torch, eng, prompts, lens[order].astype(np.int32))
    log(f"[dense] static: {total} tokens in {wall:.3f} s: {a['tok_s']:.1f} tok/s cold, "
        f"{a.get('warm_tok_s')} warm; prefill_ms (mean per bucket) {a['prefill_ms']:.2f}; "
        f"decode_ms_per_step {a['decode_ms_per_step']:.3f} cold, "
        f"{a.get('warm_decode_ms_per_step')} warm; busy share "
        f"{a.get('profile', {}).get('busy_share')}; peak_mem_GB={(peak or 0) / 1e9:.3f} "
        f"{stamp()}")
    out["static"] = a
    del eng

    # (b)-(d) the continuous cell of phase 6
    creqs, budgets = continuous_requests(np, cfg.vocab)
    base = ServeConfig(max_seq=CONT["max_seq"], max_new_tokens=max(budgets),
                       block_size=CONT["block_size"])
    runs, streams, engines, divs = {}, {}, {}, []

    def run(name, model, extra):
        engines[name], streams[name], runs[name] = continuous_run(
            torch, np, params, model, base, extra, (creqs, budgets, CONT["slots"]), name,
            device, "dense", stamp=stamp)
        return runs[name]

    gaps = {}
    for name, extra in CONT_RUNS:                                  # (b)
        run(name, cfg, extra)
        if name != "dense":
            divs += held_streams(torch, np, name, streams[name], streams["dense"], params, cfg,
                                 creqs, device, gaps)
    real_gather, leaf_counts = ops.gather_views, []

    def spy(cache, table, stacked=False):                       # leaves per launch
        leaf_counts.append(len(cache))
        return real_gather(cache, table, stacked)

    ops.gather_views = spy
    try:
        for name, extra in DENSE_QUANT_RUNS:                       # (c)
            m = run(name, qcfg, extra)
            if m["prefill_tokens_saved"] != 0 or (extra.get("paged") and m["prefix_caching"]):
                raise RuntimeError(f"{name}: prefix caching under an int8 KV cache")
    finally:
        ops.gather_views = real_gather
    n_gather = runs["int8_paged_step"]["launches"]["gather_blocks"] if cuda else len(leaf_counts)
    log(f"[dense] int8_paged_step: {len(leaf_counts)} gathers, leaves per launch "
        f"{sorted(set(leaf_counts))}, {n_gather} counted launches")
    if set(leaf_counts) != {4} or len(leaf_counts) != n_gather:
        raise RuntimeError("the int8 paged path did not gather its four leaves in one launch")
    held_streams(torch, np, "int8_paged_step vs int8_dense", streams["int8_paged_step"],
                 streams["int8_dense"], params, qcfg, creqs, device, {}, exact=True)
    for name, extra in DENSE_SPEC_RUNS:                            # (d)
        run(name, cfg, extra)
        divs += held_streams(torch, np, name, streams[name], streams["dense"], params, cfg,
                             creqs, device, gaps)
    log(f"[dense] near-tie divergences from the dense streams: {len(divs)}")

    # int8 against fp32 KV, teacher-forced through decode steps from 0
    t = torch.as_tensor(creqs[0][:QUANT_TOKENS].astype(np.int64)[None], device=device)
    fp = teacher_forced(torch, params, cfg, t, t.shape[1])
    q8 = teacher_forced(torch, params, qcfg, t, t.shape[1])
    quant = {"tokens": int(t.shape[1]), "rel": rel_err(q8, fp),
             "agree": (fp.argmax(-1) == q8.argmax(-1)).float().mean().item()}
    for name, model in (("fp32", cfg), ("int8", qcfg)):      # shapes only: no memory
        quant[f"dense_kv_bytes_{name}"] = tree_bytes(lm.init_caches(
            model, CONT["slots"], CONT["max_seq"], torch.float32, "meta"))
        quant[f"pool_kv_bytes_{name}"] = tree_bytes(lm.init_paged_caches(
            model, CONT["slots"] * CONT["max_seq"] // CONT["block_size"] + 1,
            CONT["block_size"], torch.float32, "meta"))
    log(f"[dense] int8 vs fp32 KV, {quant['tokens']} tokens teacher-forced: max err "
        f"{quant['rel']:.3e} of max|logit| (< {QUANT_REL}), top-1 agreement "
        f"{quant['agree']:.4f} (> {QUANT_AGREE}); KV bytes dense {quant['dense_kv_bytes_fp32']} "
        f"fp32 / {quant['dense_kv_bytes_int8']} int8, pool {quant['pool_kv_bytes_fp32']} fp32 / "
        f"{quant['pool_kv_bytes_int8']} int8 {stamp()}")
    if not (quant["rel"] < QUANT_REL and quant["agree"] > QUANT_AGREE):
        raise RuntimeError("int8 KV logits too far from fp32 KV")

    if cuda:      # one warm run of (b) and of (c), each profiled
        wave = creqs[:PROFILE_WAVE["requests"]]
        for key, name in (("profile_cont", "paged_shadow"), ("profile_int8", "int8_paged_step")):
            eng, stats = engines[name], []

            def serve_wave(eng=eng, stats=stats):
                eng.serve_continuous(wave, slots=CONT["slots"], chunk_steps=CONT["chunk_steps"],
                                     max_new=PROFILE_WAVE["tokens"])
                stats.append(eng.last_serve_stats)

            prof = profile_call(torch, serve_wave, lambda name=name: (
                f"one warm qwen {name} run of the cell's first {len(wave)} requests, "
                f"{PROFILE_WAVE['tokens']} tokens each"))
            st = stats[0]                       # the unprofiled call's
            steps = st["chunks_run"] * CONT["chunk_steps"]
            prof.update({"warm_tok_s": st["useful_tokens"] / (prof["wall_ms"] / 1e3),
                         "warm_decode_ms_per_step": st["decode_s"] * 1e3 / steps,
                         "warm_prefill_ms": st["prefill_s"] * 1e3, "decode_steps": steps})
            log(f"[dense] {name} warm wave: {prof['warm_tok_s']:.1f} tok/s, "
                f"{prof['warm_decode_ms_per_step']:.3f} ms per decode step, admission prefill "
                f"{prof['warm_prefill_ms']:.1f} ms (unprofiled), busy share "
                f"{prof['busy_share']} {stamp()}")
            out[key] = prof
    out.update({"runs": runs, "divergences": divs, "int8_vs_fp32": quant})
    return out


def gemma_path(torch, np, device="cuda", cfg=None):
    """Phase 10 (e), any miss raises: gemma3-12b at full width and depth
    (random weights from seed 0, fp32): 4 prompts of ``window + 76`` tokens
    served statically (prefill places the rings, decode wraps them), the
    teacher-forced decode logits against ``lm.forward``'s windowed flash
    mask; then a history inside the window decoded through the rings and
    through full caches, both against ``lm.forward``."""
    import dataclasses

    from repro_torch.configs import gemma3_12b
    from repro_torch.convert import flatten_with_paths
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    cuda = device == "cuda"
    cfg = cfg or gemma3_12b.config().model
    window = cfg.unit[0].attn.window
    B, new = GEMMA["batch"], GEMMA["new"]
    T = window + GEMMA["extra"]
    params = lm.init_params(cfg, seed=0, device=device, dtype=torch.float32)
    n_params = sum(t.numel() for t in flatten_with_paths(params).values())
    rs = np.random.RandomState(3)
    prompts = rs.randint(0, cfg.vocab, (B, T)).astype(np.int32)
    max_seq = T + new
    log(f"[gemma] gemma3-12b full width: d={cfg.d_model} layers={cfg.n_layers} "
        f"({len(cfg.unit) - 1} local, window {window} : 1 global) d_ff={cfg.unit[0].d_ff} "
        f"vocab={cfg.vocab} params={n_params / 1e9:.2f}B fp32; {B} prompts of {T} tokens, "
        f"{new} new")
    eng = Engine(params, cfg, ServeConfig(max_seq=max_seq, max_new_tokens=new), device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    outs, m = counted(torch, "static", lambda: eng.serve_requests(list(prompts), batch_size=B),
                      {}, device, tag="gemma")
    wall, launches = m["wall_ms"] / 1e3, m["launches"]
    gs = eng.last_generate_stats
    res = {"params": n_params, "tok_s": B * new / wall, "wall_s": wall,
           "prefill_ms": gs["prefill_s"] * 1e3,
           "decode_ms_per_step": gs["decode_s"] * 1e3 / gs["decode_steps"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None,
           "launches": launches}
    stream = np.stack(outs)
    if stream.shape != (B, new) or stream.min() < 0 or stream.max() >= cfg.vocab:
        raise RuntimeError(f"gemma: bad output {stream}")
    del eng
    t = torch.as_tensor(np.concatenate([prompts, stream], 1).astype(np.int64), device=device)
    dec = teacher_forced(torch, params, cfg, t, max_seq, start=T)
    if not torch.equal(dec.argmax(-1).cpu(), torch.as_tensor(stream.astype(np.int64))):
        raise RuntimeError("gemma: the served streams are not the decode logits' argmax")
    fwd, _ = lm.forward(params, cfg, t[:, :-1])
    res["decode_vs_forward_rel"] = rel_err(dec, fwd[:, T - 1:])
    res["agree"] = (dec.argmax(-1) == fwd[:, T - 1:].argmax(-1)).float().mean().item()
    del fwd, dec
    log(f"[gemma] static: {B * new} tokens in {wall:.3f} s: {res['tok_s']:.2f} tok/s; prefill "
        f"{res['prefill_ms']:.1f} ms; {res['decode_ms_per_step']:.3f} ms per decode step; "
        f"peak_mem_GB={(res['peak_mem_bytes'] or 0) / 1e9:.3f}; teacher-forced decode past the "
        f"window vs lm.forward: max err {res['decode_vs_forward_rel']:.3e} of max|logit| (tol "
        f"{DENSE_REL:.0e}), top-1 agreement {res['agree']:.4f}")
    if not res["decode_vs_forward_rel"] <= DENSE_REL:
        raise RuntimeError("gemma: ring decode logits disagree with the windowed lm.forward")
    # a history inside the window: rings (window slots of 2 x window) vs
    # full caches (no window: 2 x window slots) vs lm.forward
    h = min(GEMMA["hist"], window)
    full_cfg = dataclasses.replace(cfg, unit=tuple(
        dataclasses.replace(b, attn=dataclasses.replace(b.attn, window=None)) for b in cfg.unit))
    t = torch.as_tensor(rs.randint(0, cfg.vocab, (1, h)).astype(np.int64), device=device)
    ring = teacher_forced(torch, params, cfg, t, 2 * window)
    full = teacher_forced(torch, params, full_cfg, t, 2 * window)
    fwd, _ = lm.forward(params, cfg, t)
    res["ring_vs_full_rel"], res["ring_vs_forward_rel"] = rel_err(ring, full), rel_err(ring, fwd)
    log(f"[gemma] {h} tokens inside the window, decoded from 0: rings vs full caches max err "
        f"{res['ring_vs_full_rel']:.3e}, rings vs lm.forward {res['ring_vs_forward_rel']:.3e} "
        f"of max|logit| (tol {DENSE_REL:.0e})")
    if not max(res["ring_vs_full_rel"], res["ring_vs_forward_rel"]) <= DENSE_REL:
        raise RuntimeError("gemma: ring decode disagrees with a full cache")
    return res


# Phase 11: the MoE models of ROADMAP item 8.  Routing makes a token's
# result depend on its companions: ``cap`` grows with the rows routed
# together, and the queue positions run over them in order, so a token
# dropped in one batch is kept in another.  So every run serves at the
# published capacity factor (1.25) and is held to a recomputation that
# routes the same rows together (the static buckets, teacher-forced) or,
# where the scheduler forms other groups (a prefix hit's suffix prefill, a
# preempted request's re-prefill, a verify window's B·W rows), its
# divergences from the dense run are counted and printed.  A second set of
# runs at ``capacity_factor = E / top_k`` (``cap >= S``: no token drops and
# no token sees its companions) holds the paged (shadow, step, the tight
# pool) and speculative paths to the dense one, every stream to
# ``lm.forward``, and a sampled run token by token to the perturbed scores
# of its recomputed logits, at near-ties only.
MOE_CELL = {"static_batch": 4, "static_new": 32, "static_requests": 8,
            "ds_static_requests": 4, "ds_requests": 8, "ds_slots": 4}
OLMOE_RUNS = CONT_RUNS + [("spec_dense", {"spec_k": SPEC_K, "draft_layers": 1}),
                          ("spec_paged_shadow", {"spec_k": SPEC_K, "draft_layers": 1,
                                                 "paged": True})]
OLMOE_NODROP_RUNS = [("nodrop_dense", {}), ("nodrop_paged_shadow", {"paged": True}),
                     ("nodrop_paged_step", {"paged": True, "paged_read": "step"}),
                     ("nodrop_paged_preempt", {"paged": True, "pool_blocks": 25}),
                     ("nodrop_spec_dense", {"spec_k": SPEC_K, "draft_layers": 1}),
                     ("nodrop_spec_paged_shadow", {"spec_k": SPEC_K, "draft_layers": 1,
                                                   "paged": True})]

# the hot sampled run: the first T whose expected share of tokens off the
# argmax (request 0's greedy logits) reaches OLMOE_HOT_SHARE
OLMOE_HOT_TS = (500.0, 1000.0, 2000.0, 4000.0, 8000.0, 16000.0)
OLMOE_HOT_SHARE = 0.75


def no_drop(cfg):
    """``cfg`` with every MoE block at ``capacity_factor = E / top_k``."""
    import dataclasses

    def fix(b):
        if b.moe is None:
            return b
        m = b.moe
        return dataclasses.replace(b, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))

    return dataclasses.replace(cfg, prologue=tuple(map(fix, cfg.prologue)),
                               unit=tuple(map(fix, cfg.unit)))


class DropMeter:
    """Counts the routed choices and the dropped ones of every
    ``moe_forward`` call while active (device scalars, summed once at the
    end: no host sync per call).  On a mesh a call's drop fraction is the
    global batch's, so its choices are counted over the global rows
    (``ShardingCtx.global_rows``)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.real, self.calls = moe, moe.moe_forward, []

    def __enter__(self):
        def metered(params, cfg, x, shard=None):
            y, aux = self.real(params, cfg, x, shard)
            rows = x.shape[0] * x.shape[1]
            rows = rows if shard is None else shard.global_rows(rows)
            self.calls.append((rows * cfg.top_k, aux["moe_drop_frac"]))
            return y, aux

        self.calls = []
        self.moe.moe_forward = metered
        return self

    def __exit__(self, *exc):
        self.moe.moe_forward = self.real

    def summary(self) -> dict:
        routed = sum(n for n, _ in self.calls)
        dropped = [round(float(f) * n) for n, f in self.calls]
        return {"calls": len(self.calls), "routed_choices": routed,
                "dropped_choices": sum(dropped), "calls_with_drops": sum(d > 0 for d in dropped),
                "moe_drop_frac": sum(dropped) / max(1, routed)}


def bucket_recompute(torch, np, params, cfg, reqs, outs, batch, max_seq):
    """The static engine's streams recomputed outside the engine: each
    bucket of ``serve_requests`` (length-sorted, right-padded with zeros,
    short buckets padded with copies of their last row) prefilled and
    decoded step by step on the served tokens, per-row positions.  Returns
    the logits that predict each served token, ``{request: (new, vocab)}``."""
    from repro_torch.models import lm

    order = sorted(range(len(reqs)), key=lambda i: reqs[i].shape[0])
    dev = params["embed"]["table"].device
    got = {}
    for start in range(0, len(order), batch):
        idxs = order[start:start + batch]
        T = max(reqs[i].shape[0] for i in idxs)
        rows = idxs + [idxs[-1]] * (batch - len(idxs))
        toks = torch.as_tensor(np.stack([np.pad(reqs[i], (0, T - len(reqs[i])))
                                         for i in rows]).astype(np.int64), device=dev)
        lens = torch.as_tensor([len(reqs[i]) for i in rows], device=dev)
        logits, caches = lm.prefill(params, cfg, toks, max_seq)
        steps = [logits[torch.arange(len(rows), device=dev), lens - 1]]
        del logits
        pos = lens if bool((lens < T).any()) else torch.tensor(T, device=dev)
        served = torch.as_tensor(np.stack([outs[i] for i in rows]).astype(np.int64),
                                 device=dev)
        for j in range(served.shape[1] - 1):
            lg, caches = lm.decode_step(params, cfg, served[:, j:j + 1], caches, pos)
            steps.append(lg)
            pos = pos + 1
        lg = torch.stack(steps, 1)
        for r, i in enumerate(idxs):
            got[i] = lg[r]
        del caches
    return got


def held_to_logits(torch, np, tag, outs, logits_of, group="moe"):
    """Each stream ``outs[i]`` equal to the argmax of ``logits_of[i]``
    (``(len, vocab)``) unless the first divergence is a near-tie (a top-2
    gap below ``DENSE_TIE`` of max|logit|); returns the divergences."""
    divs = []
    for i, o in enumerate(outs):
        lg = logits_of[i]
        want = lg.argmax(-1).cpu().numpy()
        diff = np.nonzero(o != want)[0]
        if not diff.size:
            continue
        j = int(diff[0])
        top = torch.topk(lg[j], 2).values
        g = ((top[0] - top[1]) / lg.abs().amax()).item()
        divs.append({"run": tag, "request": i, "step": j, "top2_gap_rel": g})
        log(f"[{group}] {tag}: request {i} parts from its recomputation at step {j}; top-2 gap "
            f"{g:.3e} of max|logit| (tol {DENSE_TIE:.0e})")
        if g >= DENSE_TIE:
            raise RuntimeError(f"{tag}: request {i} diverges at step {j}, not a near-tie")
    return divs


def forward_logits(torch, np, params, cfg, reqs, outs, device):
    """``lm.forward`` of each prompt and its stream: the logits that
    predict each token of the stream (``cfg`` must not drop: then a row's
    routing does not depend on its companions)."""
    from repro_torch.models import lm

    got = []
    for r, o in zip(reqs, outs):
        seq = np.concatenate([r, o[:-1]]).astype(np.int64)
        lg, _ = lm.forward(params, cfg, torch.as_tensor(seq[None], device=device))
        got.append(lg[0, len(r) - 1:])
    return got


def static_cell(torch, np, params, cfg, reqs, new, batch, tag, device, group):
    """The static cell of a model: ``serve_requests`` counted and timed
    (MoE drops metered), every output in range, the streams held to
    :func:`bucket_recompute` (the same buckets, padded the same way), then
    a warm repeat.  Returns ``(metrics, engine, outputs)``."""
    from repro_torch.serve.engine import Engine, ServeConfig

    cuda = device == "cuda"
    lens = np.array([len(r) for r in reqs])
    max_seq = int(lens.max()) + new + 8
    eng = Engine(params, cfg, ServeConfig(max_seq=max_seq, max_new_tokens=new), device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with DropMeter() as meter:
        outs, m = counted(torch, f"{tag} static", lambda: eng.serve_requests(
            reqs, batch_size=batch, seed=0), {}, device, tag=group)
    wall = m["wall_ms"] / 1e3
    for o in outs:
        if o.shape != (new,) or o.min() < 0 or o.max() >= cfg.vocab:
            raise RuntimeError(f"{tag} static: bad output {o}")
    bk = eng.last_serve_stats["buckets"]
    a = {"tok_s": len(reqs) * new / wall, "wall_s": wall, "launches": m["launches"],
         "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None,
         "prefill_ms": sum(b["prefill_s"] for b in bk) * 1e3 / len(bk),
         "decode_ms_per_step": sum(b["decode_s"] for b in bk) * 1e3
         / sum(b["decode_steps"] for b in bk), **(meter.summary() if meter.calls else {})}
    rec = bucket_recompute(torch, np, params, cfg, reqs, outs, batch, max_seq)
    a["divergences"] = held_to_logits(torch, np, f"{tag} static vs its buckets recomputed",
                                      outs, rec, group=group)
    del rec
    if cuda:
        t0 = time.perf_counter()
        eng.serve_requests(reqs, batch_size=batch, seed=0)
        torch.cuda.synchronize()
        a["warm_tok_s"] = len(reqs) * new / (time.perf_counter() - t0)
        wb = eng.last_serve_stats["buckets"]
        a["warm_decode_ms_per_step"] = (sum(b["decode_s"] for b in wb) * 1e3
                                        / sum(b["decode_steps"] for b in wb))
    drops = (f"; moe_drop_frac {a['moe_drop_frac']:.4f} ({a['dropped_choices']} of "
             f"{a['routed_choices']} choices, {a['calls_with_drops']} of {a['calls']} moe "
             "calls)" if meter.calls else "")
    log(f"[{group}] {tag} static: {len(reqs) * new} tokens in {wall:.3f} s: {a['tok_s']:.2f} "
        f"tok/s cold, {a.get('warm_tok_s')} warm; prefill_ms (mean per bucket) "
        f"{a['prefill_ms']:.1f}; decode_ms_per_step {a['decode_ms_per_step']:.3f} cold, "
        f"{a.get('warm_decode_ms_per_step')} warm; {len(a['divergences'])} near-tie partings "
        f"from the buckets recomputed step by step{drops}; peak_mem_GB="
        f"{(a['peak_mem_bytes'] or 0) / 1e9:.3f}")
    return a, eng, outs


def moe_static(torch, np, params, cfg, reqs, new, batch, tag, device):
    """The static cell of a MoE model (:func:`static_cell`) at the
    published capacity; then the first bucket's rows teacher-forced through
    decode steps against ``lm.forward``, both at the no-drop capacity."""
    from repro_torch.models import lm

    t_start = time.perf_counter()
    a, eng, outs = static_cell(torch, np, params, cfg, reqs, new, batch, tag, device, "moe")
    lens = np.array([len(r) for r in reqs])
    max_seq = int(lens.max()) + new + 8
    nd = no_drop(cfg)
    errs = []
    for i in sorted(range(len(reqs)), key=lambda i: lens[i])[:batch]:
        t = torch.as_tensor(np.concatenate([reqs[i], outs[i]]).astype(np.int64)[None],
                            device=device)
        dec = teacher_forced(torch, params, nd, t, max_seq, start=int(lens[i]))
        fwd, _ = lm.forward(params, nd, t)
        errs.append(rel_err(dec, fwd[:, int(lens[i]) - 1:-1]))
        del dec, fwd
    a["decode_vs_forward_rel"] = max(errs)
    log(f"[moe] {tag} static: teacher-forced decode vs lm.forward at capacity_factor E/top_k "
        f"(no drop), {batch} requests x {new} tokens: max err "
        f"{a['decode_vs_forward_rel']:.3e} of max|logit| (tol {DENSE_REL:.0e}) "
        f"(at {time.perf_counter() - t_start:.1f} s)")
    if not a["decode_vs_forward_rel"] <= DENSE_REL:
        raise RuntimeError(f"{tag}: decode logits disagree with lm.forward")
    return a, eng


def moe_continuous(torch, np, params, cfg, reqs, budgets, runs_spec, tag, device, slots,
                   hold_gathers=False):
    """The continuous cell's runs ``runs_spec`` [(name, ServeConfig
    overrides)], each a :func:`continuous_run` (counted exactly, drops
    metered, prefix hits and preemptions checked; with ``hold_gathers``
    every gather held bit for bit).  Returns ``(metrics, streams, engines)``
    by run name."""
    from repro_torch.serve.engine import ServeConfig

    base = ServeConfig(max_seq=CONT["max_seq"], max_new_tokens=max(budgets),
                       block_size=CONT["block_size"])
    runs, streams, engines = {}, {}, {}
    for name, extra in runs_spec:
        engines[name], streams[name], runs[name] = continuous_run(
            torch, np, params, cfg, base, extra, (reqs, budgets, slots), f"{tag} {name}",
            device, "moe", hold_gathers=hold_gathers)
    return runs, streams, engines


def hot_temperature(torch, logits) -> tuple[float, float]:
    """The first of ``OLMOE_HOT_TS`` at which the greedy tokens' expected
    share off the argmax, ``1 - max softmax(logits / T)`` averaged over the
    rows of ``logits (n, vocab)``, reaches ``OLMOE_HOT_SHARE`` (else the
    last); returns ``(T, that share)``."""
    for t in OLMOE_HOT_TS:
        expect = (1 - torch.softmax(logits / t, -1).amax(-1)).mean().item()
        if expect >= OLMOE_HOT_SHARE:
            break
    return t, expect


def held_sampled(torch, np, tag, params, cfg, reqs, outs, seed, temperature, device,
                 group="moe"):
    """Each sampled stream (request ``i`` of ``serve_continuous(seed=seed)``)
    equal to the tokens its perturbed scores draw (:func:`sampled_gaps`),
    unless the first divergence is a near-tie: a perturbed top-2 gap below
    ``DENSE_TIE`` of max|logit| over T (``cfg`` must not drop).  Returns the
    divergences and the share of tokens off the argmax of their own logits."""
    divs, off, n = [], 0, 0
    for i, (r, o) in enumerate(zip(reqs, outs)):
        gaps, offs, drawn, lmax = sampled_gaps(torch, np, params, cfg, r, o, i, seed,
                                               temperature, device)
        off, n = off + int(offs.sum()), n + len(o)
        diff = np.nonzero(o != drawn)[0]
        if not diff.size:
            continue
        j = int(diff[0])
        g, tol = float(gaps[j]), DENSE_TIE * lmax / temperature
        divs.append({"run": tag, "request": i, "step": j, "gap": g, "tol": tol})
        log(f"[{group}] {tag}: request {i} parts from its recomputation at step {j}; perturbed "
            f"top-2 gap {g:.3e} (near-tie below {tol:.1e})")
        if g >= tol:
            raise RuntimeError(f"{tag}: request {i} diverges at step {j}, not a near-tie")
    return divs, off / n


def parted_from(np, tag, outs, ref) -> list[dict]:
    """Where each stream first parts from ``ref`` (counted, not failed)."""
    divs = []
    for i, (o, r) in enumerate(zip(outs, ref)):
        diff = np.nonzero(o != r)[0]
        if diff.size:
            divs.append({"run": tag, "request": i, "step": int(diff[0])})
    log(f"[moe] {tag}: {len(divs)} of {len(outs)} streams part from the dense run's "
        f"{[(d['request'], d['step']) for d in divs]}")
    return divs


# olmoe-1b-7b's depth in phase 11: 4 of its 16 layers at full width.  With
# phase 17 (mesh serving) added and olmoe at full depth the whole script
# took ~1118 s of its 1200 on an H100 80GB HBM3 at 700 W, phase 11 220.9 s
# of it, so it was cut to 8 layers; with olmoe's mesh cells added to phases
# 17 and 18 (+86 s on that card: 86.5 and 107.2 s against 49-56 each) the
# 8-layer script would end near 1177 s, so it is cut to 4.  The cut keeps
# every check and exact launch count of the cells; the 8-layer figures are
# in PERF.md.
OLMOE_REPEATS = 4


def olmoe_path(torch, np, device="cuda", cfg=None):
    """Phase 11 (a), any miss raises: olmoe-1b-7b at full width and
    ``OLMOE_REPEATS`` of its 16 layers (random weights from seed 0, fp32)
    served statically, continuously
    (dense, paged shadow, paged step, the 25-block pool), speculatively
    (1-layer drafter, dense and paged shadow) and sampled at ``SAMPLE_T``,
    each run counted exactly; the no-drop runs hold the paged (shadow, step,
    the tight pool) and speculative streams to the dense ones, every stream
    to ``lm.forward``, and a run sampled at a hot T (:func:`hot_temperature`)
    to its recomputed draws, with at least ``MIN_SAMPLED_SHARE`` of its
    tokens off the argmax.
    ``device="cpu"`` with a reduced ``cfg`` rehearses it."""
    from repro_torch.configs import olmoe_1b_7b
    from repro_torch.convert import flatten_with_paths
    from repro_torch.models import lm

    cuda = device == "cuda"
    t_start = time.perf_counter()
    cfg = cfg or olmoe_1b_7b.build(n_layers=OLMOE_REPEATS).model
    moe = cfg.unit[0].moe
    params = lm.init_params(cfg, seed=0, device=device, dtype=torch.float32)
    out = {"params": sum(t.numel() for t in flatten_with_paths(params).values()),
           "init_s": time.perf_counter() - t_start}
    log(f"[moe] olmoe-1b-7b full width, {cfg.n_layers} of 16 layers: d={cfg.d_model} "
        f"heads={cfg.unit[0].attn.n_heads}/{cfg.unit[0].attn.n_kv_heads} experts="
        f"{moe.n_experts} top-{moe.top_k} d_ff={moe.d_ff} capacity_factor "
        f"{moe.capacity_factor} vocab={cfg.vocab} params={out['params'] / 1e9:.3f}B fp32, "
        f"made in {out['init_s']:.1f} s")
    rs = np.random.RandomState(0)
    n, batch, new = MOE_CELL["static_requests"], MOE_CELL["static_batch"], MOE_CELL["static_new"]
    lens = rs.randint(32, 129, n)
    reqs = [rs.randint(0, cfg.vocab, L).astype(np.int32) for L in lens]
    out["static"], eng = moe_static(torch, np, params, cfg, reqs, new, batch, "olmoe", device)
    if cuda:                   # one warm bucket under the profiler
        order = sorted(range(n), key=lambda i: lens[i])[:batch]
        T = int(max(lens[i] for i in order))
        prompts = np.stack([np.pad(reqs[i], (0, T - lens[i])) for i in order]).astype(np.int32)
        out["static"]["profile"] = profile_generate(torch, eng, prompts,
                                                    lens[order].astype(np.int32))
    del eng
    log(f"[moe] olmoe static done (at {time.perf_counter() - t_start:.1f} s)")

    creqs, budgets = continuous_requests(np, cfg.vocab)
    runs, streams, engines = moe_continuous(torch, np, params, cfg, creqs, budgets, OLMOE_RUNS,
                                            "olmoe", device, CONT["slots"], hold_gathers=True)
    dense = streams["dense"]
    parted = []
    for name in runs:
        if name == "dense":
            continue
        parted += parted_from(np, f"olmoe {name} vs dense", streams[name], dense)
    # sampled at phase 6c's T: olmoe's top-2 lead beats the noise there, so
    # this run's streams are the greedy ones (printed, not held); the hot
    # run below is the one that checks sampling
    s_runs, s_streams, _ = moe_continuous(torch, np, params, cfg, creqs, budgets,
                                          [("sampled", {"temperature": SAMPLE_T})], "olmoe",
                                          device, CONT["slots"])
    toks = sum(len(o) for o in dense)
    off = sum(int((a != b).sum()) for a, b in zip(s_streams["sampled"], dense)) / toks
    # how far the noise (a Gumbel max over the vocabulary, ~ln(vocab)) is
    # from the greedy token's lead over the runner-up, in units of T
    lg, _ = lm.forward(params, cfg, torch.as_tensor(
        np.concatenate([creqs[0], dense[0]]).astype(np.int64)[None], device=device))
    lg = lg[0, len(creqs[0]) - 1:-1]
    top = torch.topk(lg, 2, dim=-1).values
    lead = ((top[:, 0] - top[:, 1]) / SAMPLE_T).median().item()
    hot_t, expect = hot_temperature(torch, lg)
    del lg
    s_runs["sampled"].update(share_off_greedy=off, median_lead_over_T=lead)
    log(f"[moe] olmoe sampled at T={SAMPLE_T}: {off:.3f} of the tokens differ from the greedy "
        f"dense run's; request 0's median top-2 logit gap over T {lead:.2f} against a Gumbel "
        f"max of ~ln(vocab) = {math.log(cfg.vocab):.2f}; the hot run takes T={hot_t} "
        f"(expected share off the argmax {expect:.3f})")
    runs["sampled"] = s_runs["sampled"]
    log(f"[moe] olmoe continuous done (at {time.perf_counter() - t_start:.1f} s)")

    # no drop: paged and speculative held to dense, every stream to lm.forward
    nd = no_drop(cfg)
    nd_runs, nd_streams, _ = moe_continuous(torch, np, params, nd, creqs, budgets,
                                            OLMOE_NODROP_RUNS, "olmoe", device, CONT["slots"],
                                            hold_gathers=True)
    for name, r in nd_runs.items():
        if r["dropped_choices"]:
            raise RuntimeError(f"olmoe {name}: {r['dropped_choices']} choices dropped at "
                               "capacity_factor E/top_k")
    ref = forward_logits(torch, np, params, nd, creqs, nd_streams["nodrop_dense"], device)
    held = held_to_logits(torch, np, "olmoe nodrop_dense vs lm.forward",
                          nd_streams["nodrop_dense"], ref)
    del ref
    gaps = {}
    for name in nd_runs:
        if name != "nodrop_dense":
            held += held_streams(torch, np, f"olmoe {name}", nd_streams[name],
                                 nd_streams["nodrop_dense"], params, nd, creqs, device, gaps)
    # the hot sampled run, no drop: each token held to its recomputation
    h_runs, h_streams, _ = moe_continuous(torch, np, params, nd, creqs, budgets,
                                          [("nodrop_sampled_hot", {"temperature": hot_t})],
                                          "olmoe", device, CONT["slots"])
    s_divs, share = held_sampled(torch, np, "olmoe nodrop_sampled_hot", params, nd, creqs,
                                 h_streams["nodrop_sampled_hot"], 0, hot_t, device)
    h_runs["nodrop_sampled_hot"].update(temperature=hot_t, share_off_argmax=share,
                                        expected_share_off_argmax=expect,
                                        near_tie_divergences=len(s_divs))
    runs.update(nd_runs)
    runs.update(h_runs)
    out.update({"runs": runs, "parted_from_dense": parted, "nodrop_divergences": held,
                "sampled_divergences": s_divs})
    log(f"[moe] olmoe no-drop runs: {len(held)} near-tie divergences; sampled at T={hot_t}: "
        f"{share:.4f} of the tokens off the argmax of their own logits (floor "
        f"{MIN_SAMPLED_SHARE}), {len(s_divs)} near-tie partings from the recomputation (at "
        f"{time.perf_counter() - t_start:.1f} s)")
    if share < MIN_SAMPLED_SHARE:
        raise RuntimeError(f"olmoe: only {share:.4f} of the hot sampled tokens are off the argmax")

    if cuda:      # one warm wave of the paged shadow run, profiled
        wave, st_ = creqs[:PROFILE_WAVE["requests"]], []
        eng = engines["paged_shadow"]

        def serve_wave():
            eng.serve_continuous(wave, slots=CONT["slots"], chunk_steps=CONT["chunk_steps"],
                                 max_new=PROFILE_WAVE["tokens"])
            st_.append(eng.last_serve_stats)

        prof = profile_call(torch, serve_wave, lambda: (
            f"one warm olmoe paged_shadow run of the cell's first {len(wave)} requests, "
            f"{PROFILE_WAVE['tokens']} tokens each"))
        steps = st_[0]["chunks_run"] * CONT["chunk_steps"]
        prof.update({"warm_tok_s": st_[0]["useful_tokens"] / (prof["wall_ms"] / 1e3),
                     "warm_decode_ms_per_step": st_[0]["decode_s"] * 1e3 / steps,
                     "warm_prefill_ms": st_[0]["prefill_s"] * 1e3, "decode_steps": steps})
        log(f"[moe] olmoe paged_shadow warm wave: {prof['warm_tok_s']:.2f} tok/s, "
            f"{prof['warm_decode_ms_per_step']:.3f} ms per decode step, admission prefill "
            f"{prof['warm_prefill_ms']:.1f} ms (unprofiled), busy share {prof['busy_share']}")
        out["profile_cont"] = prof
    del engines, params
    return out


# deepseek-v2-lite's depth in phase 11 (b): its dense prologue and 8 of its
# 26 MoE layers at full width (4.97 B parameters, 19.9 GB of fp32).  The
# script without deepseek's mesh cells took 1132 s of its 1200 on an H100
# 80GB HBM3 at 700 W; with them, phase 11 (b) at full depth (28.9 s there,
# 10.5 s cut) is the first depth to cut.  The cut keeps every check and
# exact launch count of the cells, and the full-depth figures are in PERF.md.
DEEPSEEK_REPEATS = 8


def deepseek_path(torch, np, device="cuda", cfg=None):
    """Phase 11 (b), any miss raises: deepseek-v2-lite at full width, its
    prologue and ``DEEPSEEK_REPEATS`` of its 26 MoE layers (random weights
    from seed 0, fp32; MLA, a dense prologue, 2
    shared + 64 routed experts): the static cell of 4 prompts and the dense
    continuous cell (8 requests, 4 slots), each counted, at the published
    capacity; the continuous cell again at no drop, held to ``lm.forward``;
    the latent cache's bytes beside the GQA cache it replaces."""
    import dataclasses

    from repro_torch.configs import deepseek_v2_lite
    from repro_torch.convert import flatten_with_paths
    from repro_torch.models import lm

    cuda = device == "cuda"
    t_start = time.perf_counter()
    cfg = cfg or deepseek_v2_lite.build(n_layers=DEEPSEEK_REPEATS + 1).model
    a, moe = cfg.unit[0].attn, cfg.unit[0].moe
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0, device=device, dtype=torch.float32)
    out = {"params": sum(t.numel() for t in flatten_with_paths(params).values()),
           "params_peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None}
    log(f"[moe] deepseek-v2-lite full width: d={cfg.d_model} layers={cfg.n_layers} of 27 "
        f"(1 dense prologue, d_ff {cfg.prologue[0].d_ff}) MLA kv_lora {a.kv_lora_rank} rope "
        f"{a.qk_rope_dim} heads {a.n_heads} x {a.head_dim}; experts {moe.n_experts} routed "
        f"top-{moe.top_k} + {moe.n_shared} shared, d_ff {moe.d_ff}; vocab {cfg.vocab}; "
        f"params={out['params'] / 1e9:.3f}B fp32, peak {(out['params_peak_mem_bytes'] or 0) / 1e9:.2f}"
        f" GB after init")
    rs = np.random.RandomState(0)
    n, new = MOE_CELL["ds_static_requests"], MOE_CELL["static_new"]
    reqs = [rs.randint(0, cfg.vocab, L).astype(np.int32) for L in rs.randint(32, 129, n)]
    out["static"], eng = moe_static(torch, np, params, cfg, reqs, new, n, "deepseek", device)
    del eng
    creqs, budgets = continuous_requests(np, cfg.vocab)
    creqs, budgets = creqs[:MOE_CELL["ds_requests"]], budgets[:MOE_CELL["ds_requests"]]
    runs, streams, _ = moe_continuous(torch, np, params, cfg, creqs, budgets, [("dense", {})],
                                      "deepseek", device, MOE_CELL["ds_slots"])
    nd = no_drop(cfg)
    nd_runs, nd_streams, _ = moe_continuous(torch, np, params, nd, creqs, budgets,
                                            [("nodrop_dense", {})], "deepseek", device,
                                            MOE_CELL["ds_slots"])
    if nd_runs["nodrop_dense"]["dropped_choices"]:
        raise RuntimeError("deepseek: choices dropped at capacity_factor E/top_k")
    ref = forward_logits(torch, np, params, nd, creqs, nd_streams["nodrop_dense"], device)
    held = held_to_logits(torch, np, "deepseek nodrop_dense vs lm.forward",
                          nd_streams["nodrop_dense"], ref)
    del ref
    parted = parted_from(np, "deepseek dense vs nodrop_dense", streams["dense"],
                         nd_streams["nodrop_dense"])
    runs.update(nd_runs)
    gqa = dataclasses.replace(cfg, prologue=(), n_repeats=cfg.n_layers, unit=tuple(
        dataclasses.replace(b, attn=dataclasses.replace(b.attn, kv_lora_rank=None))
        for b in cfg.unit))
    slots = MOE_CELL["ds_slots"]
    cache = {name: tree_bytes(lm.init_caches(m, slots, CONT["max_seq"], torch.float32, "meta"))
             for name, m in (("mla", cfg), ("gqa", gqa))}
    log(f"[moe] deepseek KV cache of the continuous cell ({slots} slots x "
        f"{CONT['max_seq']}): MLA latent {cache['mla']} bytes ({a.kv_lora_rank + a.qk_rope_dim} "
        f"floats per token and layer) against {cache['gqa']} for GQA K/V of the same heads "
        f"({2 * a.n_heads * a.head_dim}): {cache['gqa'] / cache['mla']:.2f}x smaller")
    out.update({"runs": runs, "held_divergences": held, "parted_from_nodrop": parted,
                "cache_bytes": cache,
                "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None})
    log(f"[moe] deepseek done (at {time.perf_counter() - t_start:.1f} s); peak_mem_GB="
        f"{(out['peak_mem_bytes'] or 0) / 1e9:.3f}")
    del params
    return out


# Phase 12: the recurrent models of ROADMAP item 8: zamba2-1.2b (Mamba2
# SSD and one shared attention block) and xlstm-1.3b (mLSTM and sLSTM).
# Their decode state is per request and not pad-invariant: a right-padded
# prompt feeds its pads through the recurrence, as in the reference's
# engine.  So a padded run is held to a recomputation that pads the same
# way (the static buckets, step by step) or to a repeat of itself (the
# ragged continuous cell), and the checks against ``lm.forward`` and solo
# ``generate`` take prompts that nothing pads.  Paging and speculative
# windows are refused, as the reference refuses them.
RECUR = {"new": 32, "batch": 4, "tf_requests": 4, "tf_len": 128, "unpadded_len": 64,
         "long_rows": 2, "long_prefill": 896, "long_len": 1024, "chunked_rows": 2,
         "chunked_len": 256}
# xlstm-1.3b's depth here: 2 of its 6 units of 7 mLSTM + 1 sLSTM blocks (16
# of 48 layers) at full width.  With phase 13 and xlstm at full depth the
# whole script took 1067 s of its 1200 on an H100 80GB HBM3 at 700 W, 127 s
# of it xlstm's; the cut keeps every check of the cell.
XLSTM_REPEATS = 2
# Tolerances, relative to max|logit| of the logits compared.  zamba2's
# decode is the recurrence (exp(dt A) per step) where lm.forward is the SSD
# form (exp of differences of in-chunk cumulative sums, which reach a few
# hundred: one fp32 ulp there is ~3e-5 of a decay), so the two part by up to
# ~1e-5 of a Mamba2 layer's output, and a layer's output is a small part of
# the residual stream that max|logit| measures.  xlstm's decode and its
# recurrent forward are the same recurrence in another order; its chunked
# mLSTM sums each chunk as a masked quadratic form over exp() of log-gate
# sums.  Rehearsed on the CPU at the reduced widths (PERF.md §6):
# 3.7e-7 (zamba2, 1024 tokens) and 1.9e-7 (xlstm, chunked); the full
# widths sum over 32x longer head dims and 8-14x more layers.
SSM_REL = 1e-4
XLSTM_REL = 1e-4


def ssd_forward(torch, params, cfg, t):
    """``lm.forward`` logits of ``t (B, T)``.  A Mamba2 model's SSD scan
    takes ``T`` up to its chunk or a multiple of it, so there ``t`` is
    right-padded with zeros to the next multiple (causal: the first ``T``
    positions do not see the pad)."""
    from repro_torch.models import lm

    chunk = min((b.mamba.chunk for b in cfg.prologue + cfg.unit + cfg.epilogue
                 if b.kind == "mamba2"), default=None)
    T = t.shape[1]
    if chunk and T > chunk and T % chunk:
        t = torch.nn.functional.pad(t, (0, chunk - T % chunk))
    logits, _ = lm.forward(params, cfg, t)
    return logits[:, :T]


def state_bytes(torch, cfg) -> tuple[int, int]:
    """``(per-request state bytes, KV bytes per token)`` of ``cfg``'s
    decode caches, fp32: what one row holds at any length, and what each
    token adds (zamba2's shared-attention K/V)."""
    from repro_torch.models import lm

    one, two = (tree_bytes(lm.init_caches(cfg, 1, s, torch.float32, "meta")) for s in (1, 2))
    return 2 * one - two, two - one


def recurrent_path(torch, np, tag, cfg, device, rel, extra_check):
    """Phase 12 for one recurrent model (random weights from seed 0, fp32),
    any miss raises: phase 4's requests served statically and held to
    their buckets recomputed step by step; 4 unpadded prompts of
    ``tf_len`` served statically, their teacher-forced decode within
    ``rel`` of ``lm.forward`` and their streams equal to its argmax up to
    near-ties; ``extra_check(params)`` (the model's own long-sequence
    check); phase 6's continuous cell dense twice (equal streams), the same
    cell unpadded (each stream equal to its solo ``generate`` up to
    near-ties) and sampled at ``SAMPLE_T`` (each token equal to the draw of
    its recomputed perturbed scores up to near-ties); paged and speculative
    serving refused; one warm decode step of the cell's 8 slots profiled."""
    from repro_torch.convert import flatten_with_paths
    from repro_torch.models import lm
    from repro_torch.serve import speculative
    from repro_torch.serve.engine import Engine, ServeConfig

    cuda = device == "cuda"
    t_start = time.perf_counter()

    def stamp() -> str:
        return f"(at {time.perf_counter() - t_start:.1f} s)"

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0, device=device, dtype=torch.float32)
    state, kv_tok = state_bytes(torch, cfg)
    out = {"params": sum(t.numel() for t in flatten_with_paths(params).values()),
           "state_bytes_per_request": state, "kv_bytes_per_token": kv_tok}
    kinds = sorted({b.kind for b in cfg.prologue + cfg.unit + cfg.epilogue + cfg.shared})
    log(f"[recur] {tag} full width: d={cfg.d_model} layers={cfg.n_layers} "
        f"kinds {kinds} shared {len(cfg.shared)} vocab={cfg.vocab} params="
        f"{out['params'] / 1e9:.3f}B fp32; per-request state {state} bytes "
        f"({state / 1e6:.1f} MB), KV {kv_tok} bytes per token {stamp()}")
    new, batch = RECUR["new"], RECUR["batch"]

    # (a) phase 4's requests, statically, held to their buckets recomputed
    rs = np.random.RandomState(0)
    reqs = [rs.randint(0, cfg.vocab, L).astype(np.int32) for L in rs.randint(32, 129, 8)]
    out["static"], eng, _ = static_cell(torch, np, params, cfg, reqs, new, batch, tag,
                                        device, "recur")
    del eng

    # (b) unpadded prompts: decode held to lm.forward, streams to its argmax
    rs = np.random.RandomState(5)
    n, T0 = RECUR["tf_requests"], RECUR["tf_len"]
    ureqs = [rs.randint(0, cfg.vocab, T0).astype(np.int32) for _ in range(n)]
    eng = Engine(params, cfg, ServeConfig(max_seq=T0 + new, max_new_tokens=new), device=device)
    uouts, m = counted(torch, f"{tag} static unpadded", lambda: eng.serve_requests(
        ureqs, batch_size=n, seed=0), {}, device, tag="recur")
    del eng
    t = torch.as_tensor(np.stack([np.concatenate([r, o]) for r, o in zip(ureqs, uouts)])
                        .astype(np.int64), device=device)
    dec = teacher_forced(torch, params, cfg, t, T0 + new, start=T0)
    fwd = ssd_forward(torch, params, cfg, t[:, :-1])[:, T0 - 1:]
    b = {"launches": m["launches"], "tok_s": n * new / (m["wall_ms"] / 1e3),
         "decode_vs_forward_rel": rel_err(dec, fwd),
         "divergences": held_to_logits(torch, np, f"{tag} unpadded streams vs lm.forward",
                                       uouts, fwd, group="recur")}
    del dec, fwd
    log(f"[recur] {tag} static unpadded ({n} x {T0} tokens, {new} new): teacher-forced decode "
        f"vs lm.forward max err {b['decode_vs_forward_rel']:.3e} of max|logit| (tol {rel:.0e}); "
        f"{len(b['divergences'])} near-tie partings of the streams from its argmax {stamp()}")
    if not b["decode_vs_forward_rel"] <= rel:
        raise RuntimeError(f"{tag}: decode logits disagree with lm.forward")
    out["static_unpadded"] = b
    out.update(extra_check(params))
    log(f"[recur] {tag} long check done {stamp()}")

    # (c) phase 6's continuous cell, dense, twice: repeatable
    creqs, budgets = continuous_requests(np, cfg.vocab)
    base = ServeConfig(max_seq=CONT["max_seq"], max_new_tokens=max(budgets))
    runs, streams = {}, {}
    for name in ("dense", "dense_again"):
        _, streams[name], runs[name] = continuous_run(
            torch, np, params, cfg, base, {}, (creqs, budgets, CONT["slots"]),
            f"{tag} {name}", device, "recur", stamp=stamp)
    held_streams(torch, np, f"{tag} dense_again vs dense", streams["dense_again"],
                 streams["dense"], params, cfg, creqs, device, {}, exact=True, group="recur")
    # (d) the same cell with every prompt L tokens (L a multiple of the pad
    # multiple, so nothing pads): each stream equal to its solo generate
    L = RECUR["unpadded_len"]
    ureqs = [np.resize(r, L) for r in creqs]
    eng, streams["unpadded"], runs["unpadded"] = continuous_run(
        torch, np, params, cfg, base, {}, (ureqs, budgets, CONT["slots"]), f"{tag} unpadded",
        device, "recur", stamp=stamp)
    solo = [eng.generate(r[None], max_new=bud)[0] for r, bud in zip(ureqs, budgets)]
    out["unpadded_divergences"] = held_streams(
        torch, np, f"{tag} unpadded vs solo generate", streams["unpadded"], solo, params, cfg,
        ureqs, device, {}, group="recur")
    # (e) sampled at SAMPLE_T on the unpadded cell, each token held to its draw
    _, streams["sampled"], runs["sampled"] = continuous_run(
        torch, np, params, cfg, base, {"temperature": SAMPLE_T},
        (ureqs, budgets, CONT["slots"]), f"{tag} sampled", device, "recur", stamp=stamp)
    s_divs, share = held_sampled(torch, np, f"{tag} sampled", params, cfg, ureqs,
                                 streams["sampled"], 0, SAMPLE_T, device, group="recur")
    runs["sampled"].update(temperature=SAMPLE_T, share_off_argmax=share,
                           near_tie_divergences=len(s_divs))
    log(f"[recur] {tag} sampled at T={SAMPLE_T}: {share:.4f} of the tokens off the argmax of "
        f"their own logits, {len(s_divs)} near-tie partings from their recomputed draws "
        f"{stamp()}")
    if share < MIN_SAMPLED_SHARE:
        # the input token's lead beats the noise at SAMPLE_T: hold a run at
        # phase 11's hot T too, where the draws leave the argmax
        lg, _ = lm.forward(params, cfg, torch.as_tensor(np.concatenate(
            [ureqs[0], streams["unpadded"][0][:-1]]).astype(np.int64)[None], device=device))
        hot_t, expect = hot_temperature(torch, lg[0, L - 1:])
        del lg
        _, streams["sampled_hot"], runs["sampled_hot"] = continuous_run(
            torch, np, params, cfg, base, {"temperature": hot_t},
            (ureqs, budgets, CONT["slots"]), f"{tag} sampled_hot", device, "recur", stamp=stamp)
        h_divs, h_share = held_sampled(torch, np, f"{tag} sampled_hot", params, cfg, ureqs,
                                       streams["sampled_hot"], 0, hot_t, device, group="recur")
        runs["sampled_hot"].update(temperature=hot_t, share_off_argmax=h_share,
                                   expected_share_off_argmax=expect,
                                   near_tie_divergences=len(h_divs))
        log(f"[recur] {tag} sampled at the hot T={hot_t}: {h_share:.4f} of the tokens off the "
            f"argmax (expected {expect:.3f}, floor {MIN_SAMPLED_SHARE}), {len(h_divs)} near-tie "
            f"partings from their recomputed draws {stamp()}")
        if h_share < MIN_SAMPLED_SHARE:
            raise RuntimeError(f"{tag}: only {h_share:.4f} of the hot sampled tokens are off "
                               "the argmax")

    # (f) refused as the reference refuses them
    for what, fn in (
            ("paged", lambda: Engine(params, cfg, ServeConfig(
                max_seq=16, paged=True, block_size=8), device=device).serve_continuous(
                    [ureqs[0][:4]], slots=1, max_new=2)),
            ("speculative", lambda: speculative.DraftModel.from_target(params, cfg, 1)),
            ("verify window", lambda: lm.verify_window(
                params, cfg, torch.zeros((1, 2), dtype=torch.long, device=device),
                lm.init_caches(cfg, 1, 8, torch.float32, device),
                torch.zeros(1, dtype=torch.long, device=device)))):
        try:
            fn()
        except NotImplementedError as e:
            log(f"[recur] {tag} {what} refused: {e}")
        else:
            raise RuntimeError(f"{tag}: {what} serving was not refused")

    # (g) one warm decode step of the cell's slots, profiled
    if cuda:
        k = CONT["slots"]
        toks = torch.as_tensor(np.stack(ureqs[:k]).astype(np.int64), device=device)
        _, caches = lm.prefill(params, cfg, toks, L + 8)
        tok, pos = toks[:, -1:], torch.full((k,), L, device=device)
        step = lambda: lm.decode_step(params, cfg, tok, caches, pos)   # noqa: E731
        step()
        prof = profile_call(torch, step, lambda: f"one warm {tag} decode step of {k} slots")
        out["profile_step"] = {x: prof.get(x) for x in ("wall_ms", "busy_ms", "busy_share",
                                                         "kernels", "top")}
        del caches
    out["runs"] = runs
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    log(f"[recur] {tag} done {stamp()}; peak_mem_GB={(out['peak_mem_bytes'] or 0) / 1e9:.3f}")
    del params
    return out


def zamba_path(torch, np, device="cuda", cfg=None):
    """Phase 12 (a): zamba2-1.2b at full width and depth (38 layers; the
    shared block's 6 unread stacked copies kept, as the reference's tree),
    and the SSD scan across chunks: a prefill of ``long_prefill`` tokens
    (7 chunks) and teacher-forced decode to ``long_len`` held to
    ``lm.forward`` over all of them (8 chunks)."""
    from repro_torch.configs import zamba2_1_2b

    cfg = cfg or zamba2_1_2b.config().model

    def long_check(params):
        rs = np.random.RandomState(6)
        t = torch.as_tensor(rs.randint(0, cfg.vocab, (RECUR["long_rows"], RECUR["long_len"])),
                            device=device)
        T0 = RECUR["long_prefill"]
        t0 = time.perf_counter()
        dec = teacher_forced(torch, params, cfg, t, t.shape[1], start=T0)
        fwd = ssd_forward(torch, params, cfg, t)[:, T0 - 1:-1]
        err = rel_err(dec, fwd)
        log(f"[recur] zamba2 prefill {T0} + {t.shape[1] - T0 - 1} decode steps vs lm.forward "
            f"over {t.shape[1]} tokens ({RECUR['long_rows']} rows): max err {err:.3e} of "
            f"max|logit| (tol {SSM_REL:.0e}), {time.perf_counter() - t0:.1f} s")
        if not err <= SSM_REL:
            raise RuntimeError("zamba2: decode past 7 SSD chunks disagrees with lm.forward")
        return {"long_decode_vs_forward_rel": err}

    return recurrent_path(torch, np, "zamba2", cfg, device, SSM_REL, long_check)


def xlstm_path(torch, np, device="cuda", cfg=None):
    """Phase 12 (b): xlstm-1.3b at full width, ``XLSTM_REPEATS`` of its 6
    units deep (14 mLSTM and 2 sLSTM layers), and the chunked mLSTM:
    ``chunked_len`` tokens (4 chunks of 64) through ``mlstm_impl="chunked"``
    held to the recurrent forward, both timed."""
    import dataclasses

    from repro_torch.configs import xlstm_1_3b
    from repro_torch.models import lm

    cfg = cfg or xlstm_1_3b.build(n_repeats=XLSTM_REPEATS).model

    def chunked_check(params):
        ccfg = dataclasses.replace(cfg, unit=tuple(
            dataclasses.replace(b, xlstm=dataclasses.replace(b.xlstm, mlstm_impl="chunked"))
            for b in cfg.unit))
        rs = np.random.RandomState(7)
        t = torch.as_tensor(rs.randint(0, cfg.vocab, (RECUR["chunked_rows"],
                                                      RECUR["chunked_len"])), device=device)
        got = {}
        for name, c in (("recurrent", cfg), ("chunked", ccfg)):
            lm.forward(params, c, t[:, :8])                     # warm
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[name] = lm.forward(params, c, t)[0]
            if device == "cuda":
                torch.cuda.synchronize()
            got[name + "_ms"] = (time.perf_counter() - t0) * 1e3
        err = rel_err(got["chunked"], got["recurrent"])
        log(f"[recur] xlstm chunked mLSTM ({t.shape[1]} tokens, chunk "
            f"{cfg.unit[0].xlstm.chunk}, {t.shape[0]} rows) vs recurrent: max err {err:.3e} of "
            f"max|logit| (tol {XLSTM_REL:.0e}); lm.forward {got['recurrent_ms']:.1f} ms "
            f"recurrent, {got['chunked_ms']:.1f} ms chunked")
        if not err <= XLSTM_REL:
            raise RuntimeError("xlstm: the chunked mLSTM disagrees with the recurrent one")
        return {"chunked_vs_recurrent_rel": err, "forward_recurrent_ms": got["recurrent_ms"],
                "forward_chunked_ms": got["chunked_ms"]}

    return recurrent_path(torch, np, "xlstm", cfg, device, XLSTM_REL, chunked_check)


# Phase 13: the LM trainer and the non-token inputs.  (a) kanformer-100m
# trained at full width with the reference example's settings
# (examples/lm_train.py: batch 8, seq 64, lr 2e-3, 300 steps, a checkpoint
# every 75), then its restart drill; (b) the trained weights served through
# kernels 1 and 2; (c)-(e) paligemma-3b and musicgen-large at full width and
# depth: decode against forward, and one AdamW step each.  Training runs the
# KAN FFN on its ``dense`` path, as the reference trains it: no kernel.
TRAIN = {"arch": "kanformer-100m", "steps": 300, "batch": 8, "seq": 64, "lr": 2e-3,
         "ckpt_every": 75, "drill": 20, "resume_at": 10, "resume_to": 20, "bf16_steps": 20,
         "card_cpu_steps": 3, "card_cpu_batch": 2, "warm_from": 10}
# the mean loss of the last 10 steps at least this far (nats) below the first
# 10's: a CPU rehearsal of the recipe at the reduced width fell by 47.5 nats
# (53.38 -> 5.87); the full width starts higher (logits ~ sqrt(d) wider)
LOSS_DROP = 10.0
# card vs the same machine's CPU, 3 steps from the same start: loss and
# grad_norm (fp32 sums over d = 512 and 512 rows in other orders)
CARD_CPU_RTOL = 1e-4
# 10 steps + save + restore + 10 against 20 straight steps: the same ops in
# the same order, but the embedding gradient's index_put_ may accumulate in
# another order (on the CPU at batch 8 x 64: an ulp of the table, 3.0e-5 lr
# in the state after 20 steps); Adam's normalised step can carry an ulp of a
# gradient near zero to ~1e-2 lr (tests/test_torch_train.py, STEP_ATOL)
RESUME_ATOL_LR = 1e-2
RESUME_RTOL = 1e-5
NONTOKEN = {"batch": 2, "text": 32, "decode": 16, "frames": 128, "more_frames": 32,
            "train_batch": 1, "pali_train_text": 32, "music_train_frames": 64}


def _mean(xs) -> float:
    return float(sum(xs) / len(xs))


def train_path(torch, np, device="cuda", reduced=False, steps=TRAIN["steps"]):
    """Phase 13 (a) and (b), any miss raises: kanformer-100m trained through
    ``launch.train.run`` (``reduced`` for a CPU rehearsal), with zero kernel
    launches, its loss falling by ``LOSS_DROP``; the restart drill; card
    against CPU; resume against straight; bf16; one warm step profiled; then
    the trained weights served statically with exact launch counts and the
    kernel path held to the plain path."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.checkpoint import store
    from repro_torch.convert import flatten_with_paths, tree_map
    from repro_torch.launch import train as T
    from repro_torch.models import costs, lm
    from repro_torch.optim import adamw
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train import step as TS

    cuda = device == "cuda"
    arch = TRAIN["arch"]
    cfg = (configs.get_reduced if reduced else configs.get_config)(arch).model
    B, S, lr = TRAIN["batch"], TRAIN["seq"], TRAIN["lr"]
    flags = ["--arch", arch, "--batch", str(B), "--seq", str(S), "--lr", str(lr),
             "--device", device, "--log-every", "50"] + (["--reduced"] if reduced else [])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    out, runs = {}, {}
    seen: dict = {}
    make_batch = T.make_batch

    def recording(model, data_cfg, step, dev):         # the batches a run consumes
        batch = make_batch(model, data_cfg, step, dev)
        seen.setdefault(seen["run"], {})[step] = {k: v.cpu() for k, v in batch.items()}
        return batch

    def train(name, argv):
        seen["run"] = name
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        res, m = counted(torch, f"{arch} {name}", lambda: T.run(flags + argv), {}, device,
                         tag="train")
        runs[name] = {"launches": m["launches"], "wall_ms": m["wall_ms"]}
        if not np.isfinite(res["losses"]).all():
            raise RuntimeError(f"training {name}: a loss is not finite")
        return res, (torch.cuda.max_memory_allocated() if cuda else None)

    T.make_batch = recording
    try:
        # (a) the reference example's run, then its restart drill
        ckpt = os.path.join(tmp, "run")
        res, peak = train("trained", ["--steps", str(steps), "--ckpt-dir", ckpt,
                                      "--ckpt-every", str(TRAIN["ckpt_every"])])
        losses = res["losses"]
        first, last = _mean(losses[:10]), _mean(losses[-10:])
        warm = sorted(res["step_s"][TRAIN["warm_from"]:])
        ms = 1e3 * warm[len(warm) // 2]
        kept = store.all_steps(ckpt)
        want_kept = sorted({*range(TRAIN["ckpt_every"], steps + 1, TRAIN["ckpt_every"]),
                            steps})[-3:]          # the writer keeps the newest 3
        flops = costs.model_flops(cfg, B * S, "train")
        share = flops / (ms / 1e3) / PEAK_FLOPS["float32"] if cuda else None
        log(f"[train] {arch} {'reduced' if reduced else 'full width'} d={cfg.d_model} "
            f"layers={cfg.n_repeats}: {steps} steps of batch {B} x {S} at lr {lr}: loss "
            f"{first:.4f} (first 10) -> {last:.4f} (last 10), drop {first - last:.3f} (min "
            f"{LOSS_DROP}); {ms:.3f} ms per warm step (median, synchronised by the loss read), "
            f"{B * S / ms * 1e3:.0f} tokens/s; peak_mem_GB={(peak or 0) / 1e9:.3f}; "
            f"checkpoints kept {kept}; model FLOPs {flops / 1e9:.1f} G per step "
            f"(costs.model_flops) = {share or 0:.4f} of the fp32 peak at the warm step")
        if first - last < LOSS_DROP:
            raise RuntimeError(f"training: the loss fell by {first - last:.3f} < {LOSS_DROP}")
        if kept != want_kept:
            raise RuntimeError(f"training: checkpoints {kept}, expected {want_kept}")
        params, state = res["params"], res["opt_state"]
        drill, _ = train("drill", ["--steps", str(steps + TRAIN["drill"]), "--ckpt-dir", ckpt,
                                   "--ckpt-every", str(TRAIN["ckpt_every"])])
        if (drill["start_step"], drill["steps"]) != (steps, steps + TRAIN["drill"]):
            raise RuntimeError(f"restart drill: resumed at {drill['start_step']}, ended at "
                               f"{drill['steps']}")
        log(f"[train] restart drill: resumed at step {drill['start_step']}, "
            f"{len(drill['losses'])} more steps, loss {drill['losses'][0]:.4f} -> "
            f"{drill['losses'][-1]:.4f}")
        out.update({"loss_first10": first, "loss_last10": last, "ms_per_step": ms,
                    "tokens_per_s": B * S / ms * 1e3, "peak_mem_bytes": peak,
                    "model_flops": flops, "fp32_peak_share": share,
                    "checkpoints": kept, "drill_losses": drill["losses"]})

        # 10 steps + save + restore + 10 against 20 straight steps
        a_dir, b_dir = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        n, at = TRAIN["resume_to"], TRAIN["resume_at"]
        straight, _ = train("straight", ["--steps", str(n), "--ckpt-dir", a_dir,
                                         "--ckpt-every", str(at)])
        shutil.copytree(os.path.join(a_dir, f"step_{at:08d}"),
                        os.path.join(b_dir, f"step_{at:08d}"))
        resumed, _ = train("resumed", ["--steps", str(n), "--ckpt-dir", b_dir,
                                       "--ckpt-every", str(at)])
        if resumed["start_step"] != at or sorted(seen["resumed"]) != list(range(at, n)):
            raise RuntimeError(f"resume: started at {resumed['start_step']}, batches "
                               f"{sorted(seen['resumed'])}")
        stream_equal = all(torch.equal(seen["resumed"][s][k], seen["straight"][s][k])
                           for s in range(at, n) for k in seen["straight"][s])
        pa = flatten_with_paths((straight["params"], straight["opt_state"]))
        pb = flatten_with_paths((resumed["params"], resumed["opt_state"]))
        gap = max((pa[k].double() - pb[k].double()).abs().max().item() for k in pa)
        loss_gap = max(abs(x - y) / abs(y) for x, y in zip(resumed["losses"],
                                                           straight["losses"][at:]))
        log(f"[train] {at} steps + save + restore + {n - at} against {n} straight: max "
            f"|state gap| {gap:.3e} = {gap / lr:.3e} lr (tol {RESUME_ATOL_LR:.0e} lr), losses "
            f"rel {loss_gap:.3e} (tol {RESUME_RTOL:.0e}); the resumed run's batches "
            f"{'equal' if stream_equal else 'DIFFER FROM'} the straight run's, bit for bit")
        if not stream_equal or gap > RESUME_ATOL_LR * lr or loss_gap > RESUME_RTOL:
            raise RuntimeError("resume: the resumed run differs from the straight run")
        out["resume"] = {"state_gap": gap, "loss_rel_gap": loss_gap, "stream_equal": True}

        # bf16 compute, 20 steps
        bf, _ = train("bf16", ["--steps", str(TRAIN["bf16_steps"]), "--compute-dtype",
                               "bfloat16"])
        b_first, b_last = _mean(bf["losses"][:5]), _mean(bf["losses"][-5:])
        log(f"[train] bf16 compute, {TRAIN['bf16_steps']} steps: loss {b_first:.4f} (first 5) "
            f"-> {b_last:.4f} (last 5)")
        if not b_last < b_first:
            raise RuntimeError("bf16 training: the loss did not fall")
        out["bf16"] = {"loss_first5": b_first, "loss_last5": b_last}
    finally:
        T.make_batch = make_batch
        shutil.rmtree(tmp, ignore_errors=True)

    # card against this machine's CPU: 3 steps from the same start and batches
    # (2 rows of 64: the CPU's full-width steps at 8 x 64 are slow)
    opt = adamw.AdamWConfig(lr=lr, total_steps=steps, warmup_steps=min(20, steps // 10 + 1))
    data = T.dp.LMDataConfig(cfg.vocab, S, TRAIN["card_cpu_batch"])
    start = lm.init_params(cfg, seed=1, device="cpu")
    mets = []
    for dev in ("cpu", device):                    # the updates are in place: a copy each
        p = tree_map(lambda t: t.to(dev, copy=True), start)
        st, fn, m = adamw.init_state(p), TS.make_train_step(cfg, opt), []
        for i in range(TRAIN["card_cpu_steps"]):
            p, st, met = fn(p, st, T.make_batch(cfg, data, i, dev))
            m.append((float(met["loss"]), float(met["grad_norm"])))
        mets.append(np.array(m))
        del p, st
    rel = float(np.abs(mets[1] - mets[0]).max() / np.abs(mets[0]).min())
    log(f"[train] {TRAIN['card_cpu_steps']} steps on {device} against the CPU: (loss, grad_norm) "
        f"{mets[1].tolist()} vs {mets[0].tolist()}; max rel gap {rel:.3e} "
        f"(tol {CARD_CPU_RTOL:.0e})")
    if rel > CARD_CPU_RTOL:
        raise RuntimeError("training on the card disagrees with the CPU")
    out["card_vs_cpu_rel"] = rel

    # (b) the trained weights served through kernels 1 and 2
    rs = np.random.RandomState(0)
    lens = rs.randint(32, 129, 8)
    reqs = [rs.randint(0, cfg.vocab, L).astype(np.int32) for L in lens]
    batch, new = 4, 32
    max_seq = int(lens.max()) + new + 8
    eng = Engine(params, cfg, ServeConfig(max_seq=max_seq, max_new_tokens=new), device=device)
    per_pass = 2 * cfg.n_repeats

    def want():
        nb = len(eng.last_serve_stats["buckets"])
        return {"kan_fused_gemm": nb * per_pass, "kan_sparse_gemm": nb * (new - 1) * per_pass}

    outs, m = counted(torch, "trained kanformer static", lambda: eng.serve_requests(
        reqs, batch_size=batch, seed=0), want, device, tag="train")
    runs["trained_static"] = {"launches": m["launches"], "wall_ms": m["wall_ms"]}
    for o in outs:
        if o.shape != (new,) or o.min() < 0 or o.max() >= cfg.vocab:
            raise RuntimeError(f"trained static: bad output {o}")
    kern, ref, _, _ = kernel_vs_plain(torch, np, eng.params, cfg, reqs, outs, batch, max_seq,
                                      device)
    err = (kern - ref).abs().max().item()
    if not torch.isfinite(kern).all():
        raise RuntimeError("trained kanformer: logits not finite")
    log(f"[train] trained weights served statically: {len(reqs) * new} tokens in "
        f"{m['wall_ms'] / 1e3:.3f} s ({len(reqs) * new / m['wall_ms'] * 1e3:.1f} tok/s); kernel "
        f"vs plain path logits (prefill + 4 decode steps) max_abs_err={err:.3e} tol="
        f"{LOGIT_ATOL:.1e} max|logit|={ref.abs().max().item():.2f}")
    if err > LOGIT_ATOL:
        raise RuntimeError("trained kanformer: kernel path logits disagree with the plain path")
    out["served"] = {"logit_max_abs_err": err, "max_logit": ref.abs().max().item(),
                     "tok_s": len(reqs) * new / m["wall_ms"] * 1e3}

    # one warm training step under the profiler
    if cuda:
        fn = TS.make_train_step(cfg, opt)
        one = T.make_batch(cfg, T.dp.LMDataConfig(cfg.vocab, S, B), 0, device)
        out["profile_step"] = profile_call(torch, lambda: fn(params, state, one),
                                           lambda: f"one warm {arch} training step (batch "
                                                   f"{B} x {S})")
    out["runs"] = runs
    return out


def nontoken_path(torch, np, device="cuda", reduced=False):
    """Phase 13 (c)-(e), any miss raises: paligemma-3b (256 patch embeddings
    + 32 text tokens, 16 greedy decode steps from position 288) and
    musicgen-large (128 frames prefilled, 32 decoded as ``(B, 1, d)`` rows
    and again as ``(B, d)`` rows) at full width and depth (``reduced`` for a
    CPU rehearsal), random weights from seed 0: prefill against
    ``lm.forward``, decode teacher-forced against ``lm.forward`` over the
    whole sequence within ``DENSE_REL`` of max|logit|; then one AdamW step
    of each (loss, gradient norm and parameters finite; ``ntokens`` the
    text labels alone), peak memory.  Every run counted: no kernel."""
    import gc

    from repro_torch import configs
    from repro_torch.convert import flatten_with_paths
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS

    cuda = device == "cuda"
    get = configs.get_reduced if reduced else configs.get_config
    B, out, runs = NONTOKEN["batch"], {}, {}

    def run(name, fn):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            res, m = counted(torch, name, fn, {}, device, tag="inputs")
        runs[name] = {"launches": m["launches"], "wall_ms": m["wall_ms"],
                      "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None}
        return res

    def train_step(tag, cfg, params, seq):
        state = adamw.init_state(params)
        step = TS.make_train_step(cfg, adamw.AdamWConfig(lr=TRAIN["lr"]))
        batch = T.make_batch(cfg, T.dp.LMDataConfig(cfg.vocab, seq, NONTOKEN["train_batch"]), 0,
                             device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        (p, st, met), m = counted(torch, f"{tag} AdamW step", lambda: step(params, state, batch),
                                  {}, device, tag="inputs")
        peak = torch.cuda.max_memory_allocated() if cuda else None
        runs[f"{tag}_train_step"] = {"launches": m["launches"], "wall_ms": m["wall_ms"],
                                     "peak_mem_bytes": peak}
        finite = all(torch.isfinite(t).all().item() for t in flatten_with_paths(p).values())
        want_tokens = NONTOKEN["train_batch"] * (seq - 1)
        r = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
             "ntokens": float(met["ntokens"]), "params_finite": finite, "peak_mem_bytes": peak,
             "state_bytes": tree_bytes(p) * 4}
        log(f"[inputs] {tag} one AdamW step at full width and depth: loss {r['loss']:.4f}, "
            f"grad_norm {r['grad_norm']:.4f}, ntokens {r['ntokens']:.0f} (the text labels: "
            f"{want_tokens}), parameters finite {finite}; {m['wall_ms']:.1f} ms; params + grads "
            f"+ m + v {r['state_bytes'] / 1e9:.2f} GB; peak_mem_GB={(peak or 0) / 1e9:.3f}")
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) and finite
                and r["ntokens"] == want_tokens):
            raise RuntimeError(f"{tag} train step: {r}")
        del state, st
        return r

    # (c) paligemma-3b: patch prefix + text, greedy decode
    cfg = get("paligemma-3b").model
    params = lm.init_params(cfg, seed=0, device=device)
    n_params = sum(t.numel() for t in flatten_with_paths(params).values())
    rs = np.random.RandomState(5)
    P, Tt, n = cfg.n_prefix, NONTOKEN["text"], NONTOKEN["decode"]
    prefix = torch.as_tensor(rs.normal(size=(B, P, cfg.d_model)).astype(np.float32),
                             device=device)
    text = torch.as_tensor(rs.randint(0, cfg.vocab, (B, Tt)), device=device)
    inputs = {"prefix_embeddings": prefix, "tokens": text}
    log(f"[inputs] paligemma-3b: d={cfg.d_model} layers={cfg.n_layers} heads "
        f"{cfg.unit[0].attn.n_heads}/{cfg.unit[0].attn.n_kv_heads} d_ff={cfg.unit[0].d_ff} "
        f"vocab={cfg.vocab} params={n_params / 1e9:.3f}B fp32; {B} x ({P} patches + {Tt} "
        f"tokens), {n} decode steps")

    def pali():
        fwd, _ = lm.forward(params, cfg, inputs)
        pre, caches = lm.prefill(params, cfg, inputs, P + Tt + n)
        e_pre = rel_err(pre, fwd)
        del fwd
        dec, toks = [pre[:, -1]], []
        for j in range(n):
            toks.append(dec[-1].argmax(-1)[:, None])
            lg, caches = lm.decode_step(params, cfg, toks[-1], caches,
                                        torch.tensor(P + Tt + j, device=device))
            dec.append(lg)
        full, _ = lm.forward(params, cfg, {"prefix_embeddings": prefix,
                                           "tokens": torch.cat([text] + toks, 1)})
        dec = torch.stack(dec, 1)
        want = full[:, P + Tt - 1:]
        return e_pre, rel_err(dec, want), (dec.argmax(-1) == want.argmax(-1)).float().mean().item()

    e_pre, e_dec, agree = run("paligemma decode", pali)
    log(f"[inputs] paligemma prefill vs lm.forward: {e_pre:.3e} of max|logit|; {n} greedy "
        f"decode steps from position {P + Tt} teacher-forced vs lm.forward over "
        f"{P + Tt + n} positions: {e_dec:.3e} (tol {DENSE_REL:.0e}), top-1 agreement {agree:.4f}")
    if max(e_pre, e_dec) > DENSE_REL:
        raise RuntimeError("paligemma: decode disagrees with lm.forward")
    out["paligemma"] = {"params": n_params, "prefill_vs_forward_rel": e_pre,
                        "decode_vs_forward_rel": e_dec, "top1_agreement": agree,
                        "train_step": train_step("paligemma", cfg, params,
                                                 NONTOKEN["pali_train_text"])}
    del params, prefix, text, inputs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # (d) musicgen-large: frames, decoded as (B, 1, d) rows and as (B, d) rows
    cfg = get("musicgen-large").model
    params = lm.init_params(cfg, seed=0, device=device)
    n_params = sum(t.numel() for t in flatten_with_paths(params).values())
    F0, n = NONTOKEN["frames"], NONTOKEN["more_frames"]
    frames = torch.as_tensor(np.random.RandomState(6).normal(
        size=(B, F0 + n, cfg.d_model)).astype(np.float32), device=device)
    log(f"[inputs] musicgen-large: d={cfg.d_model} layers={cfg.n_layers} heads "
        f"{cfg.unit[0].attn.n_heads} d_ff={cfg.unit[0].d_ff} vocab={cfg.vocab} "
        f"params={n_params / 1e9:.3f}B fp32; {B} x {F0} frames prefilled, {n} decoded")

    def music():
        fwd, _ = lm.forward(params, cfg, {"embeddings": frames})
        rows = []
        for flat in (False, True):
            pre, caches = lm.prefill(params, cfg, {"embeddings": frames[:, :F0]}, F0 + n)
            got = []
            for j in range(n):
                row = frames[:, F0 + j] if flat else frames[:, F0 + j:F0 + j + 1]
                lg, caches = lm.decode_step(params, cfg, row, caches,
                                            torch.tensor(F0 + j, device=device))
                got.append(lg)
            rows.append(torch.stack(got, 1))
        return (rel_err(pre, fwd[:, :F0]), rel_err(rows[0], fwd[:, F0:]),
                torch.equal(rows[0], rows[1]))

    e_pre, e_dec, same = run("musicgen decode", music)
    log(f"[inputs] musicgen prefill vs lm.forward: {e_pre:.3e}; {n} frames decoded vs "
        f"lm.forward over {F0 + n}: {e_dec:.3e} of max|logit| (tol {DENSE_REL:.0e}); (B, d) rows "
        f"{'equal' if same else 'DIFFER FROM'} (B, 1, d) rows")
    if max(e_pre, e_dec) > DENSE_REL or not same:
        raise RuntimeError("musicgen: decode disagrees with lm.forward or across row shapes")
    out["musicgen"] = {"params": n_params, "prefill_vs_forward_rel": e_pre,
                       "decode_vs_forward_rel": e_dec, "row_shapes_equal": same,
                       "train_step": train_step("musicgen", cfg, params,
                                                NONTOKEN["music_train_frames"])}
    del params, frames
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["runs"] = runs
    return out


# Phase 14: GPipe pipeline training (``train/pipeline.py``) on one card, where
# the reference's stages over the ``pod`` axis are a microbatch schedule.
# kanformer-100m and qwen1.5-0.5b at full width and depth, olmoe-1b-7b at
# full width and 4 of its 16 repeats (the script's time), phase 13's batch;
# like training, no kernel on the path.  At full width in fp32, kanformer's
# ``lm_loss`` gradients over the whole batch and summed over microbatches
# differ by ~1.6e-3 of max|g| in two KAN leaves.  So the fp32 pipeline is
# held to ``lm_loss`` over the same microbatches, and each schedule is run
# again at fp64 compute (the blocks; the logits stay fp32, as the
# reference's) and held to the whole batch's ``loss_and_grads`` at fp64:
# a defect that depends on the rows per call would show there too.
PIPE = {"batch": 8, "seq": 64, "seed": 0, "warm": 3,
        "models": (("kanformer-100m", None, ((2, 4), (4, 4), (2, 8))),
                   ("qwen1.5-0.5b", None, ((4, 4),)),
                   ("olmoe-1b-7b", 4, ((2, 4),)))}
# the tolerances of tests/test_torch_train.py (LOSS_RTOL, GRAD_REL): fp32
# sums over microbatches in another order than one batch's
PIPE_LOSS_RTOL = 1e-5
PIPE_GRAD_REL = 1e-4


def max_leaf_rel(got: dict, want: dict) -> float:
    """The largest ``max|got - want| / max|want|`` over the leaves."""
    return max(float((got[k] - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for k, w in want.items())


def gap_columns(got: dict, want: dict, rel: float) -> dict:
    """Per leaf whose ``max|got - want|`` passes ``rel`` of its max|want|:
    the (leading index, last-axis index) pairs where an entry passes
    ``rel / 10`` of it (their count, the first four): a jump in one output
    column of one repeat, or a spread."""
    out = {}
    for k, w in want.items():
        e = (got[k] - w).abs() / w.abs().max().clamp_min(1e-30)
        if float(e.max()) > rel:
            idx = (e > rel / 10).nonzero()
            pairs = sorted({(int(i[0]), int(i[-1])) for i in idx.tolist()})
            out[k] = {"max": float(e.max()), "pairs": len(pairs), "first": pairs[:4]}
    return out


def kernels_per_call(torch, fn) -> dict:
    """``fn`` once under ``torch.profiler`` with device activity only (the
    host's op records cost ~0.5 ms per kernel): kernels launched and the
    union of their intervals."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return {"kernels": len(spans) or None, "busy_ms": busy / 1e3 if spans else None}


def pipeline_path(torch, np, device="cuda", reduced=False):
    """Phase 14, any miss raises: per model of ``PIPE``, the plain
    ``loss_and_grads`` and the pipelined loss and gradient at each ``(S,
    M)``, every run counted (no kernel); kanformer and qwen: the pipelined
    loss within ``PIPE_LOSS_RTOL`` of ``lm_loss`` and each gradient leaf,
    mapped back from the staged layout, within ``PIPE_GRAD_REL`` of its
    max|g| of ``lm_loss`` over the same microbatches, at fp64 compute
    within ``PIPE_GRAD_REL`` of the whole batch's ``loss_and_grads`` at
    fp64, and a bf16 run finite; olmoe: the loss within ``PIPE_LOSS_RTOL``
    of ``lm.forward``'s token-weighted NLL over each microbatch alone, the
    gradients finite, the drop fractions of the whole batch and of the
    microbatches.  Recorded per run: warm ms (median of ``PIPE["warm"]``),
    kernels per step, peak memory, the bubble ``(S-1)/(M+S-1)``, model FLOPs
    (``costs.model_flops``) and their share of the fp32 peak.  ``reduced``:
    a CPU rehearsal at the reduced widths, every model at 4 repeats."""
    import dataclasses
    import gc

    from repro_torch import configs
    from repro_torch.convert import flatten_with_paths, tree_map
    from repro_torch.launch import train as T
    from repro_torch.models import costs, lm
    from repro_torch.train import pipeline as PP
    from repro_torch.train import step as TS

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    Bt, St = PIPE["batch"], PIPE["seq"]
    out, runs = {}, {}

    def warm_ms(fn):
        times = []
        for _ in range(PIPE["warm"]):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]

    def measured(tag, name, fn, flops):
        """The counted run (peak memory over it), then warm runs and one
        under the profiler."""
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        res, m = counted(torch, f"{tag} {name}", fn, {}, device, tag="pipe")
        runs[f"{tag}_{name}"] = m
        rec = {"launches": m["launches"], "cold_ms": m["wall_ms"],
               "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None,
               "ms": warm_ms(fn) if cuda else None}
        rec.update(kernels_per_call(torch, fn) if cuda else {"kernels": None, "busy_ms": None})
        rec["flops"] = flops
        rec["fp32_peak_share"] = (flops / (rec["ms"] / 1e3) / PEAK_FLOPS["float32"]
                                  if rec["ms"] else None)
        return res, rec

    for arch, repeats, schedules in PIPE["models"]:
        cfg = (configs.get_reduced if reduced else configs.get_config)(arch).model
        if reduced:
            repeats = 4
        if repeats:
            cfg = dataclasses.replace(cfg, n_repeats=repeats)
        moe = arch == "olmoe-1b-7b"
        params = lm.init_params(cfg, seed=PIPE["seed"], device=device)
        batch = T.make_batch(cfg, T.dp.LMDataConfig(cfg.vocab, St, Bt), 0, device)
        flops = costs.model_flops(cfg, Bt * St, "train")
        tag = arch.split("-")[0]
        res = {"n_repeats": cfg.n_repeats, "params": costs.n_params(cfg), "runs": {}}
        (plain_loss, plain_met, plain_g), rec = measured(
            tag, "plain", lambda: TS.loss_and_grads(params, cfg, batch), flops)
        res["plain"] = rec
        want, split = flatten_with_paths(plain_g), {}

        def split_grads(M):
            """``loss_and_grads`` of each microbatch alone, weighted by its
            share of the labels and summed: the pipeline's gradient,
            computed by ``lm_loss`` over the same rows at a time."""
            if M not in split:
                total = float((batch["labels"] >= 0).sum())
                acc = {}
                for i in range(M):
                    mb = {k: v.chunk(M)[i] for k, v in batch.items()}
                    _, met, g = TS.loss_and_grads(params, cfg, mb)
                    w = float(met["ntokens"]) / total
                    for k, v in flatten_with_paths(g).items():
                        acc[k] = acc[k] + v * w if k in acc else v * w
                split[M] = acc
            return split[M]

        if moe:                  # lm.forward on each microbatch alone, and the whole batch
            with torch.no_grad(), DropMeter() as whole:
                lm.forward(params, cfg, batch["tokens"])
            res["moe_drop_frac_batch"] = whole.summary()["moe_drop_frac"]
        for S, M in schedules:
            fn = PP.make_pp_loss(cfg, S, M)
            staged = PP.stage_params(params, S)
            name = f"S{S}_M{M}"
            (loss, _, g), rec = measured(tag, name, lambda: TS.value_and_grads(
                lambda p: (fn(p, batch), {}), staged), flops)
            got = flatten_with_paths(PP.unstage_params(g))
            finite = all(bool(torch.isfinite(v).all()) for v in got.values())
            rec.update(loss=float(loss), bubble=(S - 1) / (M + S - 1), grads_finite=finite,
                       kernels_vs_plain=(rec["kernels"] / res["plain"]["kernels"]
                                         if rec["kernels"] else None))
            if moe:
                nll, count = 0.0, 0.0
                with torch.no_grad(), DropMeter() as micro:
                    for tok, lbl in zip(batch["tokens"].chunk(M), batch["labels"].chunk(M)):
                        logits, _ = lm.forward(params, cfg, tok)
                        mask = (lbl >= 0).float()
                        logp = torch.log_softmax(logits, -1)
                        per = -logp.gather(-1, lbl.long().clamp(0, cfg.vocab - 1)[..., None])
                        nll += float((per[..., 0] * mask).sum())
                        count += float(mask.sum())
                want_loss = nll / count
                rec.update(moe_drop_frac_microbatches=micro.summary()["moe_drop_frac"],
                           lm_loss_nll=float(plain_met["loss"]))
                grad_err = None
            else:
                want_loss = float(plain_loss)
                grad_err = max_leaf_rel(got, split_grads(M))
                rec.update(grad_rel_whole_batch=max_leaf_rel(got, want),
                           split_vs_whole_batch=max_leaf_rel(split_grads(M), want))
            rec.update(want_loss=want_loss, loss_rel=abs(float(loss) - want_loss) / abs(want_loss),
                       grad_rel=grad_err)
            log(f"[pipe] {arch} {cfg.n_repeats} repeats, S={S} M={M} (bubble "
                f"{rec['bubble']:.3f}): loss {float(loss):.6f} vs "
                f"{'per-microbatch lm.forward NLL' if moe else 'lm_loss'} {want_loss:.6f}, rel "
                f"{rec['loss_rel']:.3e} (tol {PIPE_LOSS_RTOL:.0e}); grads "
                f"{'finite' if finite else 'NOT FINITE'}"
                + (f", max leaf err / max|g| {grad_err:.3e} (tol {PIPE_GRAD_REL:.0e}) against "
                   f"lm_loss over the same microbatches; against lm_loss over the whole batch "
                   f"{rec['grad_rel_whole_batch']:.3e}, where lm_loss's own microbatch split "
                   f"gives {rec['split_vs_whole_batch']:.3e}"
                   if grad_err is not None else
                   f"; drop frac microbatches {rec['moe_drop_frac_microbatches']:.4f}, whole "
                   f"batch {res['moe_drop_frac_batch']:.4f}, lm_loss NLL "
                   f"{rec['lm_loss_nll']:.6f}"))
            if (rec["loss_rel"] > PIPE_LOSS_RTOL or not finite
                    or (grad_err is not None and grad_err > PIPE_GRAD_REL)):
                raise RuntimeError(f"pipeline {arch} S={S} M={M} disagrees with its reference")
            res["runs"][name] = rec
            del g, got, staged
        if not moe:              # bf16 compute at the first schedule
            S, M = schedules[0]
            fn = PP.make_pp_loss(cfg, S, M, compute_dtype=torch.bfloat16)
            staged = PP.stage_params(params, S)
            (loss, _, g), m = counted(torch, f"{tag} bf16 S={S} M={M}", lambda: TS.value_and_grads(
                lambda p: (fn(p, batch), {}), staged), {}, device, tag="pipe")
            runs[f"{tag}_bf16"] = m
            finite = bool(torch.isfinite(loss)) and all(
                bool(torch.isfinite(v).all()) for v in flatten_with_paths(g).values())
            log(f"[pipe] {arch} bf16 S={S} M={M}: loss {float(loss):.4f} (fp32 "
                f"{res['runs'][f'S{S}_M{M}']['loss']:.4f}), loss and grads "
                f"{'finite' if finite else 'NOT FINITE'}")
            if not finite:
                raise RuntimeError(f"pipeline {arch} bf16: loss or gradients not finite")
            res["bf16"] = {"loss": float(loss), "finite": finite}
            del g, staged
            # the whole batch at fp64 compute, against each schedule at fp64
            p64 = tree_map(lambda t: t.to(torch.float64) if t.is_floating_point() else t,
                           params)
            (_, _, g64), m = counted(torch, f"{tag} fp64 plain", lambda: TS.loss_and_grads(
                p64, cfg, batch, torch.float64), {}, device, tag="pipe")
            runs[f"{tag}_fp64_plain"] = m
            want64 = flatten_with_paths(g64)
            res["fp64"] = {"plain_fp32_vs_fp64": max_leaf_rel(want, want64),
                           "plain_fp32_gaps": gap_columns(want, want64, PIPE_GRAD_REL)}
            log(f"[pipe] {arch} the whole batch at fp32 against fp64: leaves past "
                f"{PIPE_GRAD_REL:.0e} of max|g| and their (repeat, column) pairs past a tenth "
                f"of it: {res['fp64']['plain_fp32_gaps']}")
            for S, M in schedules:
                fn = PP.make_pp_loss(cfg, S, M, compute_dtype=torch.float64)
                staged = PP.stage_params(p64, S)
                (_, _, g), m = counted(torch, f"{tag} fp64 S={S} M={M}",
                                       lambda: TS.value_and_grads(
                                           lambda p: (fn(p, batch), {}), staged),
                                       {}, device, tag="pipe")
                runs[f"{tag}_fp64_S{S}_M{M}"] = m
                err = max_leaf_rel(flatten_with_paths(PP.unstage_params(g)), want64)
                res["fp64"][f"S{S}_M{M}"] = {
                    "grad_rel": err, "split_fp32_vs_fp64": max_leaf_rel(split_grads(M), want64)}
                log(f"[pipe] {arch} fp64 S={S} M={M}: max leaf err / max|g| {err:.3e} (tol "
                    f"{PIPE_GRAD_REL:.0e}) against the whole batch's loss_and_grads at fp64; "
                    f"at fp32, against that fp64 gradient: the whole batch "
                    f"{res['fp64']['plain_fp32_vs_fp64']:.3e}, lm_loss over {M} microbatches "
                    f"{res['fp64'][f'S{S}_M{M}']['split_fp32_vs_fp64']:.3e}")
                if err > PIPE_GRAD_REL:
                    raise RuntimeError(f"pipeline {arch} fp64 S={S} M={M} disagrees with the "
                                       "whole batch's gradient")
                del g, staged
            del p64, g64, want64
        for name, rec in [("plain", res["plain"]), *res["runs"].items()] if cuda else ():
            log(f"[pipe] {arch} {name}: {rec['ms'] or 0:.1f} ms warm (cold "
                f"{rec['cold_ms']:.1f}), {rec['kernels']} kernels, device busy "
                f"{rec['busy_ms'] or 0:.1f} ms, peak_mem_GB={(rec['peak_mem_bytes'] or 0) / 1e9:.3f}, "
                f"model FLOPs {rec['flops'] / 1e9:.1f} G = "
                f"{rec['fp32_peak_share'] or 0:.4f} of the fp32 peak")
        out[arch] = res
        del params, plain_g, want, split, batch
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    out["runs"] = runs
    return out


# Phase 17: mesh serving (``ServeConfig.mesh``, ``launch/mesh.py``).  The
# continuous cell's 16 requests with budgets cut to ``MESH["budget"]`` (at
# least two admission waves on 8 slots, so the prefix cache hits) and phase
# 4's 8 requests sampled at SAMPLE_T, on a 1x1 NCCL mesh and in the 2x2
# rehearsal on the one card.  The rehearsal's ranks share cuda:0 over gloo,
# every collective staged through the host: its times say what the code
# paths cost there, not what a mesh of cards would.
MESH = {"budget": 16, "pool_blocks": 26, "rehearsal": (2, 2)}
MESH_RUNS = [("dense", {}), ("paged_shadow", {"paged": True}),
             ("paged_step", {"paged": True, "paged_read": "step"})]
# 26 blocks: the data axis splits the pool (13 per rank), and 25 usable
# blocks make the 8 slots wait or preempt
MESH_REHEARSAL_RUNS = MESH_RUNS + [("paged_data_sharded_pool",
                                    {"paged": True, "pool_blocks": MESH["pool_blocks"]})]
# olmoe-1b-7b in phase 17 and 18: full width, 2 of its 16 layers, so that the
# rehearsal's four ranks (each with half the experts, and in phase 18 their
# gradients and ZeRO moments) fit on the card beside the unmeshed run (16
# layers: 27 GB of fp32 weights) and the script stays inside its 1200 s
MESH_OLMOE_REPEATS = 2
MESH_OLMOE_ONE_RUNS = [("dense", {})]           # on 1x1, with the static sampled cell
# deepseek-v2-lite in phases 17 and 18: full width, its dense prologue and 1
# of its 26 MoE layers (0.876 B parameters, 3.50 GB of fp32, about olmoe's 2
# layers), so that the rehearsal's four ranks fit beside the unmeshed run and
# the script stays inside its 1200 s.  Its MLA latent does not page, so it
# takes the static sampled cell and the dense continuous cell only, on 1x1
# and in the rehearsal (each model rank holds 288 of the latent's 576 columns)
MESH_DEEPSEEK_REPEATS = 1
MESH_DEEPSEEK_RUNS = [("dense", {})]
# an olmoe stream may part from the unmeshed one where its first divergence
# is a logits near-tie (DENSE_TIE of max|logit|; sampled: LOGIT_ATOL of the
# perturbed scores, times T) or a router near-tie: a k-th vs (k+1)-th
# router-probability gap below this at a position up to the parting step
MESH_ROUTER_TIE = 1e-5


def mesh_cells(torch, np, params, cfg, mesh, device, runs) -> dict:
    """Phase 17's cells served on ``mesh`` (None: the unmeshed engine), each
    with the launch counts reset just before and read just after: phase 4's
    requests sampled through ``serve_requests``, then the continuous cell
    ``runs`` ways -> ``{cell: {"streams", "launches", "stats", ...}}``."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Engine, ServeConfig

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def counted(eng, serve):
        sync()
        ops.reset_launches()
        t0 = time.perf_counter()
        with DropMeter() as meter:
            outs = serve(eng)
            sync()
        return {"streams": outs, "launches": dict(ops.LAUNCHES),
                "wall_s": time.perf_counter() - t0,
                "drops": meter.summary() if meter.calls else None}

    rs = np.random.RandomState(0)                  # phase 4's requests
    lens4 = rs.randint(32, 129, 8)
    reqs4 = [rs.randint(0, cfg.vocab, L).astype(np.int32) for L in lens4]
    static = ServeConfig(max_seq=int(lens4.max()) + MESH["budget"] + 8, temperature=SAMPLE_T,
                         max_new_tokens=MESH["budget"], mesh=mesh)
    eng = Engine(params, cfg, static, device=device)
    out = {"static_sampled": counted(
        eng, lambda e: e.serve_requests(reqs4, batch_size=4, seed=SAMPLE_SEED))}
    bk = eng.last_serve_stats["buckets"]
    out["static_sampled"].update(
        buckets=[(b["rows"], b["prompt_len"]) for b in bk],
        decode_ms_per_step=sum(b["decode_s"] for b in bk) * 1e3
        / sum(b["decode_steps"] for b in bk))
    reqs, budgets = mesh_requests(np, cfg.vocab)
    base = ServeConfig(max_seq=CONT["max_seq"], max_new_tokens=max(budgets),
                       block_size=CONT["block_size"], mesh=mesh)
    for name, extra in runs:
        eng = Engine(params, cfg, dataclasses.replace(base, **extra), device=device)
        out[name] = counted(eng, lambda e: e.serve_continuous(
            reqs, slots=CONT["slots"], chunk_steps=CONT["chunk_steps"], max_new=budgets))
        st = eng.last_serve_stats
        out[name].update(
            stats={k: st[k] for k in ("chunks_run", "prefill_groups", "n_preemptions",
                                      "mesh_shape")},
            prefill_tokens_saved=st.get("paged", {}).get("prefill_tokens_saved", 0),
            decode_ms_per_step=st["decode_s"] * 1e3 / (st["chunks_run"] * CONT["chunk_steps"]))
    return out


def mesh_requests(np, vocab: int):
    reqs, budgets = continuous_requests(np, vocab)
    return reqs, [min(b, MESH["budget"]) for b in budgets]


def mesh_rank(mesh, device, cfg, runs, olmoe=None, deepseek=None) -> dict:
    """One rank of phase 17's rehearsal (``launch.mesh.run_ranks``): the
    cells, and the shapes of this rank's shards; with ``olmoe = (cfg,
    runs)`` that model's cells too, with its expert shards' shapes and
    bytes; with ``deepseek = (cfg, runs)`` that model's cells, its MLA,
    expert and prologue shards' shapes and its latent cache's shape and
    bytes (:func:`mla_shard_facts`)."""
    import numpy as np
    import torch

    from repro_torch.dist.sharding import ShardingCtx
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    params = lm.init_params(cfg, seed=0, device=device, dtype=torch.float32)
    out = mesh_cells(torch, np, params, cfg, mesh, device, runs)
    eng = Engine(params, cfg, ServeConfig(max_seq=CONT["max_seq"], block_size=CONT["block_size"],
                                          mesh=mesh), device=device)
    slots, bs = CONT["slots"], CONT["block_size"]
    default_pool = slots * CONT["max_seq"] // bs + 1
    out["shapes"] = {
        "wq": tuple(eng.params["unit"][0]["attn"]["wq"].shape),
        "dense_k": tuple(eng._make_dense_caches(slots)["unit"][0]["k"].shape),
        "pool_k": tuple(eng._make_paged_caches(MESH["pool_blocks"], bs)["unit"][0]["k"].shape),
        "default_pool_k": tuple(eng._make_paged_caches(default_pool, bs)["unit"][0]["k"].shape)}
    out["coord"] = tuple(int(c) for c in mesh.get_coordinate())
    if olmoe is not None:
        ocfg, oruns = olmoe
        del params, eng
        oparams = lm.init_params(ocfg, seed=0, device=device, dtype=torch.float32)
        out["olmoe"] = mesh_cells(torch, np, oparams, ocfg, mesh, device, oruns)
        local = ShardingCtx(mesh).place_params(ocfg, oparams)["unit"][0]["moe"]
        out["olmoe"]["shapes"] = {n: tuple(w.shape) for n, w in local.items()}
        out["olmoe"]["expert_bytes"] = sum(w.numel() * w.element_size()
                                           for n, w in local.items() if n != "router")
        del oparams, local
    if deepseek is not None:
        dcfg, druns = deepseek
        dparams = lm.init_params(dcfg, seed=0, device=device, dtype=torch.float32)
        out["deepseek"] = mesh_cells(torch, np, dparams, dcfg, mesh, device, druns)
        out["deepseek"].update(mla_shard_facts(torch, dcfg, dparams, ShardingCtx(mesh)))
        del dparams
    return out


def mla_shard_facts(torch, cfg, params, shard=None) -> dict:
    """deepseek's shards on this rank (``shard``; None: whole): the unit's
    attention leaves, the routed experts' ``wi`` and the prologue's FFN
    ``wi``, the latent cache of the continuous cell's dense slots (its
    shape and the bytes of every layer's) and of phase 4's static buckets
    (4 rows)."""
    from repro_torch.models import lm

    local = params if shard is None else shard.place_params(cfg, params)
    shapes = {n: tuple(w.shape) for n, w in local["unit"][0]["attn"].items()}
    shapes["experts_wi"] = tuple(local["unit"][0]["moe"]["wi"].shape)
    shapes["prologue_wi"] = tuple(local["prologue"][0]["mlp"]["wi"].shape)
    caches = lm.init_caches(cfg, CONT["slots"], CONT["max_seq"], torch.float32, "meta", shard)
    shapes["ckv"] = tuple(caches["unit"][0]["ckv"].shape)
    static = lm.init_caches(cfg, 4, CONT["max_seq"], torch.float32, "meta", shard)
    return {"shapes": shapes, "latent_bytes": tree_bytes(caches),
            "static_latent_bytes": tree_bytes(static)}


def router_gaps(torch, np, params, cfg, seq, device):
    """``lm.forward`` of one token sequence -> ``(logits (T, vocab), the
    smallest k-th vs (k+1)-th router-probability gap of each position over
    the MoE layers)``."""
    from repro_torch.models import lm, moe

    real, gaps = moe.route, []

    def spy(params_, mcfg, xf, shard=None):
        r = real(params_, mcfg, xf, shard)
        srt = torch.sort(r[1], dim=-1, descending=True).values
        gaps.append(srt[:, mcfg.top_k - 1] - srt[:, mcfg.top_k])
        return r

    moe.route = spy
    try:
        with torch.no_grad():
            logits, _ = lm.forward(params, cfg, torch.as_tensor(seq[None], device=device))
    finally:
        moe.route = real
    return logits[0], torch.stack(gaps).amin(0)


def moe_parting(torch, np, params, cfg, prompt, stream, j, device, sampled=None) -> dict:
    """Why an olmoe stream may part from the unmeshed ``stream`` at step
    ``j``: the logits gap that predicts ``stream[j]`` (greedy: top-2 over
    max|logit|; ``sampled = (rid, seed, T)``: the perturbed scores' top-2
    gap times T) and the smallest router gap up to that position, each
    against its tie (:data:`MESH_ROUTER_TIE`)."""
    seq = np.concatenate([prompt, stream[:j]]).astype(np.int64)
    logits, rg = router_gaps(torch, np, params, cfg, seq, device)
    if sampled is None:
        top = torch.topk(logits[-1], 2).values
        gap, tie = float((top[0] - top[1]) / logits[-1].abs().max()), DENSE_TIE
    else:
        rid, seed, temp = sampled
        gap = float(sampled_gaps(torch, np, params, cfg, prompt, stream, rid, seed, temp,
                                 device)[0][j]) * temp
        tie = LOGIT_ATOL
    router = float(rg.min())
    return {"logit_gap": gap, "logit_tie": tie, "router_gap": router,
            "near_tie": gap < tie or router < MESH_ROUTER_TIE}


def mesh_expected(cfg, cell: str, r: dict, run: dict, d: int) -> dict:
    """The launches one rank's cell implies at its local shapes: dense rows
    split over the data axis (``d``), paged rows on every rank."""
    from repro_torch.core import kan_layer as KL
    from repro_torch.kernels import ops

    if cell != "static_sampled":
        rows = CONT["slots"] // d if not run.get("paged") else CONT["slots"]
        return expected_launches(cfg, r["stats"], run, slots=rows)
    per_pass = 2 * sum(b.kind == "attn_kan" for b in cfg.unit) * cfg.n_repeats
    want = dict.fromkeys(ops.LAUNCHES, 0)
    for rows, t in r["buckets"]:
        local = rows // d if rows % d == 0 else rows
        want["kan_" + KL.resolve_inference_method("cuda", local * t) + "_gemm"] += per_pass
        want["kan_" + KL.resolve_inference_method("cuda", local) + "_gemm"] += \
            per_pass * (MESH["budget"] - 1)
    return want


def mesh_path(torch, np, device="cuda", cfg=None, olmoe_cfg=None, deepseek_cfg=None) -> dict:
    """Phase 17 (see the module docstring; any miss raises).  ``device="cpu"``
    with a reduced ``cfg``, ``olmoe_cfg`` and ``deepseek_cfg`` rehearses it
    on the kernels' plain versions (gloo; every count 0)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import deepseek_v2_lite, kanformer_100m, olmoe_1b_7b
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm

    cfg = cfg or kanformer_100m.config().model
    ocfg = olmoe_cfg or olmoe_1b_7b.build(n_layers=MESH_OLMOE_REPEATS).model
    dcfg = deepseek_cfg or deepseek_v2_lite.build(n_layers=MESH_DEEPSEEK_REPEATS + 1).model
    cuda = device == "cuda"
    zeros = dict.fromkeys(ops.LAUNCHES, 0)
    params = lm.init_params(cfg, seed=0, device=device, dtype=torch.float32)
    reqs, budgets = mesh_requests(np, cfg.vocab)
    out = {"requests": len(reqs), "budget": MESH["budget"], "runs": {}}
    log(f"[mesh] {cfg.name} d={cfg.d_model} layers={cfg.n_repeats} vocab={cfg.vocab}; the "
        f"continuous cell's {len(reqs)} requests, budgets cut to {MESH['budget']}, and phase "
        f"4's 8 requests sampled at T = {SAMPLE_T} (batch 4)")

    # (a) the unmeshed engine, then a 1x1 mesh on a one-rank group; olmoe's
    # unmeshed cells are every rehearsal cell's reference (an MoE stream
    # depends on the rows routed with it, so each cell has its own)
    t0 = time.perf_counter()
    ref = mesh_cells(torch, np, params, cfg, None, device, MESH_RUNS)
    t_o = time.perf_counter()
    oparams = lm.init_params(ocfg, seed=0, device=device, dtype=torch.float32)
    oref = mesh_cells(torch, np, oparams, ocfg, None, device, MESH_REHEARSAL_RUNS)
    out["olmoe_unmeshed_s"] = time.perf_counter() - t_o
    t_o = time.perf_counter()
    dparams = lm.init_params(dcfg, seed=0, device=device, dtype=torch.float32)
    dref = mesh_cells(torch, np, dparams, dcfg, None, device, MESH_DEEPSEEK_RUNS)
    out["deepseek_unmeshed_s"] = time.perf_counter() - t_o
    tmp = tempfile.mkdtemp(prefix="mesh-")
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        one = mesh_cells(torch, np, params, cfg, M.make_host_mesh((1, 1)), device, MESH_RUNS)
        t_o = time.perf_counter()
        oone = mesh_cells(torch, np, oparams, ocfg, M.make_host_mesh((1, 1)), device,
                          MESH_OLMOE_ONE_RUNS)
        out["olmoe_1x1_s"] = time.perf_counter() - t_o
        t_o = time.perf_counter()
        done = mesh_cells(torch, np, dparams, dcfg, M.make_host_mesh((1, 1)), device,
                          MESH_DEEPSEEK_RUNS)
        out["deepseek_1x1_s"] = time.perf_counter() - t_o
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    for cell, r in one.items():
        run = dict(MESH_RUNS).get(cell, {})
        want = mesh_expected(cfg, cell, ref[cell], run, 1) if cuda else zeros
        if ref[cell]["launches"] != want:
            raise RuntimeError(f"unmeshed {cell}: launches {ref[cell]['launches']} != {want}")
        if r["launches"] != ref[cell]["launches"]:
            raise RuntimeError(f"1x1 {cell}: launches {r['launches']} != unmeshed "
                               f"{ref[cell]['launches']}")
        if not all(np.array_equal(a, b) for a, b in zip(r["streams"], ref[cell]["streams"])):
            raise RuntimeError(f"1x1 {cell}: streams differ from the unmeshed engine's")
        if cell != "static_sampled" and r["stats"]["mesh_shape"] != {"data": 1, "model": 1}:
            raise RuntimeError(f"1x1 {cell}: mesh_shape {r['stats']['mesh_shape']}")
        if cell == "paged_shadow" and r["prefill_tokens_saved"] <= 0:
            raise RuntimeError("1x1 paged_shadow: no prefix hit")
        out["runs"]["1x1_" + cell] = {"launches": r["launches"],
                                      "decode_ms_per_step": r["decode_ms_per_step"]}
        log(f"[mesh] 1x1 {'NCCL' if cuda else 'gloo'} {cell}: streams bit-equal to the "
            f"unmeshed engine's, launches {r['launches']} equal; {r['decode_ms_per_step']:.3f} "
            f"ms per decode step (unmeshed {ref[cell]['decode_ms_per_step']:.3f})")
    moe = ocfg.unit[0].moe
    olog = (f"olmoe-1b-7b d={ocfg.d_model} layers={ocfg.n_repeats} of 16 experts="
            f"{moe.n_experts} top-{moe.top_k}")
    dmoe, da = dcfg.unit[0].moe, dcfg.unit[0].attn
    dlog = (f"deepseek-v2-lite d={dcfg.d_model} layers={dcfg.n_layers} (the dense prologue and "
            f"{dcfg.n_repeats} of 26 MoE layers) MLA kv_lora {da.kv_lora_rank} + rope "
            f"{da.qk_rope_dim}, experts={dmoe.n_experts} top-{dmoe.top_k}")
    for key, mlog, mone, mref in (("olmoe", olog, oone, oref), ("deepseek", dlog, done, dref)):
        out[key] = {"layers": (ocfg if key == "olmoe" else dcfg).n_repeats, "runs": {}}
        for cell, r in mone.items():
            want = mref[cell]
            if r["launches"] != want["launches"] or want["launches"] != zeros:
                raise RuntimeError(f"{key} 1x1 {cell}: launches {r['launches']} vs unmeshed "
                                   f"{want['launches']} (none expected)")
            if not all(np.array_equal(a, b) for a, b in zip(r["streams"], want["streams"])):
                raise RuntimeError(f"{key} 1x1 {cell}: streams differ from the unmeshed "
                                   "engine's")
            if r["drops"] != want["drops"]:
                raise RuntimeError(f"{key} 1x1 {cell}: drops {r['drops']} vs {want['drops']}")
            out[key]["runs"]["1x1_" + cell] = {"launches": r["launches"],
                                               "decode_ms_per_step": r["decode_ms_per_step"],
                                               "drops": r["drops"]}
            log(f"[mesh] {mlog}: 1x1 {'NCCL' if cuda else 'gloo'} {cell}: streams bit-equal to "
                f"the unmeshed engine's, launches equal (none), moe_drop_frac "
                f"{r['drops']['moe_drop_frac']:.4f} equal; {r['decode_ms_per_step']:.3f} ms per "
                f"decode step (unmeshed {want['decode_ms_per_step']:.3f})")
    out["1x1_s"] = time.perf_counter() - t0

    # (b) the 2x2 rehearsal: four ranks on this one card (gloo), kanformer's
    # cells then olmoe's in one spawn
    d, m = MESH["rehearsal"]
    t1 = time.perf_counter()
    ranks = M.run_ranks(mesh_rank, (d, m), device, share_card=cuda,
                        args=(cfg, MESH_REHEARSAL_RUNS, (ocfg, MESH_REHEARSAL_RUNS),
                              (dcfg, MESH_DEEPSEEK_RUNS)))
    out["rehearsal_s"] = time.perf_counter() - t1
    a, hd = cfg.unit[0].attn, cfg.unit[0].attn.head_dim
    L, bs = cfg.n_repeats, CONT["block_size"]
    shapes = {"wq": (L, cfg.d_model, a.n_heads // m, hd),
              "dense_k": (L, CONT["slots"] // d, CONT["max_seq"], a.n_kv_heads // m, hd),
              "pool_k": (L, MESH["pool_blocks"] // d, bs, a.n_kv_heads // m, hd),
              "default_pool_k": (L, CONT["slots"] * CONT["max_seq"] // bs + 1, bs,
                                 a.n_kv_heads // m, hd)}
    gaps = {}

    def parting(cell: str, i: int, j: int) -> float:
        """The gap that lets stream ``i`` of ``cell`` part from the unmeshed
        one at step ``j``: greedy, the top-2 logit gap; sampled, the top-2
        gap of the perturbed scores, scaled back by T."""
        key = ("static" if cell == "static_sampled" else "cont", i)
        if key not in gaps:
            if cell == "static_sampled":
                rs = np.random.RandomState(0)
                lens4 = rs.randint(32, 129, 8)
                reqs4 = [rs.randint(0, cfg.vocab, n).astype(np.int32) for n in lens4]
                gaps[key] = sampled_gaps(torch, np, params, cfg, reqs4[i],
                                         ref[cell]["streams"][i], i, SAMPLE_SEED, SAMPLE_T,
                                         device)[0] * SAMPLE_T
            else:
                gaps[key] = stream_gaps(torch, np, params, cfg, reqs[i],
                                        ref["dense"]["streams"][i], device)
        return float(gaps[key][j])

    partings = []
    for r in ranks:
        if r["shapes"] != shapes:
            raise RuntimeError(f"rank {r['coord']}: shard shapes {r['shapes']} != {shapes}")
        for cell, run in [("static_sampled", {})] + MESH_REHEARSAL_RUNS:
            got = r[cell]
            want = mesh_expected(cfg, cell, got, run, d) if cuda else zeros
            if got["launches"] != want:
                raise RuntimeError(f"2x2 rank {r['coord']} {cell}: launches {got['launches']} "
                                   f"!= {want}")
            base = ref[cell if cell == "static_sampled" else "dense"]["streams"]
            for i, (g, w) in enumerate(zip(got["streams"], base)):
                diff = np.nonzero(g != w)[0]
                if diff.size:
                    j = int(diff[0])
                    gap = parting(cell, i, j)
                    partings.append({"rank": r["coord"], "cell": cell, "request": i,
                                     "step": j, "gap": gap})
                    if gap >= LOGIT_ATOL:
                        raise RuntimeError(f"2x2 rank {r['coord']} {cell}: request {i} parts "
                                           f"at step {j}, gap {gap:.3e}: not a near-tie")
            if not all(np.array_equal(x, y) for x, y in zip(got["streams"],
                                                            ranks[0][cell]["streams"])):
                raise RuntimeError(f"2x2 {cell}: rank {r['coord']} serves other streams "
                                   "than rank 0")
    r0 = ranks[0]
    for cell, _ in [("static_sampled", {})] + MESH_REHEARSAL_RUNS:
        out["runs"]["2x2_" + cell] = {"launches": r0[cell]["launches"],
                                      "decode_ms_per_step": r0[cell]["decode_ms_per_step"],
                                      "n_preemptions": r0[cell].get("stats", {}).get(
                                          "n_preemptions")}
        log(f"[mesh] 2x2 rehearsal {cell}: every rank's launches exact at its local shapes "
            f"(rank 0 {r0[cell]['launches']}); {r0[cell]['decode_ms_per_step']:.3f} ms per "
            f"decode step")
    out["partings"] = partings
    out["shapes"] = {k: list(v) for k, v in shapes.items()}
    out["decode_ms_per_step"] = {"unmeshed": ref["dense"]["decode_ms_per_step"],
                                 "1x1": one["dense"]["decode_ms_per_step"],
                                 "2x2_rehearsal": r0["dense"]["decode_ms_per_step"]}
    where = card_line() if cuda else "the CPU (plain versions)"
    log(f"[mesh] shard shapes per rank {shapes}; streams parted at {len(partings)} near-ties "
        f"(gap < {LOGIT_ATOL:.0e})")
    log(f"[mesh] ms per dense decode step: unmeshed {out['decode_ms_per_step']['unmeshed']:.3f}, "
        f"1x1 mesh {out['decode_ms_per_step']['1x1']:.3f}, 2x2 REHEARSAL (4 ranks on one card, "
        f"collectives staged through the host over gloo; not a scale-out figure) "
        f"{out['decode_ms_per_step']['2x2_rehearsal']:.3f}; on {where}")
    rehearsed = mesh_olmoe_rehearsal(torch, np, ranks, oref, oparams, ocfg, device)
    out["olmoe"]["runs"].update(rehearsed.pop("runs"))          # beside the 1x1 runs
    out["olmoe"].update(rehearsed)
    ms = out["olmoe"]["decode_ms_per_step"]
    ms["1x1"] = oone["dense"]["decode_ms_per_step"]
    log(f"[mesh] olmoe-1b-7b ms per dense decode step: unmeshed {ms['unmeshed']:.3f}, 1x1 mesh "
        f"{ms['1x1']:.3f}, 2x2 REHEARSAL (not a scale-out figure) {ms['2x2_rehearsal']:.3f}; on "
        f"{card_line() if cuda else 'the CPU (plain versions)'}")
    del oparams
    rehearsed = mesh_deepseek_rehearsal(torch, np, ranks, dref, dparams, dcfg, device)
    out["deepseek"]["runs"].update(rehearsed.pop("runs"))
    out["deepseek"].update(rehearsed)
    ms = out["deepseek"]["decode_ms_per_step"]
    ms["1x1"] = done["dense"]["decode_ms_per_step"]
    log(f"[mesh] deepseek-v2-lite ms per dense decode step: unmeshed {ms['unmeshed']:.3f}, 1x1 "
        f"mesh {ms['1x1']:.3f}, 2x2 REHEARSAL (not a scale-out figure) "
        f"{ms['2x2_rehearsal']:.3f}; on {card_line() if cuda else 'the CPU (plain versions)'}")
    log(f"[mesh] 1x1 cells {out['1x1_s']:.1f} s (olmoe's unmeshed cells "
        f"{out['olmoe_unmeshed_s']:.1f} s, its 1x1 cells {out['olmoe_1x1_s']:.1f} s; "
        f"deepseek's {out['deepseek_unmeshed_s']:.1f} s and {out['deepseek_1x1_s']:.1f} s), 2x2 "
        f"rehearsal {out['rehearsal_s']:.1f} s (three models, one spawn)")
    return out


def mesh_olmoe_rehearsal(torch, np, ranks, oref, oparams, ocfg, device) -> dict:
    """Phase 17's olmoe checks on the rehearsal's ranks (any miss raises):
    expert shard shapes, then :func:`held_moe_cells`."""
    d, m = MESH["rehearsal"]
    moe = ocfg.unit[0].moe
    E, dm, f, L = moe.n_experts, ocfg.d_model, moe.d_ff, ocfg.n_repeats
    shapes = {"router": (L, dm, E // m), "wi": (L, E // m, dm, f), "wg": (L, E // m, dm, f),
              "wo": (L, E // m, f, dm)}
    expert_bytes = 3 * L * (E // m) * dm * f * 4
    for r in ranks:
        got = r["olmoe"]
        if got["shapes"] != shapes or got["expert_bytes"] != expert_bytes:
            raise RuntimeError(f"olmoe 2x2 rank {r['coord']}: expert shards {got['shapes']} "
                               f"({got['expert_bytes']} B) != {shapes} ({expert_bytes} B)")
    out = held_moe_cells(torch, np, ranks, "olmoe", oref, oparams, ocfg, device,
                         [("static_sampled", {})] + MESH_REHEARSAL_RUNS)
    out["shapes"] = {k: list(v) for k, v in shapes.items()}
    out["expert_bytes_per_rank"] = expert_bytes
    out["expert_bytes_unmeshed"] = expert_bytes * m
    where = card_line() if device == "cuda" else "the CPU (plain versions)"
    log(f"[mesh] olmoe-1b-7b d={ocfg.d_model} layers={L}: expert shards per rank {shapes}; "
        f"each rank reads {expert_bytes / 1e9:.3f} GB of expert weights per decode step "
        f"(every local expert runs its cap slots) against {expert_bytes * m / 1e9:.3f} GB "
        f"unmeshed; streams parted at {len(out['partings'])} near-ties; ms per dense decode "
        f"step unmeshed {out['decode_ms_per_step']['unmeshed']:.3f}, 2x2 REHEARSAL (not a "
        f"scale-out figure) {out['decode_ms_per_step']['2x2_rehearsal']:.3f}; on {where}")
    return out


def mesh_deepseek_rehearsal(torch, np, ranks, dref, dparams, dcfg, device) -> dict:
    """Phase 17's deepseek checks on the rehearsal's ranks (any miss
    raises): each rank's shards the reference's placement (heads and the
    latent's 576 columns halved, rows over data, half the experts, half the
    prologue's FFN) and its latent cache a quarter of the unmeshed one's
    bytes, then :func:`held_moe_cells`."""
    d, m = MESH["rehearsal"]
    a, L, dm = dcfg.unit[0].attn, dcfg.n_repeats, dcfg.d_model
    H, hd, r_, rope = a.n_heads, a.head_dim, a.kv_lora_rank, a.qk_rope_dim
    moe = dcfg.unit[0].moe
    shapes = {"wq": (L, dm, H // m, hd + rope), "w_dkv": (L, dm, (r_ + rope) // m),
              "w_uk": (L, r_, H // m, hd), "w_uv": (L, r_, H // m, hd),
              "wo": (L, H // m, hd, dm), "kv_norm": (L, r_ // m),
              "experts_wi": (L, moe.n_experts // m, dm, moe.d_ff),
              "prologue_wi": (dm, dcfg.prologue[0].d_ff // m),
              "ckv": (L, CONT["slots"] // d, CONT["max_seq"], (r_ + rope) // m)}
    whole = mla_shard_facts(torch, dcfg, dparams)
    for r in ranks:
        got = r["deepseek"]
        if got["shapes"] != shapes:
            raise RuntimeError(f"deepseek 2x2 rank {r['coord']}: shards {got['shapes']} != "
                               f"{shapes}")
        if 4 * got["latent_bytes"] != whole["latent_bytes"] or \
                4 * got["static_latent_bytes"] != whole["static_latent_bytes"]:
            raise RuntimeError(f"deepseek 2x2 rank {r['coord']}: latent bytes "
                               f"{got['latent_bytes']} / {got['static_latent_bytes']} are not a "
                               f"quarter of {whole['latent_bytes']} / "
                               f"{whole['static_latent_bytes']}")
    out = held_moe_cells(torch, np, ranks, "deepseek", dref, dparams, dcfg, device,
                         [("static_sampled", {})] + MESH_DEEPSEEK_RUNS)
    got = ranks[0]["deepseek"]
    out["shapes"] = {k: list(v) for k, v in shapes.items()}
    out["latent_bytes_per_rank"] = got["latent_bytes"]
    out["latent_bytes_unmeshed"] = whole["latent_bytes"]
    where = card_line() if device == "cuda" else "the CPU (plain versions)"
    log(f"[mesh] deepseek-v2-lite d={dm} layers={dcfg.n_layers}: shards per rank {shapes}; "
        f"latent cache per rank {got['latent_bytes'] / 1e6:.3f} MB of the continuous cell's "
        f"{CONT['slots']} slots x {CONT['max_seq']} ({got['static_latent_bytes'] / 1e6:.3f} MB "
        f"of a static bucket of 4) against {whole['latent_bytes'] / 1e6:.3f} MB "
        f"({whole['static_latent_bytes'] / 1e6:.3f} MB) unmeshed: "
        f"{got['latent_bytes'] / whole['latent_bytes']:.4f}; streams parted at "
        f"{len(out['partings'])} near-ties; ms per dense decode step unmeshed "
        f"{out['decode_ms_per_step']['unmeshed']:.3f}, 2x2 REHEARSAL (not a scale-out figure) "
        f"{out['decode_ms_per_step']['2x2_rehearsal']:.3f}; on {where}")
    return out


def held_moe_cells(torch, np, ranks, key, mref, mparams, mcfg, device, cells) -> dict:
    """An MoE model's rehearsal cells (``ranks[i][key]``; any miss
    raises): launches exact at local shapes, drop fractions equal on every
    rank, every rank's streams equal to rank 0's and to the unmeshed cell's
    unless the first divergence is a near-tie (:func:`moe_parting`)."""
    from repro_torch.kernels import ops

    cuda = device == "cuda"
    d, m = MESH["rehearsal"]
    zeros = dict.fromkeys(ops.LAUNCHES, 0)
    rs = np.random.RandomState(0)                  # phase 4's requests
    lens4 = rs.randint(32, 129, 8)
    reqs4 = [rs.randint(0, mcfg.vocab, n).astype(np.int32) for n in lens4]
    reqs, _ = mesh_requests(np, mcfg.vocab)
    partings, out = [], {"runs": {}}
    for r in ranks:
        got = r[key]
        tag = f"{key} 2x2 rank {r['coord']}"
        for cell, run in cells:
            c = got[cell]
            want = mesh_expected(mcfg, cell, c, run, d) if cuda else zeros
            if c["launches"] != want:
                raise RuntimeError(f"{tag} {cell}: launches {c['launches']} != {want}")
            if c["drops"] != ranks[0][key][cell]["drops"]:
                raise RuntimeError(f"{tag} {cell}: drops {c['drops']} differ from rank 0's "
                                   f"{ranks[0][key][cell]['drops']}")
            if not all(np.array_equal(x, y) for x, y in zip(
                    c["streams"], ranks[0][key][cell]["streams"])):
                raise RuntimeError(f"{tag} {cell}: other streams than rank 0")
    r0 = ranks[0][key]
    for cell, run in cells:
        static = cell == "static_sampled"
        for i, (g, w) in enumerate(zip(r0[cell]["streams"], mref[cell]["streams"])):
            diff = np.nonzero(g != w)[0]
            if not diff.size:
                continue
            j = int(diff[0])
            why = moe_parting(torch, np, mparams, mcfg, reqs4[i] if static else reqs[i], w, j,
                              device, (i, SAMPLE_SEED, SAMPLE_T) if static else None)
            partings.append({"cell": cell, "request": i, "step": j, **why})
            log(f"[mesh] {key} 2x2 {cell}: request {i} parts at step {j}: logits gap "
                f"{why['logit_gap']:.3e} (tie {why['logit_tie']:.0e}), smallest k-th vs "
                f"(k+1)-th router-probability gap {why['router_gap']:.3e} (tie "
                f"{MESH_ROUTER_TIE:.0e})")
            if not why["near_tie"]:
                raise RuntimeError(f"{key} 2x2 {cell}: request {i} parts at step {j}, not a "
                                   "near-tie of the logits or the router")
        out["runs"]["2x2_" + cell] = {"launches": r0[cell]["launches"],
                                      "decode_ms_per_step": r0[cell]["decode_ms_per_step"],
                                      "drops": r0[cell]["drops"],
                                      "n_preemptions": r0[cell].get("stats", {}).get(
                                          "n_preemptions")}
        log(f"[mesh] {key} 2x2 rehearsal {cell}: every rank's launches exact at its local "
            f"shapes (rank 0 { {k: v for k, v in r0[cell]['launches'].items() if v} }), "
            f"moe_drop_frac {r0[cell]['drops']['moe_drop_frac']:.4f} on every rank (unmeshed "
            f"{mref[cell]['drops']['moe_drop_frac']:.4f}); {r0[cell]['decode_ms_per_step']:.3f} "
            f"ms per decode step (unmeshed {mref[cell]['decode_ms_per_step']:.3f})")
    out["partings"] = partings
    out["decode_ms_per_step"] = {"unmeshed": mref["dense"]["decode_ms_per_step"],
                                 "2x2_rehearsal": r0["dense"]["decode_ms_per_step"]}
    return out


# Phase 18: training on a mesh.  The launcher's recipe (phase 13's batch and
# lr) on kanformer-100m at full width and depth, unmeshed and on a 1x1 NCCL
# mesh; the 2x2 rehearsal (four ranks sharing the card over gloo) trains
# kanformer-100m at full width and depth and qwen1.5-0.5b at full width and
# QWEN_REPEATS of its 24 layers from seed 0, held to the unmeshed step on the
# same weights and batches; the rehearsal's
# kanformer checkpoint continues on 1x1.  At fp32 a data split is a split
# into microbatches and a model split changes the GEMMs' shapes, so sums move
# by fp32 roundings (PR 27: two columns of kanformer's KAN FFN jump by 1.566e-3
# of max|g| between batch splits), and Adam normalises each element's step,
# so an element whose gradient is near zero can move by another fraction of
# lr: the losses within MESH_LOSS_RTOL, MESH_BULK of the parameters within
# 1e-3 lr (a wrong gradient moves most of them by O(lr)), and every one within
# MESH_MAX_LR lr per step (two Adam steps part by at most ~4 lr).  qwen
# takes 2 steps to keep the phase near 60 s.
MESH_TRAIN = {"steps": 4, "batch": 8, "seq": 64, "lr": 2e-3, "rehearsal": (2, 2),
              # the rehearsal's models, the largest per rank first: deepseek's four
              # ranks peaked at 9.70 GB each when it ran first and at 13.34 GB after
              # the other three (H100 80GB HBM3), with 55.3 GB of the card free
              "rehearsal_steps": {"deepseek-v2-lite": 2, "olmoe-1b-7b": 2,
                                  "kanformer-100m": 3, "qwen1.5-0.5b": 2},
              "ckpt_at": 2, "olmoe_steps": 2}
# kanformer's step variants in the rehearsal, one step each from seed 0, held
# to the same step unmeshed: the int8 wire format (its scale's all_reduce MAX
# over model, gloo on CUDA tensors) and bf16 parameters under ZeRO (an fp32
# master copy ZeRO-split over data, the bf16 wire format)
MESH_TRAIN_VARIANTS = {"int8": {"grad_compression": "int8"},
                       "bf16": {"param_dtype": "bfloat16", "master_weights": True,
                                "grad_compression": "bf16"}}
MESH_LOSS_RTOL = 1e-5
MESH_BULK = (0.999, 1e-3)               # this share of the parameters within this, x lr
# bf16 parameters have bf16 gradients, and a data rank's half of a gradient is
# rounded to bf16 before the halves are summed: where the halves cancel to
# within a bf16 ulp (~1% of kanformer's elements in the CPU rehearsal, 1.1e-2),
# the sum keeps neither its sign nor its size, and Adam moves that element by
# up to 2 lr.  So the fp32 master of the bf16 variant is held to this bulk
# (and MESH_MAX_LR), its bf16 parameters to being the master's rounding
MESH_BF16_BULK = (0.97, 1e-3)
MESH_MAX_LR = 4.0                       # per step, x lr


def mesh_opt(steps: int):
    """AdamW as ``launch.train`` sets it for a run of ``steps``."""
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(lr=MESH_TRAIN["lr"], total_steps=steps,
                             warmup_steps=min(20, steps // 10 + 1))


def param_gaps(got: dict, want: dict, lr: float) -> dict:
    """``{path: tensor}`` trees -> the largest gap and the share of the
    elements within ``MESH_BULK[1]``, both in units of ``lr``."""
    worst, near, n = 0.0, 0, 0
    for k, g in got.items():
        d = (g.detach().cpu().double() - want[k].double()).abs() / lr
        worst = max(worst, float(d.max()))
        near += int((d <= MESH_BULK[1]).sum())
        n += d.numel()
    return {"max_lr": worst, "bulk_share": near / n}


def held_params(tag: str, gaps: dict, steps: int, bulk=MESH_BULK) -> None:
    if gaps["bulk_share"] < bulk[0] or gaps["max_lr"] > MESH_MAX_LR * steps:
        raise RuntimeError(f"{tag}: parameters {gaps} past {bulk} / "
                           f"{MESH_MAX_LR * steps} lr")


def variant_step(torch, cfg, name: str, shard, device):
    """One step of :data:`MESH_TRAIN_VARIANTS` ``[name]`` from seed 0 on
    batch 0 (``shard``: this rank's shards) -> ``(loss, params, state,
    launches)``."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS

    kw = dict(MESH_TRAIN_VARIANTS[name])
    dtype = getattr(torch, kw.pop("param_dtype", "float32"))
    master = kw.pop("master_weights", False)
    params = lm.init_params(cfg, seed=0, device=device, dtype=dtype)
    if shard is not None:
        params = shard.place_params(cfg, params)
    state = adamw.init_state(params, master, shard=None if shard is None else shard.for_model(cfg))
    fn = TS.make_train_step(cfg, dataclasses.replace(mesh_opt(1), master_weights=master),
                            shard=shard, **kw)
    batch = T.make_batch(cfg, T.dp.LMDataConfig(cfg.vocab, MESH_TRAIN["seq"], MESH_TRAIN["batch"]),
                         0, device)
    ops.reset_launches()
    params, state, m = fn(params, state, batch)
    return float(m["loss"]), params, state, dict(ops.LAUNCHES)


def mesh_train_rank(mesh, device, runs, ref_dir, ckpt_dir, variants=None) -> dict:
    """One rank of phase 18's rehearsal (``launch.mesh.run_ranks``): each
    model of ``runs`` trained on the mesh from seed 0 with the launcher's
    recipe, its launches counted (none), its losses and host ms per step,
    its ZeRO shapes and optimizer bytes, and its parameters held to the
    slices of the unmeshed run's (read from ``ref_dir``); kanformer's state
    saved at ``MESH_TRAIN["ckpt_at"]``."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import store
    from repro_torch.convert import flatten_with_paths
    from repro_torch.dist.sharding import ShardingCtx
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS

    cuda = torch.device(device).type == "cuda"
    shard = ShardingCtx(mesh)
    out = {"coord": tuple(int(c) for c in mesh.get_coordinate())}
    for arch, cfg, steps in runs:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            free_at_start = torch.cuda.mem_get_info()[0]
        params = shard.place_params(cfg, lm.init_params(cfg, seed=0, device=device))
        state = adamw.init_state(params, shard=shard.for_model(cfg))
        step = TS.make_train_step(cfg, mesh_opt(steps), shard=shard)
        data = T.dp.LMDataConfig(cfg.vocab, MESH_TRAIN["seq"], MESH_TRAIN["batch"])
        if cuda:
            torch.cuda.synchronize()
        ops.reset_launches()
        losses, ms = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            params, state, m = step(params, state, T.make_batch(cfg, data, i, device))
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            if arch == "kanformer-100m" and i + 1 == MESH_TRAIN["ckpt_at"]:
                store.save(ckpt_dir, i + 1, (params, state), shard=shard,
                           specs=shard.state_specs(cfg, state))
        launches = dict(ops.LAUNCHES)
        ref = torch.load(os.path.join(ref_dir, f"{arch}.pt"), mmap=True)
        placed = store.spec_paths(params, shard.param_shardings(cfg))
        local = flatten_with_paths(params)
        gaps = param_gaps(local, {k: shard.local_slice(ref[k], placed[k])
                                         for k in local}, MESH_TRAIN["lr"])
        moments = [(k, t) for n in ("m", "v") for k, t in flatten_with_paths(state[n]).items()]
        out[arch] = {"losses": losses, "ms": ms, "launches": launches, "gaps": gaps,
                     "zero_shapes": {k: tuple(v.shape)
                                     for k, v in flatten_with_paths(state["m"]).items()},
                     "opt_bytes": sum(t.numel() * t.element_size() for _, t in moments),
                     "expert_opt_bytes": sum(t.numel() * t.element_size() for k, t in moments
                                             if is_expert_leaf(k)),
                     "finite": bool(np.isfinite(losses).all()),
                     "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None,
                     "card_free_at_start": free_at_start if cuda else None}
        del params, state, ref, local, step, m
        if cuda:
            gc.collect()
            torch.cuda.empty_cache()
    for name, cfg in variants or ():
        loss, params, state, launches = variant_step(torch, cfg, name, shard, device)
        ref = torch.load(os.path.join(ref_dir, f"variant-{name}.pt"), mmap=True)
        placed = store.spec_paths(params, shard.param_shardings(cfg))
        local = flatten_with_paths(params)
        res = {"loss": loss, "launches": launches, "gaps": param_gaps(
            local, {k: shard.local_slice(ref["params"][k], placed[k]) for k in local},
            MESH_TRAIN["lr"])}
        if "master" in state:            # the ZeRO slices of the fp32 master copy
            zero = store.spec_paths(params, shard.opt_state_specs(cfg, True)["master"])
            master = flatten_with_paths(state["master"])
            res["master_gaps"] = param_gaps(master, {k: shard.local_slice(
                ref["master"][k], zero[k]) for k in master}, MESH_TRAIN["lr"])
            plan = shard.for_model(cfg).leaf_plan
            res["params_round_master"] = all(torch.equal(
                shard.zero_slice(local[k], plan[k][1]), master[k].to(local[k].dtype))
                for k in master)
        out["variant_" + name] = res
        del params, state, ref, local
    return out


def is_expert_leaf(path: str) -> bool:
    """A routed expert's weight (``wi``/``wg``/``wo`` of an MoE block)."""
    return "['moe']" in path and path.rsplit("/", 1)[-1] in ("['wi']", "['wg']", "['wo']")


def mesh_train_path(torch, np, device="cuda", reduced=False) -> dict:
    """Phase 18 (see the module docstring; any miss raises).  ``device="cpu"``
    with ``reduced`` rehearses it on the CPU (gloo; no profile)."""
    import shutil
    import statistics
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.checkpoint import store
    from repro_torch.configs import deepseek_v2_lite, olmoe_1b_7b, qwen1_5_0_5b
    from repro_torch.convert import flatten_with_paths, tree_map
    from repro_torch.dist.sharding import ShardingCtx, tree_zero_specs
    from repro_torch.launch import elastic
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train import step as TS

    cuda = device == "cuda"
    get = configs.get_reduced if reduced else configs.get_config
    arch, B, S, lr = "kanformer-100m", MESH_TRAIN["batch"], MESH_TRAIN["seq"], MESH_TRAIN["lr"]
    kan = get(arch).model
    flags = ["--arch", arch, "--batch", str(B), "--seq", str(S), "--lr", str(lr), "--steps",
             str(MESH_TRAIN["steps"]), "--device", device, "--log-every", "1000"]
    flags += ["--reduced"] if reduced else []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_train_")
    out, runs = {"runs": {}}, {}
    where = card_line() if cuda else "the CPU (plain versions)"

    def one_rank_group():
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"file://{tmp}/store{len(os.listdir(tmp))}",
                                rank=0, world_size=1)
        return ShardingCtx(M.make_host_mesh((1, 1)))

    def median_ms(step_s) -> float:
        return statistics.median(step_s[1:]) * 1e3

    threads = torch.get_num_threads()
    if not cuda:           # the CPU's index_put_ sums in another order on many threads
        torch.set_num_threads(1)
    try:
        # (a) the launcher's recipe unmeshed, then on a 1x1 mesh
        t0 = time.perf_counter()
        plain, runs["unmeshed"] = counted(torch, f"{arch} unmeshed", lambda: T.run(flags), {},
                                          device, tag="meshtrain")
        shard1 = one_rank_group()
        try:
            one, runs["1x1"] = counted(torch, f"{arch} 1x1", lambda: T.run(flags), {}, device,
                                       tag="meshtrain")
            batch = T.make_batch(kan, T.dp.LMDataConfig(kan.vocab, S, B), 0, device)
            per_step = {}
            if cuda:                       # one more step each, on copies
                for tag, sh, res in (("unmeshed", None, plain), ("1x1", shard1, one)):
                    fn = TS.make_train_step(kan, mesh_opt(MESH_TRAIN["steps"]), shard=sh)
                    p_, s_ = tree_map(torch.clone, (res["params"], res["opt_state"]))
                    per_step[tag] = kernels_per_call(torch, lambda: fn(p_, s_, batch))
                    del p_, s_
        finally:
            dist.destroy_process_group()
        a = flatten_with_paths((plain["params"], plain["opt_state"]))
        b = flatten_with_paths((one["params"], one["opt_state"]))
        if one["losses"] != plain["losses"] or runs["1x1"]["launches"] != \
                runs["unmeshed"]["launches"]:
            raise RuntimeError(f"1x1 mesh training: losses {one['losses']} vs {plain['losses']}"
                               f", launches {runs['1x1']['launches']}")
        same = all(torch.equal(a[k], b[k]) for k in a)
        if not same:
            raise RuntimeError("1x1 mesh training: parameters or AdamW state differ from the "
                               "unmeshed run's")
        out["1x1"] = {"losses": one["losses"], "ms_per_step": median_ms(one["step_s"]),
                      "unmeshed_ms_per_step": median_ms(plain["step_s"]),
                      "kernels_per_step": per_step}
        log(f"[meshtrain] {arch} d={kan.d_model} layers={kan.n_repeats}: "
            f"{MESH_TRAIN['steps']} launcher steps of batch {B} x {S} on a 1x1 "
            f"{'NCCL' if cuda else 'gloo'} mesh: losses {one['losses']} bit-equal to the "
            f"unmeshed run's, parameters and m/v bit-equal, launches "
            f"{ {k: v for k, v in runs['1x1']['launches'].items() if v} } (none) equal; "
            f"{out['1x1']['ms_per_step']:.3f} ms per step (median of the warm steps; "
            f"unmeshed {out['1x1']['unmeshed_ms_per_step']:.3f}); kernels per step "
            f"{ {k: v['kernels'] for k, v in per_step.items()} }; on {where}")

        # the mesh-trained weights served through kernels 1 and 2
        rs = np.random.RandomState(0)
        lens = rs.randint(32, 129, 8)
        reqs = [rs.randint(0, kan.vocab, n).astype(np.int32) for n in lens]
        new = 32
        served = {}
        for tag, res in (("unmeshed", plain), ("1x1", one)):
            eng = Engine(res["params"], kan, ServeConfig(max_seq=int(lens.max()) + new + 8,
                                                         max_new_tokens=new), device=device)

            def want(eng=eng):
                nb = len(eng.last_serve_stats["buckets"])
                return {"kan_fused_gemm": nb * 2 * kan.n_repeats,
                        "kan_sparse_gemm": nb * (new - 1) * 2 * kan.n_repeats}

            served[tag], runs[f"served_{tag}"] = counted(
                torch, f"{tag}-trained {arch} static", lambda eng=eng: eng.serve_requests(
                    reqs, batch_size=4, seed=0), want, device, tag="meshtrain")
        if not all(np.array_equal(x, y) for x, y in zip(served["1x1"], served["unmeshed"])):
            raise RuntimeError("the 1x1-trained weights serve other streams than the unmeshed")
        log(f"[meshtrain] the 1x1-trained weights serve phase 4's {len(reqs)} requests "
            f"statically with the unmeshed-trained weights' streams, launches "
            f"{ {k: v for k, v in runs['served_1x1']['launches'].items() if v} }")
        del plain, one, a, b
        out["1x1_s"] = time.perf_counter() - t0

        # olmoe-1b-7b at full width, MESH_OLMOE_REPEATS layers: unmeshed and on 1x1
        t_o = time.perf_counter()
        ocfg = (get("olmoe-1b-7b") if reduced
                else olmoe_1b_7b.build(n_layers=MESH_OLMOE_REPEATS)).model
        out["olmoe_1x1"] = olmoe_one_by_one(torch, np, ocfg, device, one_rank_group)
        out["olmoe_1x1_s"] = time.perf_counter() - t_o
        # deepseek-v2-lite (MLA) at full width, its prologue and MESH_DEEPSEEK_REPEATS layers
        t_o = time.perf_counter()
        dcfg = (get("deepseek-v2-lite") if reduced
                else deepseek_v2_lite.build(n_layers=MESH_DEEPSEEK_REPEATS + 1)).model
        out["deepseek_1x1"] = olmoe_one_by_one(torch, np, dcfg, device, one_rank_group)
        out["deepseek_1x1_s"] = time.perf_counter() - t_o

        # (b) the unmeshed references, then the 2x2 rehearsal
        t1 = time.perf_counter()
        ref_dir = os.path.join(tmp, "ref")
        os.makedirs(ref_dir)
        ckpt = os.path.join(tmp, "ckpt")
        cut = {"qwen1.5-0.5b": lambda: qwen1_5_0_5b.build(n_layers=QWEN_REPEATS),
               "olmoe-1b-7b": lambda: olmoe_1b_7b.build(n_layers=MESH_OLMOE_REPEATS),
               "deepseek-v2-lite": lambda: deepseek_v2_lite.build(
                   n_layers=MESH_DEEPSEEK_REPEATS + 1)}
        rehearsal = [(name, (cut[name]() if name in cut and not reduced else get(name)).model, n)
                     for name, n in MESH_TRAIN["rehearsal_steps"].items()]
        refs = {}
        for name, cfg, n in rehearsal:
            params = lm.init_params(cfg, seed=0, device=device)
            state, fn = adamw.init_state(params), TS.make_train_step(cfg, mesh_opt(n))
            data = T.dp.LMDataConfig(cfg.vocab, S, B)
            losses, ms = [], []
            for i in range(n):
                t = time.perf_counter()
                params, state, m = fn(params, state, T.make_batch(cfg, data, i, device))
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t) * 1e3)
            torch.save({k: v.cpu() for k, v in flatten_with_paths(params).items()},
                       os.path.join(ref_dir, f"{name}.pt"))
            refs[name] = {"losses": losses, "ms": ms,
                          "opt_bytes": sum(t.numel() * t.element_size() for k in ("m", "v")
                                           for t in flatten_with_paths(state[k]).values())}
            del params, state
            if cuda:
                torch.cuda.empty_cache()
        variants = [(name, kan) for name in MESH_TRAIN_VARIANTS]
        for name, cfg in variants:
            loss, params, state, launches = variant_step(torch, cfg, name, None, device)
            torch.save({part: {k: v.cpu() for k, v in flatten_with_paths(tree).items()}
                        for part, tree in (("params", params),
                                           ("master", state.get("master", {})))},
                       os.path.join(ref_dir, f"variant-{name}.pt"))
            refs["variant_" + name] = {"loss": loss, "launches": launches}
            del params, state
        del fn, m
        if cuda:                       # the four ranks share the card with this process
            gc.collect()
            torch.cuda.empty_cache()
            out["reserved_before_rehearsal"] = torch.cuda.memory_reserved()
        t2 = time.perf_counter()
        d, m = MESH_TRAIN["rehearsal"]
        ranks = M.run_ranks(mesh_train_rank, (d, m), device, share_card=cuda,
                            args=(rehearsal, ref_dir, ckpt, variants))
        out["rehearsal_s"] = time.perf_counter() - t2
        out["references_s"] = t2 - t1
        mesh = {"data": d, "model": m}
        out["rehearsal"] = {}
        for name, cfg, n in rehearsal:
            zero = tree_zero_specs(lm.param_axes(cfg), lm.tree_of_shapes(lm.param_shapes(cfg)),
                                   mesh)
            placed = store.spec_paths(lm.param_shapes(cfg), zero)
            whole = {k: v.shape for k, v in flatten_with_paths(lm.param_shapes(cfg)).items()}
            want_bytes = 2 * 4 * sum(math.prod(s) // math.prod(
                mesh[a] for a in placed[k] if a) for k, s in whole.items())
            for r in ranks:
                got = r[name]
                coord = r["coord"]
                tag = f"2x2 rank {coord} {name}"
                shapes = {k: tuple(n_ // (mesh[a] if a else 1) for n_, a in zip(s, placed[k]))
                          for k, s in whole.items()}
                want_expert = 2 * 4 * sum(math.prod(s) // math.prod(
                    mesh[a] for a in placed[k] if a) for k, s in whole.items()
                    if is_expert_leaf(k))
                if got["zero_shapes"] != shapes or got["opt_bytes"] != want_bytes or \
                        got["expert_opt_bytes"] != want_expert:
                    raise RuntimeError(f"{tag}: ZeRO shapes or bytes differ from "
                                       "tree_zero_specs'")
                if any(got["launches"].values()) or not got["finite"]:
                    raise RuntimeError(f"{tag}: launches {got['launches']}, losses "
                                       f"{got['losses']}")
                if got["losses"] != ranks[0][name]["losses"]:
                    raise RuntimeError(f"{tag}: losses differ from rank 0's")
                rel = max(abs(x - y) / abs(y) for x, y in zip(got["losses"],
                                                              refs[name]["losses"]))
                if rel > MESH_LOSS_RTOL:
                    raise RuntimeError(f"{tag}: losses {got['losses']} vs the unmeshed "
                                       f"{refs[name]['losses']} (rel {rel:.3e})")
                held_params(tag, got["gaps"], n)
            r0 = ranks[0][name]
            row = {"steps": n, "losses": r0["losses"], "unmeshed_losses": refs[name]["losses"],
                   "loss_rel": max(abs(x - y) / abs(y) for x, y in zip(r0["losses"],
                                                                       refs[name]["losses"])),
                   "gaps": [r[name]["gaps"] for r in ranks],
                   "ms_per_step": statistics.median(r0["ms"][1:] or r0["ms"]),
                   "unmeshed_ms_per_step": statistics.median(refs[name]["ms"][1:]
                                                             or refs[name]["ms"]),
                   "opt_bytes_per_rank": r0["opt_bytes"],
                   "opt_bytes_unmeshed": refs[name]["opt_bytes"],
                   "expert_opt_bytes_per_rank": r0["expert_opt_bytes"],
                   "expert_opt_bytes_unmeshed": 2 * 4 * sum(
                       math.prod(s) for k, s in whole.items() if is_expert_leaf(k))}
            out["rehearsal"][name] = row
            runs[f"2x2_{name}"] = {"launches": r0["launches"]}
            log(f"[meshtrain] 2x2 rehearsal {name} d={cfg.d_model} layers={cfg.n_repeats} "
                f"vocab={cfg.vocab}, {n} fp32 steps of batch {B} x {S}: losses {r0['losses']} "
                f"vs unmeshed {refs[name]['losses']} (max rel {row['loss_rel']:.3e}, tol "
                f"{MESH_LOSS_RTOL:.0e}); parameters per rank (max gap / lr, share within "
                f"{MESH_BULK[1]:.0e} lr): {[(round(g['max_lr'], 6), g['bulk_share']) for g in row['gaps']]}"
                f"; no launch; m+v {row['opt_bytes_per_rank'] / 1e6:.1f} MB per rank against "
                f"{row['opt_bytes_unmeshed'] / 1e6:.1f} MB whole "
                f"({row['opt_bytes_per_rank'] / row['opt_bytes_unmeshed']:.4f})"
                + (f", the experts' {row['expert_opt_bytes_per_rank'] / 1e6:.1f} MB against "
                   f"{row['expert_opt_bytes_unmeshed'] / 1e6:.1f} MB"
                   if row["expert_opt_bytes_unmeshed"] else "") + "; "
                f"peak {r0['peak_mem_bytes'] / 1e9 if cuda else 0:.2f} GB allocated per rank "
                f"({r0['card_free_at_start'] / 1e9 if cuda else 0:.1f} GB free on the card at "
                f"its start); {row['ms_per_step']:.1f} ms per step (REHEARSAL: 4 ranks on one card, "
                f"collectives host-staged over gloo; not a scale-out figure; unmeshed "
                f"{row['unmeshed_ms_per_step']:.1f} ms); on {where}")

        # item 9.4.2 step 1: the int8 and bf16 variants' steps on the rehearsal
        for name, _ in variants:
            ref = refs["variant_" + name]
            gaps = []
            for r in ranks:
                got = r["variant_" + name]
                tag = f"2x2 rank {r['coord']} {arch} {name} step"
                rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
                if any(got["launches"].values()) or rel > MESH_LOSS_RTOL:
                    raise RuntimeError(f"{tag}: loss {got['loss']} vs unmeshed {ref['loss']} "
                                       f"(rel {rel:.3e}), launches {got['launches']}")
                if "master_gaps" in got:       # bf16 parameters: their master's rounding
                    held_params(tag + " (fp32 master)", got["master_gaps"], 1, MESH_BF16_BULK)
                    if not got["params_round_master"]:
                        raise RuntimeError(f"{tag}: parameters are not their master's rounding")
                    got["gaps"] = got["master_gaps"]
                else:
                    held_params(tag, got["gaps"], 1)
                gaps.append(got["gaps"])
            out["rehearsal"][f"{arch}_{name}"] = {"loss": ranks[0]["variant_" + name]["loss"],
                                                  "unmeshed_loss": ref["loss"], "gaps": gaps}
            log(f"[meshtrain] 2x2 rehearsal {arch} one step, {name} "
                f"({MESH_TRAIN_VARIANTS[name]}): loss {ranks[0]['variant_' + name]['loss']} vs "
                f"unmeshed {ref['loss']}; parameters per rank (max gap / lr, share within "
                f"{MESH_BULK[1]:.0e} lr): {[(round(g['max_lr'], 6), g['bulk_share']) for g in gaps]}"
                + ("; the bf16 parameters are the rounding of their fp32 master"
                   if name == "bf16" else "")
                + f"; no launch (gloo on {'CUDA' if cuda else 'CPU'} tensors)")

        # (c) the rehearsal's kanformer checkpoint continued on 1x1
        at, n = MESH_TRAIN["ckpt_at"], MESH_TRAIN["rehearsal_steps"][arch]
        whole, wstate, mf = elastic.restore_elastic(ckpt, at, kan, None, torch.float32,
                                                    device=device)
        shard1 = one_rank_group()
        try:
            p1, s1, _ = elastic.restore_elastic(ckpt, at, kan, shard1, torch.float32,
                                                device=device)
            fa, fb = flatten_with_paths((whole, wstate)), flatten_with_paths((p1, s1))
            if mf["step"] != at or not all(torch.equal(fa[k], fb[k]) for k in fa):
                raise RuntimeError("restore_elastic on 1x1 differs from the whole checkpoint")
            data = T.dp.LMDataConfig(kan.vocab, S, B)
            cont = {}
            for tag, sh, p_, s_ in (("unmeshed", None, whole, wstate), ("1x1", shard1, p1, s1)):
                fn = TS.make_train_step(kan, mesh_opt(n), shard=sh)
                ls = []
                for i in range(at, n):
                    p_, s_, met = fn(p_, s_, T.make_batch(kan, data, i, device))
                    ls.append(float(met["loss"]))
                cont[tag] = (ls, flatten_with_paths(p_))
        finally:
            dist.destroy_process_group()
        if cont["1x1"][0] != cont["unmeshed"][0] or not all(
                torch.equal(cont["1x1"][1][k], v) for k, v in cont["unmeshed"][1].items()):
            raise RuntimeError("the continuation on 1x1 differs from the unmeshed one")
        straight = ranks[0][arch]["losses"][at:]
        rel = max(abs(x - y) / abs(y) for x, y in zip(cont["1x1"][0], straight))
        ref = torch.load(os.path.join(ref_dir, f"{arch}.pt"), mmap=True)
        gaps = param_gaps(cont["1x1"][1], ref, lr)
        if rel > MESH_LOSS_RTOL:
            raise RuntimeError(f"continuation: losses {cont['1x1'][0]} vs {straight}")
        held_params("continuation on 1x1", gaps, n)
        out["continuation"] = {"losses": cont["1x1"][0], "straight": straight, "loss_rel": rel,
                               "gaps": gaps}
        log(f"[meshtrain] the 2x2 checkpoint at step {at} restored on 1x1 (bit-equal to the "
            f"whole checkpoint) and continued to step {n}: losses {cont['1x1'][0]} vs the "
            f"straight 2x2 run's {straight} (rel {rel:.3e}); bit-equal to the unmeshed "
            f"continuation; parameters vs the unmeshed straight run {gaps}")
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(tmp, ignore_errors=True)
    out["runs"] = runs
    log(f"[meshtrain] 1x1 {out['1x1_s']:.1f} s, references {out['references_s']:.1f} s, 2x2 "
        f"rehearsal {out['rehearsal_s']:.1f} s; this process held "
        f"{out.get('reserved_before_rehearsal', 0) / 1e9:.2f} GB of the card during it")
    return out


def olmoe_one_by_one(torch, np, cfg, device, one_rank_group) -> dict:
    """Phase 18 (a) for an MoE model, olmoe-1b-7b or deepseek-v2-lite (any
    miss raises): ``MESH_TRAIN
    ["olmoe_steps"]`` fp32 steps of batch 8 x 64 from seed 0 unmeshed and
    on a 1x1 mesh of a one-rank group (``one_rank_group()`` joins it and
    returns its ``ShardingCtx``): no launch, losses, parameters and
    ``m``/``v`` bit-equal; host ms per step, and kernels per step of one
    more step of each under a device-only profiler (on the card)."""
    import torch.distributed as dist

    from repro_torch.convert import flatten_with_paths
    from repro_torch.launch import train as T
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS

    cuda = device == "cuda"
    n, B, S = MESH_TRAIN["olmoe_steps"], MESH_TRAIN["batch"], MESH_TRAIN["seq"]
    data = T.dp.LMDataConfig(cfg.vocab, S, B)
    batches = [T.make_batch(cfg, data, i, device) for i in range(n + 1)]
    res = {}

    def train(tag, shard):
        params = lm.init_params(cfg, seed=0, device=device)
        state = adamw.init_state(params, shard=None if shard is None else shard.for_model(cfg))
        fn = TS.make_train_step(cfg, mesh_opt(n), shard=shard)
        losses, ms = [], []

        def steps():
            nonlocal params, state
            for b in batches[:n]:
                t = time.perf_counter()
                params, state, m = fn(params, state, b)
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t) * 1e3)

        counted(torch, f"{cfg.name} {tag}, {n} steps", steps, {}, device, tag="meshtrain")
        res[tag] = {"losses": losses, "ms": ms, "fn": fn, "params": params, "state": state}

    train("unmeshed", None)
    shard1 = one_rank_group()
    out = {}
    try:
        train("1x1", shard1)
        a, b = (flatten_with_paths((res[t]["params"], res[t]["state"]))
                for t in ("unmeshed", "1x1"))
        if res["1x1"]["losses"] != res["unmeshed"]["losses"] or \
                not all(torch.equal(a[k], b[k]) for k in a):
            raise RuntimeError(f"{cfg.name} 1x1 mesh training: losses {res['1x1']['losses']} vs "
                               f"{res['unmeshed']['losses']}, or parameters or m/v differ")
        out = {"losses": res["1x1"]["losses"], "ms": {k: v["ms"] for k, v in res.items()}}
        if cuda:                                  # one more step each, in place
            out["kernels_per_step"] = {}
            for tag in ("unmeshed", "1x1"):
                r = res[tag]
                out["kernels_per_step"][tag] = kernels_per_call(
                    torch, lambda: r["fn"](r["params"], r["state"], batches[n]))
    finally:
        dist.destroy_process_group()
    del res, a, b
    where = card_line() if cuda else "the CPU (plain versions)"
    log(f"[meshtrain] {cfg.name} d={cfg.d_model} layers={cfg.n_layers} (of "
        f"{16 if cfg.name == 'olmoe-1b-7b' else 27}) experts="
        f"{cfg.unit[0].moe.n_experts}: {n} fp32 steps of batch {B} x {S} unmeshed and on a 1x1 "
        f"{'NCCL' if cuda else 'gloo'} mesh: losses {out['losses']} bit-equal, parameters and "
        f"m/v bit-equal, no launch; ms per step {out['ms']} (the first step warms up); "
        f"kernels per step {out.get('kernels_per_step')}; on {where}")
    return out


def lint_path(torch) -> dict:
    """Phase 16: the port's kanlint on the card (see the module docstring)."""
    from repro_torch.analysis import kernel_configs

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--check",
                        "src/repro_torch"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    cli_s = time.perf_counter() - t0
    for ln in (r.stdout + r.stderr).strip().splitlines():
        log(f"[kanlint:cli] {ln}")
    if r.returncode != 0 or "0 new finding(s)" not in r.stdout:
        raise RuntimeError(f"python -m repro_torch.analysis --check src/repro_torch: "
                           f"rc={r.returncode}, not 0 new findings")
    t1 = time.perf_counter()
    card = kernel_configs.validate_card(torch)
    for row in card["rows"]:
        log(f"[kanlint] {row['kernel']} at {row['shape']}: {row['registers']} registers x "
            f"{row['threads']} threads, shared memory {row['static_smem']} B static + "
            f"{row['dynamic_smem']} B dynamic, spills {row['spill_stores']}/"
            f"{row['spill_loads']} B")
    for what in card["spills"]:
        log(f"[kanlint] spills: {what}")
    for f in card["findings"]:
        log(f"[kanlint] {f.format()}")
    if card["findings"]:
        raise RuntimeError(f"kanlint's card half: {len(card['findings'])} finding(s)")
    log(f"[kanlint] {card['plans']} plans equal to their exports; CLI {cli_s:.1f} s, card "
        f"half {time.perf_counter() - t1:.1f} s")
    return {"cli_rc": r.returncode, "cli_s": cli_s, "plans": card["plans"],
            "instantiations": card["rows"], "spills": card["spills"],
            "card_s": time.perf_counter() - t1}


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"[smoke] cannot import torch/numpy: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("[smoke] src/repro_torch not found next to chip_smoke.py: run it from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.core.bspline import SplineGrid
    from repro_torch.kernels import build

    card = card_line()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"[env] nvidia-smi: {card}")
    repro_torch.set_ieee_fp32()
    log(f"[env] torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} torch.backends.cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {len(built)} libraries built in {time.perf_counter() - t0:.1f} s, all at "
        f"once; each library's own seconds: "
        f"{ {n: round(t, 1) for n, t in built.items()} }")
    for name in build.LIBRARIES:          # built now, or earlier: the log kept beside it
        regs = [ln.strip() for ln in build.log_of(name).splitlines() if "registers" in ln]
        log(f"[build] {name}: {regs[:2]}")

    grid = SplineGrid(-1.0, 1.0, 5, 3)
    t0 = time.perf_counter()
    results = check_kernels(torch, grid)
    results["gather_blocks"] = check_gather(torch, np)
    t1 = time.perf_counter()
    launches, e2e = main_path(torch, np)
    t2 = time.perf_counter()
    cont, dense = continuous_path(torch, np)
    t3 = time.perf_counter()
    spec = speculative_path(torch, np, dense)
    t3s = time.perf_counter()
    samp = sampling_path(torch, np, greedy=cont)
    t3c = time.perf_counter()
    int8 = int8_path(torch, np)
    int8["profile"] = profile_call(torch, int8.pop("int8_net"),
                                   lambda: "one warm int8 MNIST-KAN run (2048 inputs)")
    results.update(time_int8_kernels(torch, np))
    t4 = time.perf_counter()
    gkan = gkan_path(torch)
    t5 = time.perf_counter()
    mnist = mnist_train_path(torch, np, card=card)
    reskan = reskan_path(torch)
    results["kan_fused_gemm"]["timings"] += reskan.pop("timings")
    t6 = time.perf_counter()
    qwen = qwen_path(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    gemma = gemma_path(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    olmoe = olmoe_path(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    deepseek = deepseek_path(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    zamba = zamba_path(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    xlstm = xlstm_path(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    t9 = time.perf_counter()
    trained = train_path(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    nontoken = nontoken_path(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    pipe = pipeline_path(torch, np)
    t11 = time.perf_counter()
    lint = lint_path(torch)
    t12 = time.perf_counter()
    mesh = mesh_path(torch, np)
    gc.collect()
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    mesh_train = mesh_train_path(torch, np)
    log(f"[phases] kernel checks {t1 - t0:.1f} s, static path {t2 - t1:.1f} s, "
        f"continuous path {t3 - t2:.1f} s, speculative path {t3s - t3:.1f} s, "
        f"sampling path {t3c - t3s:.1f} s, int8 path {t4 - t3c:.1f} s, "
        f"GKAN {t5 - t4:.1f} s, KAN applications {t6 - t5:.1f} s, dense models "
        f"{t7 - t6:.1f} s, MoE models {t8 - t7:.1f} s, recurrent models "
        f"{t9 - t8:.1f} s, trainer and non-token inputs {t10 - t9:.1f} s, pipeline "
        f"{t11 - t10:.1f} s, kanlint {t12 - t11:.1f} s, mesh {t13 - t12:.1f} s, mesh training "
        f"{time.perf_counter() - t13:.1f} s")

    # the MoE models' mesh runs (phases 17 and 18): no kernel on their dense
    # and static cells, kernel 5 on olmoe's paged ones
    mesh_runs = {f"mesh_{key}_{k}": m["launches"] for key in ("olmoe", "deepseek")
                 for k, m in mesh[key]["runs"].items()}
    line = {"kernels": [], "pending": [], "main_path": e2e, "continuous_path": cont,
            "speculative_path": spec, "sampling_path": samp, "int8_path": int8,
            "gkan_path": gkan, "mnist_trained_path": mnist, "reskan18_path": reskan,
            "qwen_path": qwen, "gemma_path": gemma, "olmoe_path": olmoe,
            "deepseek_path": deepseek, "zamba2_path": zamba, "xlstm_path": xlstm,
            "train_path": trained, "nontoken_path": nontoken, "pipeline_path": pipe,
            "lint_path": lint, "mesh_path": mesh, "mesh_train_path": mesh_train,
            "build_s": built}
    by_path = {"static": launches, **{k: m["launches"] for k, m in cont["runs"].items()},
               **{k: m["launches"] for k, m in spec["runs"].items()},
               "sampled_static": samp["static"]["launches"],
               **{"sampled_" + k: m["launches"] for k, m in samp["runs"].items()},
               **{k: m["launches"] for k, m in int8["runs"].items()},
               **{k: m["launches"] for k, m in gkan["runs"].items()},
               **{"mnist_trained_" + k: m["launches"] for k, m in mnist["runs"].items()},
               **{k: m["launches"] for k, m in reskan["runs"].items()},
               "qwen_static": qwen["static"]["launches"],
               **{"qwen_" + k: m["launches"] for k, m in qwen["runs"].items()},
               "gemma_static": gemma["launches"],
               "olmoe_static": olmoe["static"]["launches"],
               **{"olmoe_" + k: m["launches"] for k, m in olmoe["runs"].items()},
               "deepseek_static": deepseek["static"]["launches"],
               **{"deepseek_" + k: m["launches"] for k, m in deepseek["runs"].items()},
               **{f"{tag}_{cell}": r[cell]["launches"] for tag, r in (("zamba2", zamba),
                                                                      ("xlstm", xlstm))
                  for cell in ("static", "static_unpadded")},
               **{f"{tag}_{k}": m["launches"] for tag, r in (("zamba2", zamba), ("xlstm", xlstm))
                  for k, m in r["runs"].items()},
               **{"train_" + k: m["launches"] for k, m in trained["runs"].items()},
               **{"inputs_" + k.replace(" ", "_"): m["launches"]
                  for k, m in nontoken["runs"].items()},
               **{"pipeline_" + k: m["launches"] for k, m in pipe["runs"].items()},
               **{"mesh_" + k: m["launches"] for k, m in mesh["runs"].items()},
               **mesh_runs,
               **{"mesh_train_" + k: m["launches"] for k, m in mesh_train["runs"].items()}}
    for name, meta in KERNELS.items():
        if name == "gather_blocks":       # the continuous path's default, shadow reads
            t = next(e for e in results[name]["timings"] if e["dtype"] == "float32"
                     and e["use"] == meta["main_shape"] and e["leaves"] == 2)
            n = by_path["paged_shadow"][name]
        elif "path" in meta:              # the int8 cell's counted runs
            t = next(e for e in results[name]["timings"] if e["shape"] == meta["main_shape"])
            n = by_path[meta["path"]][name]
            if n < 1:
                raise RuntimeError(f"{name} was not launched on its path {meta['path']}")
        else:
            t = next(e for e in results[name]["timings"]
                     if e["dtype"] == "float32" and e["shape"] == meta["main_shape"])
            n = launches[name]
        line["kernels"].append({
            "name": name, "status": "ported", "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": n,
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": results[name]["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t.get("shape", t.get("pool")), "timings": results[name]["timings"],
            "build_s": built.get(Path(meta["source"]).stem),
        })
    for k in line["kernels"] + line["pending"]:
        log(f"[kernels] {k['name']:<22} {k['status']:<8} launches={k['launches']:<5} "
            f"replaces {k['replaces']}")
    print(json.dumps(line), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
