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
10. A JSON line with every ported kernel's numbers, the card's line, and as
   the last line ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits non-zero without one, and when run outside a
checkout of the repository.  Imports nothing of JAX.
"""

from __future__ import annotations

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
    three times.
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
    for factor in (2, 4, 8):
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
    return result


def expected_launches(model, stats: dict, run: dict) -> dict:
    """The launches a continuous run implies, from its own stats: per
    admission prefill two KAN layers per block (fused or sparse, by its row
    count) and, paged, one gather per layer (both leaves in one launch);
    per decode step two KAN layers per block at ``slots`` rows; per chunk,
    shadow reads, one gather per unit block (its leaves and stacked layers
    in one launch), or step reads, one per layer per step.

    A speculative run (``stats["spec"]``) decodes in windows instead: per
    drafter admission prefill two KAN layers per drafter block; per window
    ``spec_k`` drafter steps at ``slots`` rows and one verify pass of the
    whole target at ``slots·W`` rows; paged, per window one gather per
    unit block (shadow) or one per layer (step)."""
    from repro_torch.core import kan_layer as KL
    from repro_torch.kernels import ops

    def kernel(rows: int) -> str:
        return "kan_" + KL.resolve_inference_method("cuda", rows) + "_gemm"

    per_layer = 2 * len(model.unit)
    kan, layers = per_layer * model.n_repeats, len(model.unit) * model.n_repeats
    want = dict.fromkeys(ops.LAUNCHES, 0)
    paged = run.get("paged", False)
    reads = (layers if run.get("paged_read") == "step" else len(model.unit)) if paged else 0
    for k, t_pad in stats["prefill_groups"]:
        want[kernel(k * t_pad)] += kan
        want["gather_blocks"] += layers if paged else 0
    slots = CONT["slots"]
    if "spec" in stats:
        sp = stats["spec"]
        draft = per_layer * sp["draft_layers"]
        for k, t_pad in stats["draft_prefill_groups"]:
            want[kernel(k * t_pad)] += draft
        want[kernel(slots)] += sp["windows"] * sp["spec_k"] * draft
        want[kernel(slots * (sp["spec_k"] + 1))] += sp["windows"] * kan
        want["gather_blocks"] += sp["windows"] * reads
        return want
    steps = stats["chunks_run"] * CONT["chunk_steps"]
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
    (``speculative.perturbed_top2_gap``), and whether it differs from the
    argmax of its own logits."""
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
    return gaps, off


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
    gaps, off = zip(*(sampled_gaps(torch, np, params, cfg, r, o, i, SAMPLE_SEED, temperature,
                                   device) for i, (r, o) in enumerate(zip(reqs, streams["dense"]))))
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
    order = sorted(range(n_req), key=lambda i: lens[i])[:batch]
    T = int(max(lens[i] for i in order))
    toks = torch.as_tensor(np.stack([np.pad(reqs[i], (0, T - len(reqs[i])))
                                     for i in order]).astype(np.int64), device="cuda")
    rl = torch.as_tensor(lens[order], device="cuda")
    forced = [torch.as_tensor(np.stack([outs[i][s] for i in order]).astype(np.int64),
                              device="cuda")[:, None] for s in range(4)]

    def run(method):
        if method:
            os.environ["KAN_SAS_INFERENCE_METHOD"] = method
        try:
            logits, caches = lm.prefill(eng.params, cfg, toks, max_seq)
            got = [logits[torch.arange(batch, device="cuda"), rl - 1]]
            pos = rl.clone()
            for s in range(4):
                lg, caches = lm.decode_step(eng.params, cfg, forced[s], caches, pos)
                got.append(lg)
                pos = pos + 1
            return torch.stack(got)
        finally:
            os.environ.pop("KAN_SAS_INFERENCE_METHOD", None)

    kern = run(None)
    ref = run("compact")
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
    exactly just after (on the CPU the wrappers launch nothing)."""
    from repro_torch.kernels import ops

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
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
    for name, text in build.build_log.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
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
    log(f"[phases] kernel checks {t1 - t0:.1f} s, static path {t2 - t1:.1f} s, "
        f"continuous path {t3 - t2:.1f} s, speculative path {t3s - t3:.1f} s, "
        f"sampling path {t3c - t3s:.1f} s, int8 path {t4 - t3c:.1f} s, "
        f"GKAN {t5 - t4:.1f} s, KAN applications {time.perf_counter() - t5:.1f} s")

    line = {"kernels": [], "pending": [], "main_path": e2e, "continuous_path": cont,
            "speculative_path": spec, "sampling_path": samp, "int8_path": int8,
            "gkan_path": gkan, "mnist_trained_path": mnist, "reskan18_path": reskan,
            "build_s": built}
    by_path = {"static": launches, **{k: m["launches"] for k, m in cont["runs"].items()},
               **{k: m["launches"] for k, m in spec["runs"].items()},
               "sampled_static": samp["static"]["launches"],
               **{"sampled_" + k: m["launches"] for k, m in samp["runs"].items()},
               **{k: m["launches"] for k, m in int8["runs"].items()},
               **{k: m["launches"] for k, m in gkan["runs"].items()},
               **{"mnist_trained_" + k: m["launches"] for k, m in mnist["runs"].items()},
               **{k: m["launches"] for k, m in reskan["runs"].items()}}
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
