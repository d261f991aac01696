#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failed check raises and the script exits non-zero:

1. torch and CUDA versions, the card's name and power limit
   (``nvidia-smi``); float32 matmuls and convolutions set to IEEE fp32
   (TF32 off).
2. Build both CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   ``sm_90a``), timed.
3. Hold each kernel against its plain PyTorch version on the card: fp32 and
   bf16, with and without the base term, at the main path's shapes and a
   ragged one, on inputs that include ``x_min``, ``x_max``, knot values and
   out-of-domain values.  Time kernel, plain version and one PyTorch matmul
   over the materialised band (``library_ms``, a yardstick the port never
   calls) with CUDA events behind a spin kernel (so the host's launch rate
   does not set the time), rotating input copies so the 50 MB L2 stays
   cold as in the model; compute each kernel's bound from its shapes.
4. The main path: full-width kanformer-100m (random weights from a seed,
   fp32) served through ``Engine.serve_requests`` with the launch counts
   reset just before and read just after; then the same tokens through
   prefill and decode steps on the kernel path and on the plain path
   (``KAN_SAS_INFERENCE_METHOD=compact``), logits compared.
5. The same requests again, warm, and one bucket's ``generate`` under
   ``torch.profiler``: the device's busy share and time by kernel name.
6. A JSON line with every ported kernel's numbers (and the TPU kernels not
   ported yet), the card's line, and as the last line
   ``{"ok": true, "device": {...}}``.

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
              "bfloat16": 989e12}  # dense tensor cores
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
}
# The TPU kernels of the JAX package that the port has not reached yet.
PENDING = [
    {"name": "kan_sparse_int8_gemm", "replaces": "src/repro/kernels/kan_sparse_gemm.py:167"},
    {"name": "kan_int8_gemm", "replaces": "src/repro/kernels/kan_int8_gemm.py:45"},
    {"name": "gather_blocks", "replaces": "src/repro/kernels/paged_gather.py:45"},
    {"name": "bspline_lut", "replaces": "src/repro/kernels/bspline_lut.py:25"},
]


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
    torch.cuda._sleep(int(cycles_per_ms * (2 * untimed_ms + 5)))
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    if end.query():
        raise RuntimeError("the spin kernel ended before the host enqueued every call")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    cases = [("kan_fused_gemm", 512, 512, 1024), ("kan_fused_gemm", 512, 1024, 512),
             ("kan_fused_gemm", 13, 100, 200)]
    cases += [("kan_sparse_gemm", r, K, N) for r in (1, 4, 8)
              for K, N in ((512, 1024), (1024, 512))]
    cases += [("kan_sparse_gemm", 13, 100, 200)]
    results = {name: {"max_abs_err": 0.0, "timed": []} for name in KERNELS}
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
                    results[name]["timed"].append((rows, K, N, dtype))

    # timing at the main path's shapes: both FFN layers, fp32 at every row
    # count, bf16 at prefill's 512 and decode's 4 rows
    cycles_per_ms = spin_cycles_per_ms(torch)
    for name in KERNELS:
        for rows, K, N, dtype in results[name]["timed"]:
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
            entry = {"shape": [rows, K, N], "dtype": dname, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bound,
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "flops": flops, "bytes": nbytes}
            results[name].setdefault("timings", []).append(entry)
            log(f"[time] {name} rows={rows} K={K} N={N} {dname}: kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} "
                f"({entry['bound_by']}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return results


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
    want = {"kan_fused_gemm": n_buckets * per_pass,
            "kan_sparse_gemm": n_buckets * (max_new - 1) * per_pass}
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
    """One warm ``Engine.generate`` of a bucket under ``torch.profiler``:
    device busy time (the union of all kernel intervals) and device time by
    kernel name.  The profiler slows the host, so the busy share is given
    against the wall time of the same call run without it, and against the
    profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    eng.generate(prompts, lengths=lens)
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, lengths=lens)
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
    gs = eng.last_generate_stats
    log(f"[profile] one bucket ({gs['rows']} rows, prompt_len {gs['prompt_len']}, "
        f"{gs['decode_steps']} decode steps): wall {plain_wall_us / 1e3:.2f} ms unprofiled, "
        f"{wall_us / 1e3:.2f} ms profiled; device busy {busy / 1e3:.2f} ms = "
        f"{busy / plain_wall_us:.3f} of the unprofiled wall ({busy / wall_us:.3f} of the "
        f"profiled); {len(spans)} kernels")
    for name, (t, n) in top:
        log(f"[profile]   {t / 1e3:9.3f} ms  {n:5d}x  {name[:110]}")
    return {"wall_ms": plain_wall_us / 1e3, "profiled_wall_ms": wall_us / 1e3,
            "busy_ms": busy / 1e3, "busy_share": busy / plain_wall_us,
            "busy_share_profiled": busy / wall_us, "kernels": len(spans),
            "top": [{"name": n[:200], "ms": t / 1e3, "count": c} for n, (t, c) in top]}


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
    log(f"[build] {len(built)} libraries built in {time.perf_counter() - t0:.1f} s "
        f"(per library, parallel: {built})")
    for name, text in build.build_log.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"[build] {name}: {regs[:2]}")

    grid = SplineGrid(-1.0, 1.0, 5, 3)
    results = check_kernels(torch, grid)
    launches, e2e = main_path(torch, np)

    line = {"kernels": [], "pending": [dict(p, status="pending", launches=0) for p in PENDING],
            "main_path": e2e}
    for name, meta in KERNELS.items():
        t = next(e for e in results[name]["timings"]
                 if e["dtype"] == "float32" and e["shape"] == meta["main_shape"])
        line["kernels"].append({
            "name": name, "status": "ported", "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "timings": results[name]["timings"],
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
