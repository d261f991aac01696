#!/usr/bin/env python3
"""Where the time of the two dense-band kernels goes, on one NVIDIA GPU.

    python3 tools/kernel_breakdown.py

Three measurements, all at the shapes ``chip_smoke.py`` times:

1. ``cuobjdump -sass`` of the built ``kan_int8_gemm`` library: its
   integer tensor-core instructions (``IMMA``) and ``IMAD``s, per
   instantiation (the IMADs are index arithmetic; the contraction is the
   IMMAs).
2. Phase removal: copies of ``kan_int8_gemm.cu`` and ``kan_fused_gemm.cu``
   with one phase cut out (the band, the transposition, the MMAs or FMAs,
   the copies after the prologue, the split-K sums), each built with the
   port's flags and timed like the real kernel.  A variant computes wrong
   values; only its time is read.  What a phase costs is the base time
   minus the variant's (phases overlap, so the differences need not add up).
3. Per-block phase clocks of ``kan_int8_gemm``: ``clock64()`` around each
   phase of its K loop, ``%globaltimer`` at a block's start and end, read
   back from a device array after one call.

Needs a CUDA card and ``nvcc``; builds into ``build/kernel_breakdown/``.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "kernel_breakdown"

INT8_VARIANTS = {
    "base": [],
    "no_band": [("if (r < kBM && m0 + r < BS && jj < BK && j0 + jj < K) {", "if (false) {")],
    "no_transpose": [("for (int u = tid; u < (kW / 4) * (BN / 16); u += kThreads) {",
                      "for (int u = tid; u < 0; u += kThreads) {")],
    "no_mma": [("for (int kk = 0; kk < kW; kk += 32) {", "for (int kk = 0; kk < 0; kk += 32) {")],
    "no_copies": [("if (s + kStages < s_end)\n      load_stage", "if (false)\n      load_stage"),
                  ("if (it % L.q == 0 && u >= 1 && s + L.q < s_end) {", "if (false) {")],
    "no_atomics": [("if (split) atomicAdd(&sums[o], acc[mt][nt][i]);", "if (split) {}")],
    "one_slice": [("int splits = min(max(1, per_sm * kan::sm_count() / tiles), max(steps, 1));",
                   "int splits = 1;")],
}
FUSED_VARIANTS = {
    "base": [],
    "no_band": [("write_pair<TC, P>(nb, r, jj, xv[q], row < BS && j < K, M, BK, has_base, t0, "
                 "delta);", "")],
    "no_fma": [("for (int kk = 0; kk < Wc; ++kk) {", "for (int kk = 0; kk < 0; ++kk) {")],
    "no_copies": [("if (s + kStages - 1 < s_end)\n      load_stage",
                   "if (false)\n      load_stage")],
    "no_slice_sum": [("for (int e = tid; e < kBM * BN / 4; e += THREADS) {",
                      "for (int e = tid; e < 0; e += THREADS) {")],
    "one_slice": [("int splits = min(max(1, per_sm * kan::sm_count() / tiles(BS, N, BN)), "
                   "max_splits(BS, N, BN));", "int splits = 1;")],
}
# clock64() around the phases of kan_int8_gemm's K loop; thread 0 of each
# block writes [prologue, wait+zero, band+transpose, copies issued, mma,
# loop, epilogue (cycles), SM id, start ns, end ns, steps] to g_clocks
CLOCKS = [
    ("namespace {\n\nconstexpr int kBM = 64;",
     "__device__ unsigned long long g_clocks[65536 * 12];\n"
     "namespace {\n\nconstexpr int kBM = 64;"),
    ("  const int s_end = min(steps, s_begin + steps_per_split);\n",
     "  const int s_end = min(steps, s_begin + steps_per_split);\n"
     "  long long T0 = clock64(), TA = 0, TB = 0, TC = 0, TD = 0, tt;\n"
     "  unsigned long long G0;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(G0));\n"),
    ("  for (int s = s_begin; s < s_end; ++s) {\n    const int it = s - s_begin;",
     "  long long T1 = clock64();\n"
     "  for (int s = s_begin; s < s_end; ++s) {\n    const int it = s - s_begin;"),
    ("    kan::cp_async_wait<kStages - 1>();\n"
     "    for (int e = tid; e < kBM * kPitch / 16; e += kThreads)\n"
     "      reinterpret_cast<uint4*>(a_s)[e] = make_uint4(0u, 0u, 0u, 0u);\n"
     "    __syncthreads();\n",
     "    tt = clock64();\n"
     "    kan::cp_async_wait<kStages - 1>();\n"
     "    for (int e = tid; e < kBM * kPitch / 16; e += kThreads)\n"
     "      reinterpret_cast<uint4*>(a_s)[e] = make_uint4(0u, 0u, 0u, 0u);\n"
     "    __syncthreads();\n"
     "    TA += clock64() - tt; tt = clock64();\n"),
    ("    __syncthreads();\n    // 3. Refill",
     "    __syncthreads();\n    TB += clock64() - tt; tt = clock64();\n    // 3. Refill"),
    ("    kan::cp_async_commit();\n    // 4. Exact",
     "    kan::cp_async_commit();\n    TC += clock64() - tt; tt = clock64();\n    // 4. Exact"),
    ("        for (int nt = 0; nt < 4; ++nt) mma_u8s8(acc[mt][nt], a[mt], b[nt]);\n    }\n  }\n",
     "        for (int nt = 0; nt < 4; ++nt) mma_u8s8(acc[mt][nt], a[mt], b[nt]);\n    }\n"
     "    TD += clock64() - tt;\n  }\n  long long T2 = clock64();\n"),
    ("  if (!split) return;\n",
     "  {\n    long long T3 = clock64();\n    unsigned long long G1;\n    unsigned smid;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(G1));\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "    if (tid == 0) {\n"
     "      unsigned long long* t = g_clocks + 12 * (blockIdx.x + gridDim.x *\n"
     "                                               (blockIdx.y + gridDim.y * blockIdx.z));\n"
     "      t[0] = T1 - T0; t[1] = TA; t[2] = TB; t[3] = TC; t[4] = TD; t[5] = T2 - T1;\n"
     "      t[6] = T3 - T2; t[7] = smid; t[8] = G0; t[9] = G1; t[10] = s_end - s_begin;\n"
     "    }\n  }\n  if (!split) return;\n"),
]
CLOCK_NAMES = ["prologue", "wait_zero", "band_transpose", "copies_issued", "mma", "loop",
               "epilogue"]


def log(msg: str) -> None:
    print(msg, flush=True)


def variant_source(lib: str, subs) -> str:
    text = (CSRC / f"{lib}.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{lib}: the source no longer has {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(build, jobs: dict[str, tuple[str, str]]) -> dict[str, ctypes.CDLL]:
    """Compile every (library, source text) in parallel with the port's
    flags; load each with the library's C signatures."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, (lib, text) in jobs.items():
        cu, so = OUT / f"{key}.cu", OUT / f"{key}.so"
        cu.write_text(text)
        cmd = [build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(so), str(cu)]
        procs[key] = (lib, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out[-3000:]}")
        handle = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in build.LIBRARIES[lib][1].items():
            f = getattr(handle, fn)
            f.argtypes, f.restype = argtypes, restype
        libs[key] = handle
    return libs


def sass_counts(build) -> dict:
    """IMMA and IMAD instructions per function of the built library."""
    build.build_all(["kan_int8_gemm"])
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build._lib_path("kan_int8_gemm"))],
                          capture_output=True, text=True, check=True).stdout
    counts, name = [], None
    for line in sass.splitlines():
        if "Function :" in line:
            counts.append({"IMMA": 0, "IMAD": 0})
            name = line
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name is not None and m:
            op = m.group(1).split(".")[0]
            if op in ("IMMA", "IMAD"):
                counts[-1][op] += 1
    return {"functions": len(counts),
            "total": {k: sum(c[k] for c in counts) for k in ("IMMA", "IMAD")},
            "imma_per_function": sorted({c["IMMA"] for c in counts})}


def int8_case(torch, Q, SplineGrid, G, rows, K, N, n_sets):
    grid = SplineGrid(-1.0, 1.0, G, 3)
    qg = Q.QuantizedGrid.make(grid)
    lut8 = torch.as_tensor(Q.build_lut_u8(3, qg.S), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(rows + K)
    sets = [(qg.x_quant.quantize(torch.rand(rows, K, generator=g, device="cuda") * 2.4 - 1.2),
             torch.randint(-127, 128, (K, grid.n_basis, N), generator=g, device="cuda",
                           dtype=torch.int8)) for _ in range(n_sets)]
    scale = torch.rand(N, generator=g, device="cuda") * 1e-3
    return grid, qg, lut8, sets, scale


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[breakdown] no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import set_ieee_fp32
    from repro_torch.core import quantization as Q
    from repro_torch.core.bspline import SplineGrid
    from repro_torch.kernels import build, ops

    set_ieee_fp32()
    log(f"[breakdown] {cs.card_line()}")
    result = {"card": cs.card_line(), "sass": sass_counts(build)}
    log(f"[sass] kan_int8_gemm: {json.dumps(result['sass'])}")

    jobs = {f"int8_{v}": ("kan_int8_gemm", variant_source("kan_int8_gemm", subs))
            for v, subs in INT8_VARIANTS.items()}
    jobs |= {f"fused_{v}": ("kan_fused_gemm", variant_source("kan_fused_gemm", subs))
             for v, subs in FUSED_VARIANTS.items()}
    jobs["int8_clocks"] = ("kan_int8_gemm", variant_source("kan_int8_gemm", CLOCKS) +
                           '\nextern "C" int copy_clocks(void* dst, long long n) {\n'
                           '  return (int)cudaMemcpyFromSymbol(dst, g_clocks, n * 8);\n}\n')
    libs = build_variants(build, jobs)
    cycles_per_ms = cs.spin_cycles_per_ms(torch)

    result["int8"] = {}
    for G, rows, K, N in [(10, 2048, 784, 64), (2, 2048, 2810, 512)]:
        grid, qg, lut8, sets, scale = int8_case(torch, Q, SplineGrid, G, rows, K, N, 4)
        times = {}
        for v in INT8_VARIANTS:
            build._loaded["kan_int8_gemm"] = libs[f"int8_{v}"]
            times[v] = cs.time_ms(torch, [
                lambda a=a, c=c: ops.kan_int8_gemm(a, lut8, c, grid, scale=scale,
                                                   lut_scale=qg.lut_scale)
                for a, c in sets], cycles_per_ms)
        lib = libs["int8_clocks"]
        lib.copy_clocks.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        build._loaded["kan_int8_gemm"] = lib
        a, c = sets[0]
        ops.kan_int8_gemm(a, lut8, c, grid, scale=scale, lut_scale=qg.lut_scale)
        torch.cuda.synchronize()
        buf = np.zeros(65536 * 12, dtype=np.uint64)
        if lib.copy_clocks(buf.ctypes.data, buf.size) != 0:
            raise RuntimeError("copy_clocks failed")
        t = buf.reshape(-1, 12)
        t = t[t[:, 9] > 0].astype(np.float64)
        steps = t[:, 10].mean()
        clocks = {
            "blocks": int(len(t)), "steps_per_block": steps,
            "blocks_per_sm": int(np.bincount(t[:, 7].astype(int)).max()),
            "span_us": (t[:, 9].max() - t[:, 8].min()) / 1e3,
            "cycles_per_block": {n: t[:, i].mean() for i, n in enumerate(CLOCK_NAMES)},
            "cycles_per_step": {n: t[:, i].mean() / steps for i, n in enumerate(CLOCK_NAMES)
                                if 1 <= i <= 4},
        }
        key = f"{rows}x{K}->{N}"
        result["int8"][key] = {"ms": times, "clocks": clocks}
        log(f"[int8] {key} M={grid.n_basis} ms: " +
            " ".join(f"{v}={ms:.4f}" for v, ms in times.items()))
        log(f"[int8] {key} clocks: {clocks['blocks']} blocks, {clocks['blocks_per_sm']} per SM, "
            f"{steps:.1f} K steps each, span {clocks['span_us']:.1f} us; cycles per step " +
            " ".join(f"{n}={v:.0f}" for n, v in clocks["cycles_per_step"].items()) +
            "; cycles per block " +
            " ".join(f"{n}={clocks['cycles_per_block'][n]:.0f}"
                     for n in ("prologue", "loop", "epilogue")))

    result["fused"] = {}
    for G, rows, K, N in [(5, 512, 512, 1024), (5, 512, 1024, 512), (10, 2048, 784, 64)]:
        grid = SplineGrid(-1.0, 1.0, G, 3)
        M = grid.n_basis
        g = torch.Generator(device="cuda").manual_seed(7)
        x = cs.special_inputs(torch, rows, K, torch.float32, grid, 99)
        sets = [(0.02 * torch.randn(K, M, N, generator=g, device="cuda"),
                 0.02 * torch.randn(K, N, generator=g, device="cuda")) for _ in range(4)]
        times = {}
        for v in FUSED_VARIANTS:
            build._loaded["kan_fused_gemm"] = libs[f"fused_{v}"]
            times[v] = cs.time_ms(torch, [lambda c=c, w=w: ops.kan_fused_gemm(x, c, grid, w)
                                          for c, w in sets], cycles_per_ms)
        fma_ms = times["base"] - times["no_fma"]
        band_flops = 2.0 * rows * K * (M + 1) * N
        key = f"{rows}x{K}->{N}"
        result["fused"][key] = {"ms": times, "dense_band_gflop": band_flops / 1e9,
                                "fma_share_ms": fma_ms,
                                "fma_tflops": band_flops / (fma_ms * 1e-3) / 1e12}
        log(f"[fused] {key} M={M} ms: " + " ".join(f"{v}={ms:.4f}" for v, ms in times.items()) +
            f"; base - no_fma = {fma_ms:.4f} ms = "
            f"{result['fused'][key]['fma_tflops']:.1f} TFLOP/s over the dense band")
    build._loaded.clear()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
