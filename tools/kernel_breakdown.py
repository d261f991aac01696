#!/usr/bin/env python3
"""Where the time of the port's kernels goes, on one NVIDIA GPU.

    python3 tools/kernel_breakdown.py [--only int8,fused,sparse_int8,sparse,gather]
                                      [--variants a,b,...]
                                      [--sparse-src FILE.cu ...]
                                      [--sparse-int8-src FILE.cu ...]
                                      [--gather-src FILE.cu ...]

Measurements at the shapes ``chip_smoke.py`` times:

1. ``cuobjdump -sass`` of the built ``kan_int8_gemm`` library: its
   integer tensor-core instructions (``IMMA``) and ``IMAD``s, per
   instantiation (the IMADs are index arithmetic; the contraction is the
   IMMAs).
2. Phase removal: copies of ``kan_int8_gemm.cu``, ``kan_fused_gemm.cu``,
   ``kan_sparse_int8_gemm.cu`` and ``kan_sparse_gemm.cu`` with one phase
   cut out (the band, address or entry build, the transposition, the
   coefficient loads, the MMAs, FMAs or dp4a contraction, the copies after
   the prologue, the split-K sums, atomics or tail, the split itself), and
   of the two sparse kernels with another tiling or copy policy, each
   built with the port's flags and timed like the real kernel.  A phase
   variant computes wrong values; only its time is read.  What a phase
   costs is the base time minus the variant's (phases overlap, so the
   differences need not add up).
3. Per-block clocks: ``clock64()`` around each phase of ``kan_int8_gemm``'s
   K loop; ``%globaltimer`` at each block's start, phase boundaries and
   end in both sparse kernels, read back from a device array after one
   call.
4. The time of an empty kernel through the same timer (``time_ms``): the
   least any kernel can show in this harness.
5. The block-table gather (kernel 5, ``--only gather``) at the paged
   continuous cell's two reads, fp32 and bf16: the step read (one layer's
   pool (97, 16, 8, 64), table (8, 12)) and the shadow read (the 8
   stacked layers), each for one leaf and for both (``k`` and ``v``), with
   its byte bound; per design its phase variants or copy policies.

``--sparse-src``, ``--sparse-int8-src`` and ``--gather-src`` time other
versions of the two sparse kernels' and the gather's sources beside the
repository's (for example an earlier commit's, from ``git show``), in
one process on one card; each source's variants are those of its design
(``SPARSE_DESIGNS``, ``SPARSE_INT8_DESIGNS``, ``GATHER_DESIGNS``,
recognised by their text), and a source of no known design is timed
whole.  ``--variants`` builds only the named variants of those three
kernels (and ``base``).

Needs a CUDA card and ``nvcc``; builds into ``build/kernel_breakdown/``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
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

# Phase variants of kan_sparse_int8_gemm.cu, per design (each recognised by
# its variants' text).  "band": one block per 8 rows x 128 columns x 32
# inputs, a MAXM-wide int32 band per (row, input) in shared memory, byte
# loads of the touched rows, MAXM multiply-adds per (row, input, column).
SPARSE_INT8_DESIGNS = {
    "band": {
        "base": [],
        "no_band": [("      const int k = kan::int_address<P>(x_q[(size_t)(r0 + r) * K + j], G, M, "
                     "qmax, S, &addr);\n      kan::rom_fetch<P>(rom_s, S, addr, vals);\n"
                     "#pragma unroll\n      for (int i = 0; i <= P; ++i) band[k - P + i] = vals[i];\n"
                     "      atomicOr(&mask_s[jj], kan::window_mask<P>(k));",
                     "      (void)addr; (void)vals; atomicOr(&mask_s[jj], (1u << M) - 1u);")],
        "no_loads": [("cm[u][m] = (m < M && ((rows >> m) & 1u)) ? (int)c_jn[(size_t)m * N] : 0;",
                      "cm[u][m] = (int)(rows >> m) + (int)(c_jn - coeff);")],
        "no_contraction": [("for (int m = 0; m < MAXM; ++m) s += band_s[r][jj][m] * cm[u][m];",
                            "s += cm[u][r % MAXM];")],
        "no_atomics_epilogue": [
            ("      if (r < nrows) atomicAdd(&sums[(size_t)(r0 + r) * N + n], acc[r]);",
             "      if (r < nrows && acc[r] == 0x7fffffff) sums[(size_t)(r0 + r) * N + n] = 1;"),
            ("  // The last slice of this column tile to finish writes the tile.\n",
             "  return;\n")],
        "one_slice": [("  const int slices = (K + kJC - 1) / kJC;", "  const int slices = 1;")],
    },
}
# "dp4a": 8 rows x 4*TQ columns x JS inputs a block, every copy asked for
# first, a packed (offset, ROM word) per (row, input), a byte transpose and
# one dp4a per (row, input, column), input lanes summed in shared memory,
# then one atomic per (row, column) and a ticket per block.
SPARSE_INT8_DESIGNS["dp4a"] = {
    "base": [],
    "no_band": [("        int addr, vals[P + 1];\n"
                 "        const int k = kan::int_address<P>(xv[q], G, M, qmax, S, &addr);\n"
                 "        kan::rom_fetch<P>(rom_s, S, addr, vals);\n"
                 "        unsigned w = 0u;\n#pragma unroll\n"
                 "        for (int i = 0; i <= P; ++i) w |= (unsigned)vals[i] << (8 * i);\n"
                 "        info = make_int2((jj * M + k - P) * CT / 4, (int)w);",
                 "        info = make_int2(jj * M * CT / 4, xv[q]);")],
    "no_loads": [("      kan::cp_async<16>(c_s + row * CT + c,\n"
                  "                        ok ? coeff + ((size_t)j0 * M + row) * N + n0 + c : coeff, "
                  "ok ? 16 : 0);", "      (void)ok;")],
    "no_contraction": [("          unsigned a[P + 1], col[4];\n#pragma unroll\n"
                        "          for (int i = 0; i <= P; ++i) a[i] = w[i * ctw];\n"
                        "          columns<P>(a, col);\n#pragma unroll\n"
                        "          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = "
                        "dp4a_us((unsigned)info.y, col[cc], acc[r][cc]);",
                        "          acc[r][0] += (int)(w - c32) ^ info.y;")],
    "no_atomics_epilogue": [
        ("      atomicAdd(&sums[(size_t)(r0 + r) * N + n0 + c], s);",
         "      if (s == 0x7fffffff) sums[(size_t)(r0 + r) * N + n0 + c] = 1;"),
        ("  // 5. The last slice of this tile to finish writes the tile.\n", "  return;\n")],
    "one_slice": [("  s.slices = (K + s.JS - 1) / s.JS;", "  s.slices = 1;")],
    # tilings beside the chosen one: a grid of 1 or 4 blocks per SM, and
    # 128-thread blocks (half the input lanes)
    "blocks_per_sm_1": [("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 1;")],
    "blocks_per_sm_4": [("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 4;")],
    "threads_128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
}
# %globaltimer at each block's start, at phase boundaries (STAMP(i), where
# a design marks them), before its ticket test and, in the tile's last
# block, after the epilogue; thread 0 of each block writes [start, stamp 1,
# stamp 2, stamp 3, ticket tested, epilogue done (ns), SM id] to g_times.
START = ("  unsigned long long G0, GS[4] = {0ull, 0ull, 0ull, 0ull};\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(G0));\n")
SPARSE_INT8_TIMES = {
    "band": [
        ("  const int nrows = min(kRows, BS - r0);\n",
         "  const int nrows = min(kRows, BS - r0);\n" + START),
        ("  if (!last_s) return;\n", "  BLOCK_END(4);\n  if (!last_s) return;\n"),
        ("  if (tid == 0) tickets[tile] = 0u;   // ready for the next launch on this workspace\n}",
         "  if (tid == 0) tickets[tile] = 0u;   // ready for the next launch on this workspace\n"
         "  BLOCK_END(5);\n}"),
    ],
}
# "dp4a": stamps after the (row, input) words are built, after the
# contraction, and after the atomics are issued
SPARSE_INT8_TIMES["dp4a"] = [
    ("  const int npairs = kRows * JS;\n", "  const int npairs = kRows * JS;\n" + START),
    ("  // 3. The contraction, chunk", "  STAMP(0);\n  // 3. The contraction, chunk"),
    ("  // 4. Sum the TJ input lanes", "  STAMP(1);\n  // 4. Sum the TJ input lanes"),
    ("  // 5. The last slice of this tile", "  STAMP(2);\n  // 5. The last slice of this tile"),
    *SPARSE_INT8_TIMES["band"][1:],
]
# what the stamps of a design delimit
SPARSE_INT8_PHASES = {
    "dp4a": ("loads_and_words", "contraction", "lane_sums_and_atomics", "fence_and_ticket"),
}

# Phase variants of kan_sparse_gemm.cu (kernel 2), per design.  "band": one
# block per 8 rows x 128 columns x 32 inputs, a zeroed MAXM-wide fp32 band
# per (row, input) in shared memory, scalar loads of the touched rows (4
# inputs' loads in flight), MAXM FMAs per (row, input, column), fp32
# partials per slice summed by the tile's last block.  Its "no_band"
# variant reads no x and gives each (row, input) a fixed window spread over
# the rows, so that about as many rows are loaded.
SPARSE_DESIGNS = {
    "band": {
        "base": [],
        "no_band": [("      const float xf = kan::to_float(x[(size_t)(r0 + r) * K + j]);\n"
                     "      float vals[P + 1];\n"
                     "      const int k = kan::compact_basis<P>(xf, t0, delta, M, vals);\n"
                     "      kan::band_scatter<P, TC>(vals, k, MAXM, band);\n"
                     "      xr = kan::round_to<TC>(fmaxf(xf, 0.0f));\n"
                     "      atomicOr(&mask_s[jj], kan::window_mask<P>(k));",
                     "      for (int m = 0; m < MAXM; ++m) band[m] = 0.0f;\n"
                     "      atomicOr(&mask_s[jj], kan::window_mask<P>(P + (r + j) % (M - P)));")],
        "no_loads": [("        kan::gather_coeff_rows<MAXM>(coeff + j * M * N + n, (size_t)N, M, "
                      "mask_s[jj],\n                                      cm[u]);\n"
                      "        wb[u] = (has_base && jj < jn) ? kan::to_float(base_w[j * N + n]) : "
                      "0.0f;",
                      "        for (int m = 0; m < MAXM; ++m) cm[u][m] = (float)((mask_s[jj] >> m) "
                      "& 1u);\n        wb[u] = (float)jj;")],
        "no_contraction": [("            for (int m = 0; m < MAXM; ++m) s = fmaf(band_s[r][jj][m], "
                            "cm[u][m], s);", "            s += cm[u][r % MAXM];")],
        "no_tail": [("  // The last slice of this column tile to finish sums all its slices.\n",
                     "  return;\n")],
        "one_slice": [("  const int slices = (K + kJC - 1) / kJC;", "  const int slices = 1;")],
        # tilings beside the chosen one: 16 or 64 inputs a slice, 256 columns
        "inputs_16": [("constexpr int kJC = 32; ", "constexpr int kJC = 16; ")],
        "inputs_64": [("constexpr int kJC = 32; ", "constexpr int kJC = 64; ")],
        "threads_256": [("constexpr int kCols = 128; ", "constexpr int kCols = 256; ")],
    },
}
SPARSE_TIMES = {
    "band": [
        ("  const int nrows = min(kRows, BS - r0);\n",
         "  const int nrows = min(kRows, BS - r0);\n" + START),
        ("  float acc[kRows];\n", "  STAMP(0);\n  float acc[kRows];\n"),
        ("  // The last slice of this column tile", "  STAMP(1);\n  // The last slice of this column tile"),
        ("  const int tile = blockIdx.z * gridDim.x + blockIdx.x;\n",
         "  STAMP(2);\n  const int tile = blockIdx.z * gridDim.x + blockIdx.x;\n"),
        *SPARSE_INT8_TIMES["band"][1:],
    ],
}
# "own": 8 rows x V*TQ columns x JS inputs a block; each lane
# stages by cp.async, and reads, only its own 16 bytes of its inputs' rows
# (all M rows, or only the touched ones at <= kSelectRows rows), a group a
# round, so no barrier stands between its copies and its contraction; a
# packed entry per (row, input); P+1 16-byte shared loads and P+1 FMAs per
# (row, input, column); lanes summed in shared memory in groups; fp32
# partials per slice summed in a fixed order by the tile's last block
# after a ticket taken with release and acquire semantics.  Its "no_loads"
# variant copies nothing (the rows hold whatever shared memory held).
SPARSE_DESIGNS["own"] = {
    "base": [],
    "no_band": [("                     ? kan::to_float(x[(size_t)(r0 + r) * K + j0 + jj]) : 0.0f;",
                 "                     ? (float)jj : 0.0f;"),
                ("        const int k = kan::compact_basis<P>(xv[q][i], t0, delta, M, vals);",
                 "        const int k = P + (r + jj) % (M - P);\n"
                 "        for (int t = 0; t <= P; ++t) vals[t] = xv[q][i];")],
    "no_loads": [("      if constexpr (U == 2) dst[m * CT + e] = ok ? src[n + e] : "
                  "kan::from_float<TC>(0.0f);\n"
                  "      else kan::cp_async<U>(dst + m * CT + e, ok ? src + n + e : coeff, ok ? U : 0);",
                  "      (void)ok; (void)src; (void)dst;")],
    "no_contraction": [("#pragma unroll\n        for (int i = 0; i <= P; ++i) {\n"
                        "          float cv[V];\n          load16(w + i * CT, cv);\n"
                        "#pragma unroll\n          for (int v = 0; v < V; ++v) "
                        "acc[r][v] = fmaf(vi[i], cv[v], acc[r][v]);\n        }",
                        "        acc[r][0] += vi[0] + (float)(w - own);")],
    "no_tail": [("  // 5. The last slice of this tile to finish sums the tile's slices: each\n",
                 "  return;\n")],
    "one_slice": [("  s.slices = max(1, (K + s.JS - 1) / s.JS);", "  s.slices = 1;")],
    # the ticket as before: a fence by every thread before and after it
    "fences": [("  if (tid == 0) last_s = kan::atomic_add_acq_rel(&tickets[tile], 1u) == gridDim.y - 1;"
                "\n  __syncthreads();\n  if (!last_s) return;\n",
                "  __threadfence();\n  __syncthreads();\n"
                "  if (tid == 0) last_s = atomicAdd(&tickets[tile], 1u) == gridDim.y - 1;\n"
                "  __syncthreads();\n  if (!last_s) return;\n  __threadfence();\n")],
    # tilings and copy policies beside the chosen ones
    "blocks_per_sm_1": [("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 1;")],
    "blocks_per_sm_4": [("constexpr int kBlocksPerSM = 2;", "constexpr int kBlocksPerSM = 4;")],
    "tiles_8": [("constexpr int kTilesTarget = 16;", "constexpr int kTilesTarget = 8;")],
    "tiles_32": [("constexpr int kTilesTarget = 16;", "constexpr int kTilesTarget = 32;")],
    "rounds_4": [("constexpr int kMaxRounds = 2;", "constexpr int kMaxRounds = 4;")],
    "copy_all_rows": [("constexpr int kSelectRows = 2;", "constexpr int kSelectRows = 0;")],
    "copy_touched_at_4": [("constexpr int kSelectRows = 2;", "constexpr int kSelectRows = 4;")],
}
SPARSE_TIMES["own"] = [
    ("  const int nrows = min(kRows, BS - r0);\n",
     "  const int nrows = min(kRows, BS - r0);\n" + START),
    ("  // 3. The contraction, round by round", "  STAMP(0);\n  // 3. The contraction, round by round"),
    ("  // 4. Sum the TJ input lanes", "  STAMP(1);\n  // 4. Sum the TJ input lanes"),
    ("  // 5. The last slice of this tile", "  STAMP(2);\n  // 5. The last slice of this tile"),
    ("  if (one_slice) return;\n", "  BLOCK_END(4);\n  if (one_slice) return;\n"),
    *SPARSE_INT8_TIMES["band"][1:],
]
SPARSE_PHASES = {
    "band": ("band", "loads_and_contraction", "partials_and_fence", "ticket"),
    "own": ("x_entries_and_asks", "contraction", "lane_sums_and_partials", "fence_and_ticket"),
}
# What an earlier design took from kan_common.cuh and the header no longer
# has, put back after the include in its builds.
PRELUDES = {("kan_sparse_gemm", "band"): r"""
namespace kan {
template <int P, typename T>
__device__ __forceinline__ void band_scatter(const float* vals, int k, int M, float* band) {
  for (int m = 0; m < M; ++m) band[m] = 0.0f;
#pragma unroll
  for (int i = 0; i <= P; ++i) band[k - P + i] = round_to<T>(vals[i]);
}
template <int MAXM, typename T>
__device__ __forceinline__ void gather_coeff_rows(const T* __restrict__ c_jn, size_t stride,
                                                  int M, unsigned rows, float* cm) {
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
    cm[m] = (m < M && ((rows >> m) & 1u)) ? to_float(c_jn[m * stride]) : 0.0f;
}
}  // namespace kan
"""}
# per library: its designs' variants, timers and phase names
DESIGNS = {"kan_sparse_int8_gemm": (SPARSE_INT8_DESIGNS, SPARSE_INT8_TIMES, SPARSE_INT8_PHASES),
           "kan_sparse_gemm": (SPARSE_DESIGNS, SPARSE_TIMES, SPARSE_PHASES)}
BLOCK_END = r"""
#define STAMP(i) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(GS[i]))
#define BLOCK_END(slot)                                                              \
  do {                                                                               \
    unsigned long long G1;                                                           \
    unsigned smid;                                                                   \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(G1));                           \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));                                \
    if (threadIdx.x == 0) {                                                          \
      unsigned long long* t = g_times + 7 * (blockIdx.x + gridDim.x *                \
                                             (blockIdx.y + gridDim.y * blockIdx.z)); \
      t[0] = G0; t[1] = GS[0]; t[2] = GS[1]; t[3] = GS[2];                           \
      t[slot] = G1; t[6] = smid;                                                     \
    }                                                                                \
  } while (0)
__device__ unsigned long long g_times[65536 * 7];
extern "C" int copy_times(void* dst, long long n) {
  return (int)cudaMemcpyFromSymbol(dst, g_times, n * 8);
}
extern "C" int clear_times() {
  static unsigned long long zero[65536 * 7];
  return (int)cudaMemcpyToSymbol(g_times, zero, sizeof(zero));
}
"""
EMPTY_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def variant_source(lib: str, subs, text: str | None = None) -> str:
    text = (CSRC / f"{lib}.cu").read_text() if text is None else text
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{lib}: the source no longer has {old[:60]!r}")
        text = text.replace(old, new)
    return text


def design_of(lib: str, text: str) -> str | None:
    """The design of a source of ``lib``: the one whose variants' and
    timers' text it all holds (None: an unrecognised design, timed whole)."""
    designs, times, _ = DESIGNS[lib]
    for design, variants in designs.items():
        subs = [o for v in variants.values() for o, _ in v]
        subs += [o for o, _ in times.get(design, [])]
        if all(text.count(o) == 1 for o in subs):
            return design
    return None


def timed_source(lib: str, text: str, design: str) -> str:
    """``text`` with ``%globaltimer`` read at each block's start, phase
    boundaries and end."""
    body = variant_source(lib, DESIGNS[lib][1][design], text)
    head = '#include "kan_common.cuh"\n'
    return body.replace(head, head + BLOCK_END, 1)


def design_variants(lib: str, design: str | None, only: set[str] | None = None) -> dict:
    """The variants of a design of ``lib`` (``base`` alone for an
    unrecognised one), those named in ``only`` if given."""
    variants = DESIGNS[lib][0][design] if design else {"base": []}
    return {v: subs for v, subs in variants.items() if only is None or v == "base" or v in only}


def design_jobs(lib: str, tag: str, texts: dict[str, str], only: set[str] | None = None
                ) -> tuple[dict, dict]:
    """Build jobs of every source of ``lib`` (its design's phase variants
    and, where it has timers, its timed copy, or the source alone if no
    design matches) and each source's design."""
    jobs, sources = {}, {}
    head = '#include "kan_common.cuh"\n'
    for src, text in texts.items():
        design = sources[src] = design_of(lib, text)
        text = text.replace(head, head + PRELUDES.get((lib, design), ""), 1)
        for v, subs in design_variants(lib, design, only).items():
            jobs[f"{tag}_{src}_{v}"] = (lib, variant_source(lib, subs, text))
        if design and DESIGNS[lib][1].get(design):
            jobs[f"{tag}_{src}_times"] = (lib, timed_source(lib, text, design))
    return jobs, sources


def block_times(np, lib, call) -> dict:
    """Each block's start, phase stamps and end from one ``call()`` of the
    timed build ``lib``."""
    import torch

    lib.copy_times.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    torch.cuda.synchronize()
    if lib.clear_times() != 0:
        raise RuntimeError("clear_times failed")
    call()
    torch.cuda.synchronize()
    buf = np.zeros(65536 * 7, dtype=np.uint64)
    if lib.copy_times(buf.ctypes.data, buf.size) != 0:
        raise RuntimeError("copy_times failed")
    t = buf.reshape(-1, 7)
    t = t[t[:, 4] > 0].astype(np.float64)
    if not len(t):
        raise RuntimeError("no block of the timed build recorded its times")
    last = t[t[:, 5] > 0]
    dur = (t[:, 4] - t[:, 0]) / 1e3
    return {"t": t, "blocks": int(len(t)),
            "blocks_per_sm": int(np.bincount(t[:, 6].astype(int)).max()),
            "sms_used": int(np.unique(t[:, 6]).size),
            "span_us": (np.maximum(t[:, 4], t[:, 5]).max() - t[:, 0].min()) / 1e3,
            "last_start_us": (t[:, 0].max() - t[:, 0].min()) / 1e3,
            "block_us_mean": float(dur.mean()), "block_us_max": float(dur.max()),
            "epilogue_us_mean": float(((last[:, 5] - last[:, 4]) / 1e3).mean())
            if len(last) else 0.0}


def decode_section(torch, np, cs, lib, tag, cases, sources, libs, cycles_per_ms, only=None):
    """A decode kernel at its shapes, per source: the phase variants'
    times, and each block's start, phases and end from one call.
    ``cases`` maps a shape key to ``(sets, call)``: input copies enough to
    keep the L2 cold and a function of one copy that launches the kernel."""
    out = {}
    for key, (sets, call) in cases.items():
        out[key] = {}
        for src, design in sources.items():
            times = {}
            for v in design_variants(lib, design, only):
                use_library(lib, libs[f"{tag}_{src}_{v}"])
                times[v] = cs.time_ms(torch, [lambda s=s: call(*s) for s in sets], cycles_per_ms)
            entry = {"design": design, "ms": times}
            log(f"[{tag}] {key} {src} ({design}) ms: " +
                " ".join(f"{v}={ms:.4f}" for v, ms in times.items()))
            if design:
                timed = libs[f"{tag}_{src}_times"]
                use_library(lib, timed)
                call(*sets[0])
                blocks = block_times(np, timed, lambda: call(*sets[0]))
                t = blocks.pop("t")
                if (t[:, 1:4] > 0).all():          # the design's phase stamps
                    edges = [t[:, 0], t[:, 1], t[:, 2], t[:, 3], t[:, 4]]
                    blocks["phase_us_mean"] = {
                        name: float(((b - a) / 1e3).mean()) for name, a, b in zip(
                            DESIGNS[lib][2][design], edges[:-1], edges[1:])}
                entry["blocks"] = blocks
                log(f"[{tag}] {key} {src} blocks: {blocks['blocks']} on {blocks['sms_used']} "
                    f"SMs (at most {blocks['blocks_per_sm']} per SM), span "
                    f"{blocks['span_us']:.2f} us, last block starts at "
                    f"{blocks['last_start_us']:.2f} us, a block takes "
                    f"{blocks['block_us_mean']:.2f} us (max {blocks['block_us_max']:.2f}) to its "
                    f"ticket, the last of a tile {blocks['epilogue_us_mean']:.2f} us more" +
                    ("; phases (us, mean): " + " ".join(
                        f"{n}={v:.2f}" for n, v in blocks["phase_us_mean"].items())
                     if "phase_us_mean" in blocks else ""))
            out[key][src] = entry
    return out


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
        for fn, (argtypes, restype) in build.LIBRARIES.get(lib, (None, {}))[1].items():
            f = getattr(handle, fn)
            f.argtypes, f.restype = argtypes, restype
        libs[key] = handle
    return libs


def use_library(lib: str, handle) -> None:
    """Make ``handle`` the library the wrappers launch for ``lib``, with a
    zeroed workspace sized by its own exports (a variant may have left
    counters set, and two designs may size their workspace differently)."""
    from repro_torch.kernels import build, workspace

    build._loaded[lib] = handle
    workspace._sizes.clear()
    for ws in workspace._workspaces.values():
        for t in ws.values():
            t.zero_()


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


def int8_section(torch, np, cs, Q, SplineGrid, ops, libs, cycles_per_ms):
    """Kernel 4 at MNIST-KAN and CF-KAN layer 1: phase variants and the
    per-phase clocks of one call."""
    out = {}
    for G, rows, K, N in [(10, 2048, 784, 64), (2, 2048, 2810, 512)]:
        grid, qg, lut8, sets, scale = int8_case(torch, Q, SplineGrid, G, rows, K, N, 4)
        times = {}
        for v in INT8_VARIANTS:
            use_library("kan_int8_gemm", libs[f"int8_{v}"])
            times[v] = cs.time_ms(torch, [
                lambda a=a, c=c: ops.kan_int8_gemm(a, lut8, c, grid, scale=scale,
                                                   lut_scale=qg.lut_scale)
                for a, c in sets], cycles_per_ms)
        lib = libs["int8_clocks"]
        lib.copy_clocks.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        use_library("kan_int8_gemm", lib)
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
        out[key] = {"ms": times, "clocks": clocks}
        log(f"[int8] {key} M={grid.n_basis} ms: " +
            " ".join(f"{v}={ms:.4f}" for v, ms in times.items()))
        log(f"[int8] {key} clocks: {clocks['blocks']} blocks, {clocks['blocks_per_sm']} per SM, "
            f"{steps:.1f} K steps each, span {clocks['span_us']:.1f} us; cycles per step " +
            " ".join(f"{n}={v:.0f}" for n, v in clocks["cycles_per_step"].items()) +
            "; cycles per block " +
            " ".join(f"{n}={clocks['cycles_per_block'][n]:.0f}"
                     for n in ("prologue", "loop", "epilogue")))
    return out


def fused_section(torch, cs, SplineGrid, ops, libs, cycles_per_ms):
    """Kernel 1 at the LM shapes and the fp32 MNIST-KAN net's layer 1:
    phase variants, and the FMAs' rate over the dense band."""
    out = {}
    for G, rows, K, N in [(5, 512, 512, 1024), (5, 512, 1024, 512), (10, 2048, 784, 64)]:
        grid = SplineGrid(-1.0, 1.0, G, 3)
        M = grid.n_basis
        g = torch.Generator(device="cuda").manual_seed(7)
        x = cs.special_inputs(torch, rows, K, torch.float32, grid, 99)
        sets = [(0.02 * torch.randn(K, M, N, generator=g, device="cuda"),
                 0.02 * torch.randn(K, N, generator=g, device="cuda")) for _ in range(4)]
        times = {}
        for v in FUSED_VARIANTS:
            use_library("kan_fused_gemm", libs[f"fused_{v}"])
            times[v] = cs.time_ms(torch, [lambda c=c, w=w: ops.kan_fused_gemm(x, c, grid, w)
                                          for c, w in sets], cycles_per_ms)
        fma_ms = times["base"] - times["no_fma"]
        band_flops = 2.0 * rows * K * (M + 1) * N
        key = f"{rows}x{K}->{N}"
        out[key] = {"ms": times, "dense_band_gflop": band_flops / 1e9, "fma_share_ms": fma_ms,
                    "fma_tflops": band_flops / (fma_ms * 1e-3) / 1e12}
        log(f"[fused] {key} M={M} ms: " + " ".join(f"{v}={ms:.4f}" for v, ms in times.items()) +
            f"; base - no_fma = {fma_ms:.4f} ms = "
            f"{out[key]['fma_tflops']:.1f} TFLOP/s over the dense band")
    return out


SPARSE_INT8_SHAPES = [(10, 8, 784, 64), (2, 8, 2810, 512)]    # (G, rows, K, N)


def sparse_int8_cases(torch, cs, Q, SplineGrid, ops):
    """Kernel 3 at its two decode shapes, with the dequant epilogue."""
    cases = {}
    for G, rows, K, N in SPARSE_INT8_SHAPES:
        M = G + 3
        n_sets = max(1, math.ceil(cs.L2_FLUSH_BYTES / (rows * K * 4 + K * M * N)))
        grid, qg, lut8, sets, scale = int8_case(torch, Q, SplineGrid, G, rows, K, N, n_sets)
        cases[f"{rows}x{K}->{N} M={M}"] = (sets, lambda a, c, grid=grid, lut8=lut8, scale=scale,
                                           qg=qg: ops.kan_sparse_int8_gemm(
                                               a, lut8, c, grid, scale=scale,
                                               lut_scale=qg.lut_scale))
    return cases


# kernel 2 where chip_smoke.py times it: both LM layers (G=5, M=8) at 1, 4
# and 8 rows in fp32 and at 4 rows in bf16, and the fp32 MNIST-KAN net's
# two layers at 8 rows (G=10, M=13); and at 2 rows, the most that copy only
# the touched rows (kSelectRows); (G, rows, K, N, dtype)
SPARSE_SHAPES = [(5, r, K, N, "float32") for K, N in ((512, 1024), (1024, 512))
                 for r in (1, 2, 4, 8)]
SPARSE_SHAPES += [(5, 4, 512, 1024, "bfloat16"), (5, 4, 1024, 512, "bfloat16"),
                  (10, 8, 784, 64, "float32"), (10, 8, 64, 10, "float32")]


def sparse_cases(torch, cs, SplineGrid, ops):
    """Kernel 2 with the base term, on chip_smoke.py's inputs."""
    cases = {}
    for G, rows, K, N, dname in SPARSE_SHAPES:
        grid = SplineGrid(-1.0, 1.0, G, 3)
        M, dtype = grid.n_basis, getattr(torch, dname)
        esize = torch.tensor([], dtype=dtype).element_size()
        n_sets = max(1, math.ceil(cs.L2_FLUSH_BYTES / ((K * M * N + K * N) * esize)))
        g = torch.Generator(device="cuda").manual_seed(7)
        x = cs.special_inputs(torch, rows, K, dtype, grid, 99)
        sets = [((0.02 * torch.randn(K, M, N, generator=g, device="cuda")).to(dtype),
                 (0.02 * torch.randn(K, N, generator=g, device="cuda")).to(dtype))
                for _ in range(n_sets)]
        cases[f"{rows}x{K}->{N} M={M} {dname}"] = (
            sets, lambda c, w, x=x, grid=grid: ops.kan_sparse_gemm(x, c, grid, w))
    return cases


# Kernel 5 (paged_gather.cu), per design (recognised by its variants' text).
# "block" (the first design): one CUDA block of 256 threads per logical block (layer,
# b, l), its threads striding along the block one 16-byte word at a time
# (one load in flight before each store), one launch per leaf.  Variants:
# no copy (the launch, the table entry and the index arithmetic) and
# stores only (zeros written, nothing read).
GATHER_BLOCK_LOOP = ("  for (long long i = threadIdx.x; i < units_per_block; i += kThreads) "
                     "dst[i] = src[i];\n")
GATHER_DISPATCH = """  if (f.unit == 16) {
    copy_registers<uint4>(src, dst, len);
  } else if (f.unit == 4) {
    copy_registers<uint32_t>(src, dst, len);
  } else if (f.unit == 2) {
    copy_registers<uint16_t>(src, dst, len);
  } else {
    copy_registers<uint8_t>(src, dst, len);
  }
"""
# design (a): thread 0 of a 32-thread CTA copies a part of kBulkPart bytes
# by 1-D bulk copies through shared memory, every 8 KB stage asked for
# first, each sent out as its mbarrier completes
GATHER_COPY_BULK = r"""__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy_bulk(const uint8_t* src, uint8_t* dst, int len) {
  constexpr int kStages = kBulkPart / kStageBytes;
  __shared__ __align__(128) uint8_t buf[kBulkPart];
  __shared__ __align__(8) uint64_t bar[kStages];
  if (threadIdx.x != 0) return;
  const int stages = (len + kStageBytes - 1) / kStageBytes;
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  for (int s = 0; s < stages; ++s) {
    const int bytes = min(kStageBytes, len - s * kStageBytes);
    const uint32_t b = smem_addr(&bar[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(buf + s * kStageBytes)), "l"(src + s * kStageBytes), "r"(bytes), "r"(b)
        : "memory");
  }
  for (int s = 0; s < stages; ++s) {
    const int bytes = min(kStageBytes, len - s * kStageBytes);
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(smem_addr(&bar[s]))
        : "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(dst + s * kStageBytes), "r"(smem_addr(buf + s * kStageBytes)), "r"(bytes)
                 : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

"""
GATHER_GRID = "// Grid (b * L + l, part, leaf and layer)"


def gather_bulk(part_bytes: int) -> list:
    """The substitutions that make the kept source design (a), with parts
    of ``part_bytes``."""
    return [("constexpr int kThreads = 128;",
             f"constexpr int kThreads = 32;\nconstexpr int kBulkPart = {part_bytes};\n"
             "constexpr int kStageBytes = 8192;"),
            (GATHER_GRID, GATHER_COPY_BULK + GATHER_GRID),
            ("    copy_registers<uint4>(src, dst, len);", "    copy_bulk(src, dst, len);"),
            ("    f.part_bytes = kThreads * kUnroll * f.unit;",
             "    f.part_bytes = f.unit == 16 ? kBulkPart : kThreads * kUnroll * f.unit;")]


GATHER_DESIGNS = {
    "block": {
        "base": [],
        "no_copy": [(GATHER_BLOCK_LOOP,
                     "  if (threadIdx.x == 0 && id == 0x7fffffff) dst[0] = src[0];\n")],
        "stores_only": [(GATHER_BLOCK_LOOP, GATHER_BLOCK_LOOP.replace("src[i]", "T{}"))],
    },
    # "leaves" (the design that replaced it): one launch for every leaf, a
    # CTA per part of a block on a (b * L + l, part, leaf and layer) grid,
    # every load of a CTA issued before its first store.  Base: (b) 128
    # threads x 4 registers of 16 bytes (8 KB parts), loads asking the L2
    # for 256-byte lines.  Phases: no copy, stores only.  Beside it: (b)
    # with plain loads, with 2 and 8 registers (4 and 16 KB parts), with
    # streaming stores; (a) 1-D bulk copies of 16 and 32 KB parts.
    "leaves": {
        "base": [],
        "no_copy": [(GATHER_DISPATCH,
                     "  if (threadIdx.x == 0 && id == 0x7fffffff) dst[0] = src[0];\n")],
        "stores_only": [("    if (k < n) r[u] = load(s + k);", "    if (k < n) r[u] = T{};")],
        "loads_plain": [("  if constexpr (sizeof(T) == 16) {", "  if constexpr (false) {")],
        "registers_4k": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
        "registers_16k": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
        "stores_streaming": [("    if (k < n) d[k] = r[u];",
                              "    if (k < n) __stcs(d + k, r[u]);")],
        "bulk_16k": gather_bulk(16384),
        "bulk_32k": gather_bulk(32768),
    },
}
DESIGNS["paged_gather"] = (GATHER_DESIGNS, {}, {})
# the gather at the continuous cell's two reads: (use, stacked, dtype)
GATHER_CASES = [("step", False, "float32"), ("step", False, "bfloat16"),
                ("shadow", True, "float32")]


def gather_call(torch, design: str | None, handle):
    """A function ``(pools, table, stacked) -> views`` that launches
    ``handle``, a build of ``design``, as that design's wrapper does."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import paged_gather as PG

    if design != "block":                 # the repository's entry: one launch for all leaves
        def call(pools, table, stacked):
            return list(ops.gather_views(dict(zip("kv", pools)), table, stacked).values())
        return call
    f = handle.paged_gather               # the first design's entry: one launch per leaf
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong,
                                                                  ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int

    def call(pools, table, stacked):
        views = []
        for p in pools:
            v = torch.empty(PG._view_shape(p, table, stacked), dtype=p.dtype, device=p.device)
            esize = p.element_size()
            err = f(p.data_ptr(), table.data_ptr(), v.data_ptr(), p.shape[0] if stacked else 1,
                    p.shape[1 if stacked else 0], table.shape[0], table.shape[1],
                    math.prod(p.shape[2 if stacked else 1:]) * esize, esize,
                    torch.cuda.current_stream().cuda_stream)
            build.check(err, "paged_gather")
            views.append(v)
        return views
    return call


def gather_section(torch, np, cs, sources, libs, cycles_per_ms, only=None):
    """Kernel 5 at the step and shadow reads, one leaf and both, per source
    and variant, beside the byte bound and ``index_select`` per leaf."""
    from repro_torch.kernels import paged_gather as PG

    n_blocks, bs = cs.GATHER_POOL[:2]
    table = cs.engine_table(torch, np, cs.CONT["slots"], cs.CONT["max_seq"] // bs, n_blocks, 5)
    idx = table.reshape(-1).long().clamp(0, n_blocks - 1)
    out = {}
    for use, stacked, dname in GATHER_CASES:
        dtype = getattr(torch, dname)
        shape = ((cs.GATHER_USES[use][1],) if stacked else ()) + cs.GATHER_POOL
        nbytes = math.prod(shape) * torch.tensor([], dtype=dtype).element_size()
        n_sets = max(1, math.ceil(cs.L2_FLUSH_BYTES / nbytes))     # as chip_smoke.py's
        g = torch.Generator(device="cuda").manual_seed(11)
        sets = [[torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(2)]
                for _ in range(n_sets)]
        for leaves in (1, 2):
            key = f"{use} {dname} {leaves} " + ("leaves" if leaves > 1 else "leaf")
            bound = cs.gather_bytes(torch, sets[0][:leaves], table, stacked) \
                / cs.HBM_BYTES_PER_S * 1e3
            lib_ms = cs.time_ms(torch, [lambda s=s: [torch.index_select(p, int(stacked), idx)
                                                     for p in s[:leaves]] for s in sets],
                                cycles_per_ms)
            entry = {"bound_ms": bound, "index_select_ms": lib_ms}
            for src, design in sources.items():
                times = {}
                for v in design_variants("paged_gather", design, only):
                    handle = libs[f"gather_{src}_{v}"]
                    use_library("paged_gather", handle)
                    call = gather_call(torch, design, handle)
                    if v == "base":
                        want = [PG.gather_blocks_reference(p, table, stacked)
                                for p in sets[0][:leaves]]
                        if not all(torch.equal(a, b) for a, b in
                                   zip(call(sets[0][:leaves], table, stacked), want)):
                            raise RuntimeError(f"gather {src} disagrees with its plain version")
                    times[v] = cs.time_ms(torch, [lambda s=s: call(s[:leaves], table, stacked)
                                                  for s in sets], cycles_per_ms)
                entry[src] = {"design": design, "ms": times}
                log(f"[gather] {key} {src} ({design}) ms: " +
                    " ".join(f"{v}={ms:.4f}" for v, ms in times.items()) +
                    f"; bound {bound:.4f}, index_select x{leaves} {lib_ms:.4f}")
            out[key] = entry
    return out


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="int8,fused,sparse_int8,sparse,gather",
                    help="comma-separated sections: int8, fused, sparse_int8, sparse, gather")
    ap.add_argument("--sparse-int8-src", nargs="*", default=[],
                    help="other kan_sparse_int8_gemm.cu sources timed beside the repository's")
    ap.add_argument("--sparse-src", nargs="*", default=[],
                    help="other kan_sparse_gemm.cu sources timed beside the repository's")
    ap.add_argument("--gather-src", nargs="*", default=[],
                    help="other paged_gather.cu sources timed beside the repository's")
    ap.add_argument("--variants", default="",
                    help="comma-separated variants of the decode kernels to build and time "
                         "(default: all of each design's; base always)")
    args = ap.parse_args()
    only = set(args.only.split(","))
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
    result = {"card": cs.card_line()}

    jobs = {"empty": ("empty", EMPTY_KERNEL)}
    if "int8" in only:
        result["sass"] = sass_counts(build)
        log(f"[sass] kan_int8_gemm: {json.dumps(result['sass'])}")
        jobs |= {f"int8_{v}": ("kan_int8_gemm", variant_source("kan_int8_gemm", subs))
                 for v, subs in INT8_VARIANTS.items()}
        jobs["int8_clocks"] = ("kan_int8_gemm", variant_source("kan_int8_gemm", CLOCKS) +
                               '\nextern "C" int copy_clocks(void* dst, long long n) {\n'
                               '  return (int)cudaMemcpyFromSymbol(dst, g_clocks, n * 8);\n}\n')
    if "fused" in only:
        jobs |= {f"fused_{v}": ("kan_fused_gemm", variant_source("kan_fused_gemm", subs))
                 for v, subs in FUSED_VARIANTS.items()}
    variants = set(args.variants.split(",")) if args.variants else None
    decode = {"sparse_int8": ("kan_sparse_int8_gemm", args.sparse_int8_src),
              "sparse": ("kan_sparse_gemm", args.sparse_src),
              "gather": ("paged_gather", args.gather_src)}
    sources = {}
    for tag, (lib, extra) in decode.items():
        if tag in only:
            texts = {"repo": (CSRC / f"{lib}.cu").read_text()}
            texts |= {Path(f).stem: Path(f).read_text() for f in extra}
            more, sources[tag] = design_jobs(lib, tag, texts, variants)
            jobs |= more
    libs = build_variants(build, jobs)
    cycles_per_ms = cs.spin_cycles_per_ms(torch)

    empty = libs["empty"]
    empty.empty_launch.argtypes, empty.empty_launch.restype = [ctypes.c_void_p], ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    result["empty_kernel_ms"] = cs.time_ms(torch, [lambda: empty.empty_launch(stream)],
                                           cycles_per_ms)
    log(f"[empty] an empty kernel through time_ms: {result['empty_kernel_ms']:.4f} ms")

    if "sparse" in only:
        result["sparse"] = decode_section(
            torch, np, cs, "kan_sparse_gemm", "sparse", sparse_cases(torch, cs, SplineGrid, ops),
            sources["sparse"], libs, cycles_per_ms, variants)
    if "sparse_int8" in only:
        result["sparse_int8"] = decode_section(
            torch, np, cs, "kan_sparse_int8_gemm", "sparse_int8",
            sparse_int8_cases(torch, cs, Q, SplineGrid, ops), sources["sparse_int8"], libs,
            cycles_per_ms, variants)
    if "gather" in only:
        result["gather"] = gather_section(torch, np, cs, sources["gather"], libs, cycles_per_ms,
                                          variants)
    if "int8" in only:
        result["int8"] = int8_section(torch, np, cs, Q, SplineGrid, ops, libs, cycles_per_ms)
    if "fused" in only:
        result["fused"] = fused_section(torch, cs, SplineGrid, ops, libs, cycles_per_ms)
    build._loaded.clear()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
