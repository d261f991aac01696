// Compact N:M sparse KAN GEMV on the int8 datapath for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/kan_sparse_gemm.py
// (_sparse_int8_kernel, launched by kan_sparse_int8_gemm_pallas): the
// integer Align/Compare (Eq. 5) and uint8 ROM values of kan_int8_gemm, but
// each input contracts only its P+1 values against the int8 coefficient
// slab C[j, k-P .. k, :] it touches; int32 accumulation; optionally the
// per-channel dequant epilogue.  Its integers are kan_int8_gemm's: the same
// address arithmetic, the same ROM bytes, exact integer sums (in any order).
//
// Bound on an H100 SXM: the bytes of x_q, of the touched int8 slab rows and
// of y.  CF-KAN layer 1 at 8 rows (K = 2810, N = 512, M = 5): the rows'
// windows touch the 7.2 MB of int8 coefficients, ~2.2 us; the
// 2*8*2810*4*512 = 92 M operations take 0.05 us at the int8 tensor-core rate.
// MNIST-KAN layer 1 at 8 rows (784 -> 64, M = 13) moves 0.65 MB, ~0.2 us:
// there a call is a chain of latencies (launch, one trip to device memory,
// the split-K sums), not a stream of bytes, and the design shortens it.
//
// Design, ONE launch:
//   * a block holds up to 8 rows, a column tile of 4*TQ columns (TQ = the
//     power of two that covers N/4, at most 32, so every thread has a
//     column where N is a multiple of 4*TQ, as at N = 32, 64 and 512) and a
//     K slice of JS inputs,
//     JS a whole number of rounds of TJ inputs; JS is chosen from (BS, K, N)
//     and the SM count for about two blocks per SM, at most 24 KB of
//     coefficients a block.  8 x 784 -> 64: 49 blocks of 16 inputs (one
//     round: fewer, fuller blocks beat the 98 blocks of 128 threads, whose
//     atomics took longer); 8 x 2810 -> 512: 4 x 88 blocks of 32 inputs;
//   * 256 threads: TQ along the columns, each owning 4 consecutive columns,
//     and TJ = 256/TQ along the slice's inputs;
//   * everything a block reads is asked for at once, before any of it is
//     used: x_q and the epilogue's scales into registers, the ROM
//     (build_lut_u8, S x ceil((P+1)/2) bytes) and the slice's coefficient
//     rows C[j, 0..M-1, tile] into shared memory by 16-byte cp.async
//     (zero-filled at ragged edges), the coefficients in four groups so
//     that the contraction of the first inputs overlaps the copies of the
//     last.  All M rows are copied: which rows the windows touch is known
//     only once x_q has arrived, and at 8 rows their union is nearly every
//     row (all 5 at M = 5, ~95 % at M = 13);
//   * per (row, input) the block keeps one packed word of (window offset,
//     P+1 ROM values as u8), not a zeroed M-wide band;
//   * per (row, input) a thread reads the P+1 touched coefficient words of
//     its 4 columns (one 32-bit shared load each), transposes them with
//     __byte_perm into 4 words of P+1 signed bytes, one per column, and
//     takes one dp4a (u8 x s8 -> s32; P+1 <= 4 always fits) per column:
//     exact, and no multiply by a zero slot of the band;
//   * the TJ input lanes are summed in shared memory, so a block adds each
//     of its (row, column) sums once with an int32 atomic into the
//     accumulator in device memory (integer addition: exact in any order, so
//     the result is deterministic); the block that finishes a tile last (a
//     ticket counter per tile) reads the tile's sums, applies the epilogue,
//     and leaves accumulator and ticket zero for the next launch.  (Summing
//     a cluster's slices through distributed shared memory first, for one
//     atomic and one ticket per 8 slices, was slower: its cluster barriers
//     cost more than the atomics they saved.)
// |sum| < 2^31 holds for K < 16,500 (255 x 127 x 4 per input).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py; the
// previous design, a MAXM-wide band per (row, input) and byte loads, in
// brackets): 0.0074 ms at 8 x 784 -> 64 (0.0507) and 0.0161 ms at
// 8 x 2810 -> 512 (0.0442), against 0.0081 and 0.0175 ms for a bf16
// matmul over the materialised band; an empty kernel takes 0.0018 ms
// through the same timer.  The split-K atomics, ticket and epilogue are
// the largest phase (tools/kernel_breakdown.py).
#include "kan_common.cuh"

namespace {

constexpr int kRows = 8;                // rows per block
constexpr int kThreads = 256;
constexpr int kChunks = 4;              // cp.async groups of a slice's coefficients
constexpr int kMaxJS = 64;              // inputs per slice, at most
constexpr int kMaxCoeffBytes = 24576;   // a slice's staged coefficients, at most
constexpr int kBlocksPerSM = 2;         // the split's target
constexpr int kPairs = kRows * kMaxJS / kThreads;   // (row, input) pairs per thread, at most
constexpr int kOut = kRows * 128 / kThreads;        // a tile's outputs per thread, at most

// Threads along the columns: the power of two that covers N/4, at most 32.
int tile_quads(int N) {
  int tq = kThreads / kMaxJS;           // so that TJ = kThreads/TQ <= kMaxJS
  while (tq < 32 && 4 * tq < N) tq *= 2;
  return tq;
}

// Bytes of the shared area that holds a slice's coefficients, then the
// input lanes' sums (TJ x kRows x CT int32, 16 KB), rounded to 16.
__host__ __device__ __forceinline__ int area_bytes(int JS, int M, int CT) {
  return (max(JS * M * CT, kThreads / (CT / 4) * kRows * CT * 4) + 15) / 16 * 16;
}

// d = c + sum_i a.u8[i] * b.s8[i]
__device__ __forceinline__ int dp4a_us(unsigned a, unsigned b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The P+1 words a[i] = C[j, m0+i, n..n+3] turned into one word per column
// c (bytes i = C[j, m0+i, n+c]).  Bytes past P are left over from the
// network; the ROM word is zero there.
template <int P>
__device__ __forceinline__ void columns(const unsigned* a, unsigned* col) {
  if constexpr (P == 1) {
    col[0] = __byte_perm(a[0], a[1], 0x0040);
    col[1] = __byte_perm(a[0], a[1], 0x0051);
    col[2] = __byte_perm(a[0], a[1], 0x0062);
    col[3] = __byte_perm(a[0], a[1], 0x0073);
  } else {
    unsigned a3 = 0u;
    if constexpr (P == 3) a3 = a[3];
    const unsigned lo01 = __byte_perm(a[0], a[1], 0x5140), hi01 = __byte_perm(a[0], a[1], 0x7362);
    const unsigned lo23 = __byte_perm(a[2], a3, 0x5140), hi23 = __byte_perm(a[2], a3, 0x7362);
    col[0] = __byte_perm(lo01, lo23, 0x5410);
    col[1] = __byte_perm(lo01, lo23, 0x7632);
    col[2] = __byte_perm(hi01, hi23, 0x5410);
    col[3] = __byte_perm(hi01, hi23, 0x7632);
  }
}

// Copy the coefficient rows of slice inputs [jj0, jj1) (all M rows, the
// tile's CT columns) into c_s; rows past K and columns past N are zeros.
template <bool VEC>
__device__ __forceinline__ void copy_coeff(uint8_t* c_s, const int8_t* __restrict__ coeff,
                                           int j0, int jj0, int jj1, int K, int M, int N,
                                           int n0, int CT, int tid) {
  if constexpr (VEC) {
    const int per_row = CT / 16;
    for (int e = jj0 * M * per_row + tid; e < jj1 * M * per_row; e += kThreads) {
      const int row = e / per_row, c = (e % per_row) * 16;
      const int j = j0 + row / M;
      const bool ok = j < K && n0 + c < N;
      kan::cp_async<16>(c_s + row * CT + c,
                        ok ? coeff + ((size_t)j0 * M + row) * N + n0 + c : coeff, ok ? 16 : 0);
    }
  } else {
    for (int e = jj0 * M * CT + tid; e < jj1 * M * CT; e += kThreads) {
      const int row = e / CT, c = e % CT;
      const int j = j0 + row / M;
      c_s[row * CT + c] = (j < K && n0 + c < N)
          ? (uint8_t)coeff[((size_t)j0 * M + row) * N + n0 + c] : (uint8_t)0;
    }
  }
}

template <int P, bool VEC>
__global__ void __launch_bounds__(kThreads)
kan_sparse_int8_kernel(const int* __restrict__ x_q, const int8_t* __restrict__ coeff,
                       const float* __restrict__ scale, const uint8_t* __restrict__ rom,
                       int* __restrict__ sums, unsigned* __restrict__ tickets,
                       void* __restrict__ y, int BS, int K, int N, int M, int G, int S,
                       int qmax, int out, int TQ, int JS, int tiles_n) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ bool last_s;
  constexpr int half = (P + 2) / 2;
  const int CT = 4 * TQ, TJ = kThreads / TQ;
  const int coeff_bytes = area_bytes(JS, M, CT);
  uint8_t* c_s = smem;
  int2* info_s = reinterpret_cast<int2*>(smem + coeff_bytes);      // [kRows][JS]
  uint8_t* rom_s = smem + coeff_bytes + kRows * JS * sizeof(int2);

  const int tid = threadIdx.x;
  const int tq = tid % TQ, tj = tid / TQ;
  const int tile = blockIdx.x;
  const int n0 = (tile % tiles_n) * CT, r0 = (tile / tiles_n) * kRows;
  const int j0 = blockIdx.y * JS;
  const int nrows = min(kRows, BS - r0);
  const int npairs = kRows * JS;

  // 1. Ask for everything: x_q into registers, the ROM and the slice's
  //    coefficients (kChunks groups) into shared memory.
  int xv[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int p = tid + q * kThreads, r = p / JS, j = j0 + p % JS;
    xv[q] = (p < npairs && r < nrows && j < K) ? __ldg(&x_q[(size_t)(r0 + r) * K + j]) : 0;
  }
  float sc[kOut];                       // the epilogue's scales, in case this block is last
#pragma unroll
  for (int q = 0; q < kOut; ++q) {
    const int n = n0 + (tid + q * kThreads) % CT;
    sc[q] = (out != 2 && n < N) ? __ldg(&scale[n]) : 0.0f;
  }
  const int rom_bytes = S * half;
  for (int e = tid * 16; e < rom_bytes; e += kThreads * 16)
    kan::cp_async<16>(rom_s + e, rom + e, min(16, rom_bytes - e));
  kan::cp_async_commit();
  const int rounds = JS / TJ, per_chunk = (rounds + kChunks - 1) / kChunks;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int jj0 = min(JS, c * per_chunk * TJ), jj1 = min(JS, (c + 1) * per_chunk * TJ);
    copy_coeff<VEC>(c_s, coeff, j0, jj0, jj1, K, M, N, n0, CT, tid);
    kan::cp_async_commit();
  }

  // 2. Align/Compare + ROM: per (row, input) the word offset of its window's
  //    first coefficient row in c_s and its P+1 ROM values packed as u8.
  kan::cp_async_wait<kChunks>();
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int p = tid + q * kThreads, r = p / JS, jj = p % JS;
    if (p < npairs) {
      int2 info = make_int2(0, 0);                 // masked: adds nothing
      if (r < nrows && j0 + jj < K) {
        int addr, vals[P + 1];
        const int k = kan::int_address<P>(xv[q], G, M, qmax, S, &addr);
        kan::rom_fetch<P>(rom_s, S, addr, vals);
        unsigned w = 0u;
#pragma unroll
        for (int i = 0; i <= P; ++i) w |= (unsigned)vals[i] << (8 * i);
        info = make_int2((jj * M + k - P) * CT / 4, (int)w);
      }
      info_s[p] = info;
    }
  }

  // 3. The contraction, chunk by chunk as the copies land: per (row, input)
  //    P+1 shared loads, the byte transpose and one dp4a per column.
  int acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;
  const unsigned* c32 = reinterpret_cast<const unsigned*>(c_s) + tq;
  const int ctw = CT / 4;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c == 0) kan::cp_async_wait<kChunks - 1>();
    else if (c == 1) kan::cp_async_wait<kChunks - 2>();
    else if (c == 2) kan::cp_async_wait<kChunks - 3>();
    else kan::cp_async_wait<0>();
    __syncthreads();
    const int q1 = min(rounds, (c + 1) * per_chunk);
    for (int q = c * per_chunk; q < q1; ++q) {
      const int jj = q * TJ + tj;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nrows) {
          const int2 info = info_s[r * JS + jj];
          const unsigned* w = c32 + info.x;
          unsigned a[P + 1], col[4];
#pragma unroll
          for (int i = 0; i <= P; ++i) a[i] = w[i * ctw];
          columns<P>(a, col);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] = dp4a_us((unsigned)info.y, col[cc], acc[r][cc]);
        }
      }
    }
  }

  // 4. Sum the TJ input lanes in shared memory (over the coefficients),
  //    then one atomic per (row, column) of the block.
  __syncthreads();
  int* lane_s = reinterpret_cast<int*>(c_s);                     // [TJ][kRows][CT]
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    *reinterpret_cast<int4*>(lane_s + (tj * kRows + r) * CT + 4 * tq) =
        make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int o = tid; o < kRows * CT; o += kThreads) {
    const int r = o / CT, c = o % CT;
    if (r < nrows && n0 + c < N) {
      int s = 0;
      for (int l = 0; l < TJ; ++l) s += lane_s[(l * kRows + r) * CT + c];
      atomicAdd(&sums[(size_t)(r0 + r) * N + n0 + c], s);
    }
  }

  // 5. The last slice of this tile to finish writes the tile.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&tickets[tile], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
#pragma unroll
  for (int q = 0; q < kOut; ++q) {
    const int o = tid + q * kThreads, r = o / CT, n = n0 + o % CT;
    if (o < kRows * CT && r < nrows && n < N) {
      const size_t i = (size_t)(r0 + r) * N + n;
      const int s = __ldcg(&sums[i]);
      sums[i] = 0;                      // zero for the next launch
      if (out == 2) {
        static_cast<int*>(y)[i] = s;
      } else {
        const float v = (float)s * sc[q];               // dequant epilogue
        if (out == 0) static_cast<float*>(y)[i] = v;
        else static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(v);
      }
    }
  }
  if (tid == 0) tickets[tile] = 0u;   // ready for the next launch on this workspace
}

struct Split {
  int TQ, tiles_n, row_blocks, JS, slices;
};

// The tiling of a call at (BS, K, N, M): column tiles, row blocks, and the
// K slice that brings the grid to about kBlocksPerSM blocks per SM.
Split split(int BS, int K, int N, int M) {
  Split s;
  s.TQ = tile_quads(N);
  const int CT = 4 * s.TQ, TJ = kThreads / s.TQ;
  s.tiles_n = (N + CT - 1) / CT;
  s.row_blocks = (BS + kRows - 1) / kRows;
  const int tiles = s.tiles_n * s.row_blocks;
  const int want = max(1, kBlocksPerSM * kan::sm_count() / tiles);
  int js = (K + want - 1) / want;
  js = (js + TJ - 1) / TJ * TJ;                                  // whole rounds of TJ inputs
  const int cap = max(TJ, min(kMaxJS, kMaxCoeffBytes / (M * CT)) / TJ * TJ);
  s.JS = min(js, cap);
  s.slices = (K + s.JS - 1) / s.JS;
  return s;
}

// The instantiations, numbered (P-1) * 2 + VEC.
constexpr int kInsts = 3 * 2;

const void* kernel_of(int inst) {
  const bool vec = inst % 2 == 1;
  switch (inst / 2) {
    case 0: return vec ? (const void*)kan_sparse_int8_kernel<1, true>
                       : (const void*)kan_sparse_int8_kernel<1, false>;
    case 1: return vec ? (const void*)kan_sparse_int8_kernel<2, true>
                       : (const void*)kan_sparse_int8_kernel<2, false>;
    default: return vec ? (const void*)kan_sparse_int8_kernel<3, true>
                        : (const void*)kan_sparse_int8_kernel<3, false>;
  }
}

// the dynamic shared memory granted so far, per instantiation and device
int granted[kInsts][64] = {};

}  // namespace

// The launch plan of a call (kan_common.cuh: PlanField), which the launcher
// below computes with this function; kernel fields: TQ, JS, column tiles.
// `align`: ptr_align of coeff.  Returns a cudaError_t.
extern "C" int kan_sparse_int8_gemm_plan(int BS, int K, int N, int M, int P, int S, int align,
                                         int* plan) {
  kan::plan_clear(plan);
  if (P < 1 || P > 3 || M <= P || M > 16 || S < 2 || S * ((P + 2) / 2) > 16384 || BS < 1 ||
      K < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const Split s = split(BS, K, N, M);
  const int CT = 4 * s.TQ;
  const bool vec = N % 16 == 0 && align % 16 == 0;
  plan[kan::kGridX] = s.tiles_n * s.row_blocks;
  plan[kan::kGridY] = s.slices;
  plan[kan::kGridZ] = 1;
  plan[kan::kBlockThreads] = kThreads;
  plan[kan::kDynSmem] = area_bytes(s.JS, M, CT) + kRows * s.JS * (int)sizeof(int2) +
                        (S * ((P + 2) / 2) + 15) / 16 * 16;
  plan[kan::kGrant] = plan[kan::kDynSmem];
  plan[kan::kVecBytes] = vec ? 16 : 1;
  plan[kan::kInst] = (P - 1) * 2 + (int)vec;
  plan[kan::kSms] = kan::sm_count();
  plan[kan::kExtra] = s.TQ;
  plan[kan::kExtra + 1] = s.JS;
  plan[kan::kExtra + 2] = s.tiles_n;
  return 0;
}

// Workspace of one call at (BS, K, N), in two buffers the caller keeps,
// both zero before a call and left zero by it: the ticket counters, one
// uint32 per column tile and row block, and the int32 accumulators (BS, N).
extern "C" long long kan_sparse_int8_gemm_tickets(int BS, int N) {
  const int CT = 4 * tile_quads(N);
  return (long long)((N + CT - 1) / CT) * ((BS + kRows - 1) / kRows);
}
extern "C" long long kan_sparse_int8_gemm_accumulators(int BS, int K, int N) {
  return (long long)BS * N;
}

// Compiled for P in {1, 2, 3} and M = G+P <= 16; the ROM must fit 16 KB of
// shared memory.  out codes: 0 = float32, 1 = bfloat16 (scale given),
// 2 = int32 (no scale).  Returns a cudaError_t (0 = success).
extern "C" int kan_sparse_int8_gemm(const void* x_q, const void* coeff, const void* scale,
                                    const void* rom, void* tickets, void* sums, void* y,
                                    int BS, int K, int N, int M, int G, int P, int S, int qmax,
                                    int out, void* stream) {
  if (M != G + P || qmax < 1) return (int)cudaErrorInvalidValue;
  if (!(out == 2 && scale == nullptr) && !((out == 0 || out == 1) && scale != nullptr))
    return (int)cudaErrorInvalidValue;
  int plan[kan::kPlanInts];
  const int err = kan_sparse_int8_gemm_plan(BS, K, N, M, P, S, kan::ptr_align(coeff), plan);
  if (err != 0) return err;
  int TQ = plan[kan::kExtra], JS = plan[kan::kExtra + 1], tiles_n = plan[kan::kExtra + 2];
  void* args[] = {&x_q, &coeff, &scale, &rom, &sums, &tickets, &y, &BS, &K, &N, &M, &G, &S,
                  &qmax, &out, &TQ, &JS, &tiles_n};
  const int inst = plan[kan::kInst];
  return kan::launch_planned(kernel_of(inst), plan, args, static_cast<cudaStream_t>(stream),
                             granted[inst]);
}
