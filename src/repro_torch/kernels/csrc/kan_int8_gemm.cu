// Integer-only fused KAN GEMM for Hopper (sm_90a) on the int8 tensor cores.
//
// Replaces the TPU kernel repro/kernels/kan_int8_gemm.py (_int8_kernel,
// launched by kan_int8_gemm_pallas): integer Align/Compare (Eq. 5), the
// uint8 ROM values, the dense u8 band (band_scatter), an int8 GEMM with
// exact int32 accumulation, and optionally the per-channel dequant epilogue
// (float(acc) * scale[n], rounded once to fp32 or bf16), in ONE launch.
// Without a scale it stores the int32 accumulator.
//
// Bound on an H100 SXM: the function needs (P+1) products per input and
// output, 2*rows*K*(P+1)*N int8 operations against the 1,979 TOPS int8
// tensor-core rate, and moves x_q (int32), C (int8) and y once.  At
// MNIST-KAN layer 1 (2048 x 784 -> 64, M = 13) that is 0.82 G operations
// (0.4 us) against 6.4 MB + 0.65 MB + 0.5 MB (2.3 us): bound by bytes and,
// on chip, by the B-spline unit (1.6 M address computations and ROM
// fetches).  At CF-KAN layer 1 (2048 x 2810 -> 512, M = 5) the dense band
// is 29.5 G operations, 12 us at the tensor cores' rate.
//
// Design:
//   * tensor cores: mma.sync.m16n8k32.row.col.s32.u8.s8.s32.  A is the band,
//     UNSIGNED bytes (up to 255 for P = 3 at value scale 256; they never
//     pass through s8), B the int8 coefficients, the accumulator s32 and
//     exact: |acc| <= K*(P+1)*255*127 < 2^31 for K < 16,500;
//   * a block computes a 64 x BN output tile, BN = 64 (4 warps) where
//     N <= 64, else 128 (8 warps), in warp tiles of 32 x 32.  The band is
//     rebuilt for every column tile, so the wider tile halves that work at
//     CF-KAN's N = 512.  Per K step of BK = min(128/M, 32) inputs it writes
//     the (64, 128) u8 band into shared memory (K-contiguous rows, pitch 144
//     bytes so the fragment loads do not conflict; input slots past K, rows
//     past BS and the padding past BK*M are zero bytes);
//   * the B-spline unit: the ROM (build_lut_u8's S x ceil((P+1)/2) bytes)
//     is copied into shared memory once per block, and from it the (k,
//     values) of each of the 256 8-bit codes, by kan_common.cuh's
//     Align/Compare and direct and inverted-address fetch.  An input whose
//     code is 0 .. 255 (every quantised activation) reads its values from
//     that table, any other code computes them the same way, so they are
//     the ROM's bytes by construction.  A thread builds its pairs in
//     batches of 4 (codes read, looked up, stored) so the latencies overlap;
//   * each step's BK*M rows of C (viewed as (K*M, N), N-contiguous; 16-byte
//     copies, element loads where N is not a multiple of 16) arrive by
//     cp.async in a ring of two stages, two steps ahead; x_q arrives in
//     super-tiles of q = max(2, 32/BK) steps (runs of up to 64 inputs a row,
//     16-byte copies, two buffers), because many short per-step row reads
//     saturate the SM's load queue.  The MMA takes B K-contiguous, so each
//     stage is transposed once in shared memory, 4 x 4 byte blocks by
//     __byte_perm into a swizzled C^T; the wrapper's (K, M, N) layout stays.
//     The band is double-buffered: two barriers a step;
//   * split-K where the output tiles leave resident block slots empty
//     (MNIST-KAN: 32 tiles of N = 64): the K steps are shared out over
//     gridDim.z slices, as many as fill one wave, whose int32 sums are added
//     into a workspace with atomics (integer addition: exact in any order);
//     the last slice of an output tile (a ticket counter per tile) applies
//     the epilogue and leaves sums and ticket zero for the next launch.  With
//     one slice the epilogue stores straight from the accumulators.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py; the
// previous design, a 64 x 64 SIMT tile of int32 IMADs, in brackets):
// 0.0486 ms at MNIST-KAN layer 1 (0.8415) and 0.2755 ms at CF-KAN layer 1
// (2.0272), against 0.0218 and 0.1189 ms for a bf16 matmul over the
// materialised band.  What holds it back is not the MMA rate but
// shared-memory traffic and the chain of barriers and copies a K step
// needs (tools/kernel_breakdown.py times each phase); wgmma with TMA-fed,
// warp-specialised stages is the next design.
#include "kan_common.cuh"

namespace {

constexpr int kBM = 64;            // output rows per block
constexpr int kW = 128;            // band bytes per K step: BK * M <= kW, zero-padded
constexpr int kPitch = kW + 16;    // shared row pitch of the band and of C^T (bytes)
constexpr int kStages = 2;         // cp.async ring of coefficient rows
constexpr int kMaxRomBytes = 16384;
constexpr int kCodes = 256;        // x_q codes whose (k, values) a block tabulates

// Byte offsets of the dynamic shared memory of one launch: a ring of
// stages of C's rows ((kW, BN) bytes each), two buffers of the u8 band
// (kBM, kPitch), one of C^T (BN, kPitch), two of x_q super-tiles (kBM, xp)
// int32, the code table (kCodes packed values, then kCodes k), the ROM.
// A super-tile holds the inputs of q >= 2 K steps: x_q is read in runs of
// up to 64 inputs a row instead of BK, so far fewer, fuller requests.
struct Layout {
  int q, xp, xlg, band, bt, xs, xbuf, tab, rom, total;
};
__host__ __device__ inline Layout layout(int BN, int BK, int rom_bytes) {
  Layout L;
  L.q = max(2, 32 / BK);
  // a row from the aligned element at or before its first input: up to 3
  // leading elements, q*BK inputs, the tail of the last 16-byte chunk; a
  // pitch of 4 x odd ints spreads the band builder's reads over banks
  L.xp = (L.q * BK + 6) / 4 * 4;
  if ((L.xp / 4) % 2 == 0) L.xp += 4;
  L.xlg = 0;
  while ((1 << L.xlg) < L.xp / 4) ++L.xlg;
  L.band = kStages * kW * BN;
  L.bt = L.band + 2 * kBM * kPitch;
  L.xs = L.bt + BN * kPitch;
  L.xbuf = kBM * L.xp * 4;
  L.tab = L.xs + 2 * L.xbuf;
  L.rom = L.tab + kCodes * 5;
  L.total = L.rom + (rom_bytes + 15) / 16 * 16;
  return L;
}

__device__ __forceinline__ void mma_u8s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const uint8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// C^T row n keeps its 4-byte K word w at word w ^ swz(n): the transposing
// writes of 8 column chunks then fall in distinct banks, and a warp's
// fragment loads (8 consecutive n, one swizzle) still do.
__device__ __forceinline__ int swz(int n) { return ((n >> 4) & 7) << 2; }

// o[j] byte i = w[i] byte j: the transpose of a 4 x 4 byte block.
__device__ __forceinline__ void transpose4x4(const unsigned* w, unsigned* o) {
  const unsigned t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[2], w[3], 0x5140);
  const unsigned t2 = __byte_perm(w[0], w[1], 0x7362), t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// The P+1 ROM values of code x_q, one byte each, ascending basis index;
// returns k (kan_common.cuh's Align/Compare and ROM fetch).
template <int P>
__device__ __noinline__ int code_values(int x_q, const uint8_t* rom_s, int G, int M, int qmax,
                                           int S, unsigned* packed) {
  int addr, vals[P + 1];
  const int k = kan::int_address<P>(x_q, G, M, qmax, S, &addr);
  kan::rom_fetch<P>(rom_s, S, addr, vals);
  unsigned w = 0u;
#pragma unroll
  for (int i = 0; i <= P; ++i) w |= (unsigned)vals[i] << (8 * i);
  *packed = w;
  return k;
}

// Super-tile u of the block's x_q rows (inputs j0 .. j0+nj-1) into xs:
// row r from the aligned element at or before its first input, 16-byte
// copies (x_q is 16-byte aligned, checked by the launcher); a chunk that
// runs past the end of x_q reads only what is there.  Rows past BS are
// not copied (the band builder skips them).
template <int THREADS>
__device__ __forceinline__ void load_x(int* xs, const Layout& L, const int* __restrict__ x_q,
                                       int j0, int nj, int BS, int K, int m0, int tid) {
  const size_t total = (size_t)BS * K;
  for (int e = tid; e < (kBM << L.xlg); e += THREADS) {
    const int r = e >> L.xlg, c = e & ((1 << L.xlg) - 1);
    if (m0 + r >= BS || 4 * c >= L.xp) continue;
    const size_t first = (size_t)(m0 + r) * K + j0, e0 = (first & ~(size_t)3) + 4 * c;
    if (e0 >= first + nj) continue;
    kan::cp_async<16>(xs + r * L.xp + 4 * c, x_q + e0, (int)(min((size_t)4, total - e0) * 4));
  }
}

// Stage the BK*M rows of C (K*M, N) that K step `step` multiplies, columns
// n0 .. n0+BN-1.  What is not copied (rows past the step's inputs, columns
// past N) keeps stale bytes: the band is zero there or the column is never
// stored, and integer products of finite values are exact.
template <int BN, bool VEC>
__device__ __forceinline__ void load_stage(uint8_t* stage, const int8_t* __restrict__ coeff,
                                           int step, int BK, int M, int K, int N, int n0,
                                           int tid) {
  constexpr int kWarps = BN / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int j0 = step * BK, nj = min(BK, K - j0);
  const size_t r_lo = (size_t)j0 * M;
  const int rows = nj * M;
  if constexpr (VEC) {             // N % 16 == 0: a 16-byte chunk is all in or all out
    constexpr int kChunks = BN / 16;
    for (int e = tid; e < rows * kChunks; e += 2 * BN) {
      const int r = e / kChunks, c = (e % kChunks) * 16;
      if (n0 + c < N) kan::cp_async<16>(stage + r * BN + c, coeff + (r_lo + r) * N + n0 + c, 16);
    }
  } else {                         // element loads, 8 in flight per thread
    const int nc = min(BN, N - n0);
    for (int c = lane; c < nc; c += 32)
      for (int r0 = warp; r0 < rows; r0 += 8 * kWarps) {
        int8_t v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r0 + u * kWarps;
          v[u] = r < rows ? coeff[(r_lo + r) * N + n0 + c] : 0;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r0 + u * kWarps;
          if (r < rows) stage[r * BN + c] = (uint8_t)v[u];
        }
      }
  }
}

template <int OUT>
__device__ __forceinline__ void store_out(void* y, size_t o, int acc, const float* scale, int n) {
  if constexpr (OUT == 2) {
    static_cast<int*>(y)[o] = acc;
  } else {
    const float v = (float)acc * scale[n];   // dequant epilogue, one rounding
    if constexpr (OUT == 0) static_cast<float*>(y)[o] = v;
    else static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16(v);
  }
}

// out: 0 = float32, 1 = bfloat16 (both through scale), 2 = int32 accumulator.
// BN output columns per block, BN/16 warps in a 2 x (BN/32) grid of 32 x 32.
template <int P, int OUT, int BN, bool VEC>
__global__ void __launch_bounds__(2 * BN, BN == 128 ? 2 : 1)
kan_int8_kernel(const int* __restrict__ x_q, const int8_t* __restrict__ coeff,
                const float* __restrict__ scale, const uint8_t* __restrict__ rom,
                int* __restrict__ sums, unsigned* __restrict__ tickets, void* __restrict__ y,
                int BS, int K, int N, int M, int G, int S, int qmax, int BK,
                int steps_per_split) {
  constexpr int kThreads = 2 * BN;
  constexpr int half = (P + 2) / 2;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ bool last_s;
  const Layout L = layout(BN, BK, S * half);
  uint8_t* rom_s = smem + L.rom;
  unsigned* tab_v = reinterpret_cast<unsigned*>(smem + L.tab);
  uint8_t* tab_k = smem + L.tab + kCodes * 4;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int steps = (K + BK - 1) / BK;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(steps, s_begin + steps_per_split);

  // The ROM (zero-filled to a whole 16-byte chunk), then the B-spline
  // unit's answer for every 8-bit code, once per block: what a quantised
  // activation (0 .. 255 at 8 bits) looks up below.
  for (int c = tid; c * 16 < S * half; c += kThreads)
    kan::cp_async<16>(rom_s + 16 * c, rom + 16 * c, min(16, S * half - 16 * c));
  kan::cp_async_commit();
  // The first two stages of C and the first two x_q super-tiles, in flight
  // while the table is built.
  int* xs0 = reinterpret_cast<int*>(smem + L.xs);
  const int xw = L.q * BK;                         // inputs per super-tile
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (s_begin + st < s_end)
      load_stage<BN, VEC>(smem + st * kW * BN, coeff, s_begin + st, BK, M, K, N, n0, tid);
    const int j0x = (s_begin + st * L.q) * BK;
    if (s_begin + st * L.q < s_end)
      load_x<kThreads>(xs0 + st * (L.xbuf / 4), L, x_q, j0x, min(xw, K - j0x), BS, K, m0, tid);
    kan::cp_async_commit();
  }
  kan::cp_async_wait<kStages>();                   // the ROM group
  __syncthreads();
  for (int v = tid; v < kCodes; v += kThreads)
    tab_k[v] = (uint8_t)code_values<P>(v, rom_s, G, M, qmax, S, &tab_v[v]);

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  for (int s = s_begin; s < s_end; ++s) {
    const int it = s - s_begin;
    uint8_t* stage = smem + (it % kStages) * kW * BN;
    uint8_t* a_s = smem + L.band + (it % 2) * kBM * kPitch;   // read two steps ago at most
    uint8_t* bt_s = smem + L.bt;   // written after the barrier that ends step s-1's MMAs
    const int u = it / L.q;                           // this step's x_q super-tile
    const int* xs = xs0 + (u % 2) * (L.xbuf / 4) + (it % L.q) * BK;
    const int j0x = (s_begin + u * L.q) * BK;
    // 1. This step's stage has landed; zero the band (input slots past K,
    //    rows past BS and the padding past BK*M stay zero bytes).
    kan::cp_async_wait<kStages - 1>();
    for (int e = tid; e < kBM * kPitch / 16; e += kThreads)
      reinterpret_cast<uint4*>(a_s)[e] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    // 2. Align/Compare + ROM: the P+1 values of each input at k-P .. k.
    const int j0 = s * BK;
    // (row, input) pairs, a warp covering 8 rows x 4 inputs so its byte
    // stores spread over banks; in batches of 4 a thread: codes read, then
    // looked up, then stored, so the shared-memory latencies overlap.
    constexpr int kBatch = 4;
    for (int p0 = tid; p0 < kBM * ((BK + 3) & ~3); p0 += kBatch * kThreads) {
      int xv[kBatch], kv[kBatch];
      unsigned wv[kBatch], valid = 0u;
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int p = p0 + q * kThreads;
        const int r = (p & 7) | ((p >> 2) & 56), jj = ((p >> 3) & 3) | ((p >> 8) << 2);
        if (r < kBM && m0 + r < BS && jj < BK && j0 + jj < K) {
          const int lead = (int)(((unsigned)(m0 + r) * (unsigned)K + (unsigned)j0x) & 3u);
          xv[q] = xs[r * L.xp + lead + jj];
          valid |= 1u << q;
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (!((valid >> q) & 1u)) continue;
        if ((unsigned)xv[q] < (unsigned)kCodes) {
          wv[q] = tab_v[xv[q]];
          kv[q] = tab_k[xv[q]];
        } else {
          kv[q] = code_values<P>(xv[q], rom_s, G, M, qmax, S, &wv[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (!((valid >> q) & 1u)) continue;
        const int p = p0 + q * kThreads;
        const int r = (p & 7) | ((p >> 2) & 56), jj = ((p >> 3) & 3) | ((p >> 8) << 2);
        uint8_t* band = a_s + r * kPitch + jj * M + kv[q] - P;
#pragma unroll
        for (int i = 0; i <= P; ++i) band[i] = (uint8_t)(wv[q] >> (8 * i));
      }
    }
    //    ... and C's rows transposed so that each output column's K values
    //    are contiguous, as the MMA takes B.
    for (int u = tid; u < (kW / 4) * (BN / 16); u += kThreads) {
      const int c = u % (BN / 16), kb = u / (BN / 16);
      uint4 rows4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rows4[i] = *reinterpret_cast<const uint4*>(stage + (kb * 4 + i) * BN + c * 16);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unsigned w[4], o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = reinterpret_cast<const unsigned*>(&rows4[i])[q];
        transpose4x4(w, o);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          const int n = c * 16 + q * 4 + jn;
          *reinterpret_cast<unsigned*>(bt_s + n * kPitch + (kb ^ swz(n)) * 4) = o[jn];
        }
      }
    }
    __syncthreads();
    // 3. Refill the stage just read with step s + kStages, and at the first
    //    step of super-tile u >= 1 the buffer of super-tile u-1 (whose last
    //    step has passed) with super-tile u+1: in flight during these MMAs
    //    and the next steps' bands, waited for q >= 2 steps later.
    if (s + kStages < s_end)
      load_stage<BN, VEC>(stage, coeff, s + kStages, BK, M, K, N, n0, tid);
    if (it % L.q == 0 && u >= 1 && s + L.q < s_end) {
      const int j0n = j0x + xw;
      load_x<kThreads>(xs0 + ((u + 1) % 2) * (L.xbuf / 4), L, x_q, j0n, min(xw, K - j0n), BS,
                       K, m0, tid);
    }
    kan::cp_async_commit();
    // 4. Exact integer contraction on the tensor cores.
#pragma unroll
    for (int kk = 0; kk < kW; kk += 32) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint8_t* ap = a_s + (wm + mt * 16 + g) * kPitch + kk + tig * 4;
        a[mt][0] = ld32(ap);
        a[mt][1] = ld32(ap + 8 * kPitch);
        a[mt][2] = ld32(ap + 16);
        a[mt][3] = ld32(ap + 8 * kPitch + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn + nt * 8 + g, w = kk / 4 + tig;
        b[nt][0] = ld32(bt_s + n * kPitch + (w ^ swz(n)) * 4);
        b[nt][1] = ld32(bt_s + n * kPitch + ((w + 4) ^ swz(n)) * 4);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_u8s8(acc[mt][nt], a[mt], b[nt]);
    }
  }

  // Accumulator fragment (mt, nt, i): row g (+8 for i >= 2), column
  // 2*tig (+1 for odd i) of the 16 x 8 tile.
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + wm + mt * 16 + g + (i >> 1) * 8;
        const int n = n0 + wn + nt * 8 + tig * 2 + (i & 1);
        if (row >= BS || n >= N) continue;
        const size_t o = (size_t)row * N + n;
        if (split) atomicAdd(&sums[o], acc[mt][nt][i]);
        else store_out<OUT>(y, o, acc[mt][nt][i], scale, n);
      }
  if (!split) return;

  // The last slice of this output tile to finish writes the tile.
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) last_s = atomicAdd(&tickets[tile], 1u) == gridDim.z - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int e = tid; e < kBM * BN; e += kThreads) {
    const int row = m0 + e / BN, n = n0 + e % BN;
    if (row >= BS || n >= N) continue;
    const size_t o = (size_t)row * N + n;
    const int v = __ldcg(&sums[o]);
    sums[o] = 0;                       // zero for the next launch
    store_out<OUT>(y, o, v, scale, n);
  }
  if (tid == 0) tickets[tile] = 0u;    // ready for the next launch on this workspace
}

int tile_n(int N) { return N <= 64 ? 64 : 128; }

// The instantiations, numbered ((P-1) * 3 + out) * 4 + (BN == 128) * 2 + VEC.
constexpr int kInsts = 3 * 3 * 4;

template <int P, int OUT>
const void* kernel_of_tile(int t) {
  switch (t) {
    case 0: return (const void*)kan_int8_kernel<P, OUT, 64, false>;
    case 1: return (const void*)kan_int8_kernel<P, OUT, 64, true>;
    case 2: return (const void*)kan_int8_kernel<P, OUT, 128, false>;
    default: return (const void*)kan_int8_kernel<P, OUT, 128, true>;
  }
}
template <int P>
const void* kernel_of_out(int out, int t) {
  return out == 0 ? kernel_of_tile<P, 0>(t)
                  : (out == 1 ? kernel_of_tile<P, 1>(t) : kernel_of_tile<P, 2>(t));
}
const void* kernel_of(int inst) {
  const int t = inst % 4, out = inst / 4 % 3, P = inst / 12 + 1;
  return P == 1 ? kernel_of_out<1>(out, t)
                : (P == 2 ? kernel_of_out<2>(out, t) : kernel_of_out<3>(out, t));
}

// the dynamic shared memory granted so far, per instantiation and device
int granted[kInsts][64] = {};

}  // namespace

// The launch plan of a call (kan_common.cuh: PlanField), which the launcher
// below computes with this function; kernel fields: BN, BK, K steps per
// slice.  `out`: the output code; `align`: ptr_align of coeff.  Grants the
// chosen instantiation this plan's shared memory and asks the occupancy
// calculator for its resident blocks per SM, which the split counts on.
// Returns a cudaError_t.
extern "C" int kan_int8_gemm_plan(int BS, int K, int N, int M, int P, int S, int out, int align,
                                  int* plan) {
  kan::plan_clear(plan);
  if (P < 1 || P > 3 || M <= P || M > 64 || S < 2 || S * ((P + 2) / 2) > kMaxRomBytes ||
      out < 0 || out > 2 || BS < 1 || K < 0 || N < 1)
    return (int)cudaErrorInvalidValue;
  const bool vec = N % 16 == 0 && align % 16 == 0;
  const int BN = tile_n(N);
  const int BK = min(kW / M, 32);
  const Layout L = layout(BN, BK, S * ((P + 2) / 2));
  const int inst = ((P - 1) * 3 + out) * 4 + (BN == 128) * 2 + (int)vec;
  const int sms = kan::sm_count();
  // granted first: the calculator counts no more than the grant
  int per_sm = 1;
  cudaError_t err = kan::grant_smem(kernel_of(inst), L.total, granted[inst]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(inst), 2 * BN,
                                                        L.total);
  if (err != cudaSuccess) return (int)err;
  // Split K only where the output tiles leave resident block slots empty:
  // as many slices as fill one wave, each a whole number of steps.
  const int steps = (K + BK - 1) / BK;
  const int tiles = ((N + BN - 1) / BN) * ((BS + kBM - 1) / kBM);
  int splits = min(max(1, per_sm * sms / tiles), max(steps, 1));
  const int per_split = max(1, (steps + splits - 1) / splits);
  splits = max(1, (steps + per_split - 1) / per_split);
  plan[kan::kGridX] = (N + BN - 1) / BN;
  plan[kan::kGridY] = (BS + kBM - 1) / kBM;
  plan[kan::kGridZ] = splits;
  plan[kan::kBlockThreads] = 2 * BN;
  plan[kan::kDynSmem] = L.total;
  plan[kan::kGrant] = L.total;
  plan[kan::kVecBytes] = vec ? 16 : 1;
  plan[kan::kInst] = inst;
  plan[kan::kSms] = sms;
  plan[kan::kPerSm] = per_sm;
  plan[kan::kExtra] = BN;
  plan[kan::kExtra + 1] = BK;
  plan[kan::kExtra + 2] = per_split;
  return 0;
}

// Workspace of one call at (BS, K, N), in two buffers the caller keeps,
// both zero before a call and left zero by it: the ticket counters, one
// uint32 per output tile, and the int32 accumulators (BS, N) of split K.
extern "C" long long kan_int8_gemm_tickets(int BS, int N) {
  return (long long)((N + tile_n(N) - 1) / tile_n(N)) * ((BS + kBM - 1) / kBM);
}
extern "C" long long kan_int8_gemm_accumulators(int BS, int K, int N) {
  return (long long)BS * N;
}

// Compiled for P in {1, 2, 3} and M = G+P <= 64; the ROM (S x ceil((P+1)/2)
// bytes) must fit 16 KB of shared memory.  out codes: 0 = float32,
// 1 = bfloat16 (scale given), 2 = int32 (no scale).  Returns a cudaError_t.
extern "C" int kan_int8_gemm(const void* x_q, const void* coeff, const void* scale,
                             const void* rom, void* tickets, void* sums, void* y, int BS, int K,
                             int N, int M, int G, int P, int S, int qmax, int out,
                             void* stream) {
  if (M != G + P || qmax < 1 || (out == 2) != (scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x_q) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  int plan[kan::kPlanInts];
  const int err = kan_int8_gemm_plan(BS, K, N, M, P, S, out, kan::ptr_align(coeff), plan);
  if (err != 0) return err;
  int BK = plan[kan::kExtra + 1], per_split = plan[kan::kExtra + 2];
  void* args[] = {&x_q, &coeff, &scale, &rom, &sums, &tickets, &y, &BS, &K, &N, &M, &G, &S,
                  &qmax, &BK, &per_split};
  return kan::launch_planned(kernel_of(plan[kan::kInst]), plan, args,
                             static_cast<cudaStream_t>(stream), nullptr);
}
