// Integer-only fused KAN GEMM for Hopper (sm_90a): the int8 datapath.
//
// Replaces the TPU kernel repro/kernels/kan_int8_gemm.py (_int8_kernel,
// launched by kan_int8_gemm_pallas): integer Align/Compare (Eq. 5), the
// uint8 ROM values, the dense u8 band (band_scatter), an int8 GEMM with
// int32 accumulation, and optionally the per-channel dequant epilogue
// (float(acc) * scale[n], rounded once to fp32 or bf16), in ONE launch.
// Without a scale it stores the int32 accumulator.
//
// Design (a plain tiled SIMT GEMM with exact integer MACs):
//   * block = 256 threads computing a 64 x 64 output tile, 4 x 4 per thread
//     (columns strided by 16 so shared-memory reads do not conflict);
//   * the ROM, build_lut_u8(P, S, lut_scale) as (S, ceil((P+1)/2)) bytes, is
//     copied into shared memory once per block; each input's P+1 values are
//     the direct and inverted-address fetch from it (kan_common.cuh), so they
//     are the table's bytes by construction.  The basis values are UNSIGNED
//     (up to 255 for P = 3 at scale 256) and never pass through s8;
//   * per K step of BK = 64/M inputs the threads write the dense (64, BK*M)
//     band of int32 values into shared memory, load the matching (BK*M, 64)
//     int8 rows of C widened to int32 (each thread's 16 loads issued at
//     once, before the band is built, so one device-memory latency per step
//     overlaps the address arithmetic), and accumulate a*b in int32
//     registers (exact: |acc| <= K*(P+1)*255*127 < 2^31 for K < 16,500);
//   * ragged edges are masked: an input past K or a row past BS contributes
//     zeros, and columns past N are not stored.
//
// Bound on an H100 SXM: the function needs (P+1) products per input and
// output, 2*rows*K*(P+1)*N int8 operations against the 1,979 TOPS int8
// tensor-core rate, and moves x_q (int32), C (int8) and y once.  At
// MNIST-KAN layer 1 (2048 x 784 -> 64, M = 13) that is 0.82 G operations
// (0.4 us) against 6.4 MB + 0.65 MB + 0.5 MB (2.3 us): bound by bytes.  This
// kernel multiplies the dense band's M-(P+1) zero slots too and runs on the
// CUDA cores' int32 pipe; u8 x s8 wgmma is later work.
#include "kan_common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBand = 64;      // band width per K step: BK * M <= kBand
constexpr int kThreads = 256;
constexpr int kCLoads = kBand * kBN / kThreads;   // coefficient loads per thread and step

// out: 0 = float32, 1 = bfloat16 (both through scale), 2 = int32 accumulator
template <int P, int OUT>
__global__ void __launch_bounds__(kThreads)
kan_int8_kernel(const int* __restrict__ x_q, const int8_t* __restrict__ coeff,
                const float* __restrict__ scale, const uint8_t* __restrict__ rom,
                void* __restrict__ y, int BS, int K, int N, int M, int G, int S, int qmax,
                int BK) {
  extern __shared__ uint8_t rom_s[];           // (S, half) ROM bytes
  __shared__ int a_s[kBM * kBand];             // (kBM, W) basis band
  __shared__ int c_s[kBand * kBN];             // (W, kBN) coefficient rows
  constexpr int half = (P + 2) / 2;
  const int W = BK * M;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  for (int e = tid; e < S * half; e += kThreads) rom_s[e] = rom[e];

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  __syncthreads();

  for (int j0 = 0; j0 < K; j0 += BK) {
    // 1. The matching BK*M rows of C (viewed as (K*M, N)), widened to int32:
    //    all of a thread's loads issued at once, held in registers while the
    //    band is built, stored to shared memory after.
    int cv[kCLoads];
#pragma unroll
    for (int t = 0; t < kCLoads; ++t) {
      const int e = tid + t * kThreads;
      const int crow = j0 * M + e / kBN, n = n0 + e % kBN;
      cv[t] = (e / kBN < W && crow < K * M && n < N) ? (int)coeff[(size_t)crow * N + n] : 0;
    }
    // 2. Align/Compare + ROM: the dense u8 band of this x_q tile.
    for (int p = tid; p < kBM * BK; p += kThreads) {
      const int r = p / BK, jj = p % BK;
      const int row = m0 + r, j = j0 + jj;
      int* band = a_s + r * W + jj * M;
      for (int m = 0; m < M; ++m) band[m] = 0;
      if (row < BS && j < K) {
        int addr, vals[P + 1];
        const int k = kan::int_address<P>(x_q[(size_t)row * K + j], G, M, qmax, S, &addr);
        kan::rom_fetch<P>(rom_s, S, addr, vals);
#pragma unroll
        for (int i = 0; i <= P; ++i) band[k - P + i] = vals[i];
      }
    }
#pragma unroll
    for (int t = 0; t < kCLoads; ++t) c_s[tid + t * kThreads] = cv[t];
    __syncthreads();
    // 3. Exact integer contraction over the band.
    for (int kk = 0; kk < W; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[(ty * 4 + i) * W + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = c_s[kk * kBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= BS) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const size_t o = (size_t)row * N + n;
      if constexpr (OUT == 2) {
        static_cast<int*>(y)[o] = acc[i][j];
      } else {
        const float v = (float)acc[i][j] * scale[n];   // dequant epilogue
        if constexpr (OUT == 0) static_cast<float*>(y)[o] = v;
        else static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16(v);
      }
    }
  }
}

template <int P, int OUT>
int launch(const void* x_q, const void* coeff, const void* scale, const void* rom, void* y,
           int BS, int K, int N, int M, int G, int S, int qmax, cudaStream_t stream) {
  const int BK = kBand / M;
  const size_t rom_bytes = (size_t)S * ((P + 2) / 2);
  dim3 grid((N + kBN - 1) / kBN, (BS + kBM - 1) / kBM);
  kan_int8_kernel<P, OUT><<<grid, kThreads, rom_bytes, stream>>>(
      static_cast<const int*>(x_q), static_cast<const int8_t*>(coeff),
      static_cast<const float*>(scale), static_cast<const uint8_t*>(rom), y, BS, K, N, M, G, S,
      qmax, BK);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_out(const void* x_q, const void* coeff, const void* scale, const void* rom,
                 void* y, int BS, int K, int N, int M, int G, int S, int qmax, int out,
                 cudaStream_t s) {
  if (out == 2 && scale == nullptr)
    return launch<P, 2>(x_q, coeff, scale, rom, y, BS, K, N, M, G, S, qmax, s);
  if (out == 0 && scale != nullptr)
    return launch<P, 0>(x_q, coeff, scale, rom, y, BS, K, N, M, G, S, qmax, s);
  if (out == 1 && scale != nullptr)
    return launch<P, 1>(x_q, coeff, scale, rom, y, BS, K, N, M, G, S, qmax, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Compiled for P in {1, 2, 3} and M = G+P <= 64; the ROM (S x ceil((P+1)/2)
// bytes) must fit 16 KB of shared memory.  out codes: 0 = float32,
// 1 = bfloat16 (scale given), 2 = int32 (no scale).  Returns a cudaError_t.
extern "C" int kan_int8_gemm(const void* x_q, const void* coeff, const void* scale,
                             const void* rom, void* y, int BS, int K, int N, int M, int G, int P,
                             int S, int qmax, int out, void* stream) {
  if (M != G + P || M <= P || M > kBand || S < 2 || qmax < 1 || S * ((P + 2) / 2) > 16384)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return dispatch_out<1>(x_q, coeff, scale, rom, y, BS, K, N, M, G, S, qmax, out, s);
    case 2: return dispatch_out<2>(x_q, coeff, scale, rom, y, BS, K, N, M, G, S, qmax, out, s);
    case 3: return dispatch_out<3>(x_q, coeff, scale, rom, y, BS, K, N, M, G, S, qmax, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
