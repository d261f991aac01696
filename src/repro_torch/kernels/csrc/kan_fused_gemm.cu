// Fused KAN GEMM for Hopper (sm_90a): Y = B(x) @ C + ReLU(x) @ Wb in ONE launch.
//
// Replaces the TPU kernel repro/kernels/kan_fused_gemm.py (_fused_kernel,
// launched by kan_fused_gemm_pallas).  What it keeps from that kernel: the
// dense (rows, K*M) B-spline band is built on chip from the raw x tile and is
// never written to device memory, and the base term reuses the same resident
// x tile inside the same K loop, so a KAN layer is one launch.
//
// Design (a plain tiled SIMT GEMM, right before fast):
//   * block = 256 threads computing a 64 x 64 output tile, 4 x 4 per thread
//     (columns strided by 16 so shared-memory reads do not conflict);
//   * per K step of BK = 64/M inputs the threads evaluate the P+1 values of
//     each x element in fp32 (kan_common.cuh) and write the dense
//     (64, BK*M) band into shared memory, load the matching (BK*M, 64) rows
//     of C and the (BK, 64) rows of Wb, then accumulate in fp32 registers;
//   * ragged edges are masked: an input past K or a row past BS contributes
//     nothing, and columns past N are not stored.
// Numerics follow the TPU kernel: basis values are rounded to C's dtype
// before the product (band.astype(c.dtype)), ReLU(x) is rounded to Wb's
// dtype, accumulation is fp32, the output is x's dtype.
//
// Bound on an H100 SXM (at the main-path prefill shape, rows = 512, K = 512,
// N = 1024, M = 8): the function needs P+1 basis products and one base
// product per input and output, 2*rows*K*(P+2)*N ~= 2.7 GFLOP of fp32 FMA
// (the dense band's other M-(P+1) slots are zeros this kernel multiplies
// anyway), against ~22 MB moved (x, C, Wb, y once each), i.e. compute-bound
// on the 67 TFLOP/s fp32 CUDA-core rate (~0.040 ms).  This kernel runs on
// CUDA cores; wgmma/TMA and tensor-core TF32/bf16 paths are later work.
#include "kan_common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBand = 64;      // band width per K step: BK * M <= kBand
constexpr int kThreads = 256;

template <typename TX, typename TC, int P>
__global__ void __launch_bounds__(kThreads)
kan_fused_kernel(const TX* __restrict__ x, const TC* __restrict__ coeff,
                 const TC* __restrict__ base_w, TX* __restrict__ y, int BS, int K,
                 int N, int M, int BK, float t0, float delta) {
  extern __shared__ float smem[];
  const int W = BK * M;                        // band width this step (<= kBand)
  float* a_s = smem;                           // (kBM, W)   basis band
  float* c_s = a_s + kBM * kBand;              // (W, kBN)   coefficient rows
  float* xr_s = c_s + kBand * kBN;             // (kBM, BK)  ReLU(x)
  float* w_s = xr_s + kBM * kBand;             // (BK, kBN)  base weights

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const bool has_base = base_w != nullptr;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int j0 = 0; j0 < K; j0 += BK) {
    // 1. B-spline unit: the dense band of this x tile, in shared memory only.
    for (int p = tid; p < kBM * BK; p += kThreads) {
      const int r = p / BK, jj = p % BK;
      const int row = m0 + r, j = j0 + jj;
      float* band = a_s + r * W + jj * M;
      float xr = 0.0f;
      if (row < BS && j < K) {
        const float xf = kan::to_float(x[(size_t)row * K + j]);
        float vals[P + 1];
        const int k = kan::compact_basis<P>(xf, t0, delta, M, vals);
        kan::band_scatter<P, TC>(vals, k, M, band);
        xr = kan::round_to<TC>(fmaxf(xf, 0.0f));
      } else {
        for (int m = 0; m < M; ++m) band[m] = 0.0f;   // masked: contributes nothing
      }
      xr_s[r * BK + jj] = xr;
    }
    // 2. The matching BK*M rows of C (viewed as (K*M, N)) and BK rows of Wb.
    for (int e = tid; e < W * kBN; e += kThreads) {
      const int rr = e / kBN, cc = e % kBN;
      const int crow = j0 * M + rr, n = n0 + cc;
      c_s[rr * kBN + cc] =
          (crow < K * M && n < N) ? kan::to_float(coeff[(size_t)crow * N + n]) : 0.0f;
    }
    if (has_base) {
      for (int e = tid; e < BK * kBN; e += kThreads) {
        const int rr = e / kBN, cc = e % kBN;
        const int j = j0 + rr, n = n0 + cc;
        w_s[rr * kBN + cc] =
            (j < K && n < N) ? kan::to_float(base_w[(size_t)j * N + n]) : 0.0f;
      }
    }
    __syncthreads();
    // 3. Spline contraction over the band, then the base term on the same tile.
    for (int kk = 0; kk < W; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[(ty * 4 + i) * W + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = c_s[kk * kBN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (has_base) {
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xr_s[(ty * 4 + i) * BK + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = w_s[kk * kBN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
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
      if (n < N) y[(size_t)row * N + n] = kan::from_float<TX>(acc[i][j]);
    }
  }
}

template <typename TX, typename TC>
int launch(const void* x, const void* coeff, const void* base_w, void* y, int BS, int K,
           int N, int M, float t0, float delta, cudaStream_t stream) {
  const int BK = kBand / M;
  const size_t smem = sizeof(float) * (kBM * kBand + kBand * kBN + kBM * kBand + kBand * kBN);
  auto kern = kan_fused_kernel<TX, TC, 3>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kBN - 1) / kBN, (BS + kBM - 1) / kBM);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TC*>(coeff),
      static_cast<const TC*>(base_w), static_cast<TX*>(y), BS, K, N, M, BK, t0, delta);
  return (int)cudaGetLastError();
}

}  // namespace

// Compiled for P = 3 (every config of the port) and M <= 64.  dtype codes:
// 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int kan_fused_gemm(const void* x, const void* coeff, const void* base_w, void* y,
                              int BS, int K, int N, int M, int P, float t0, float delta,
                              int x_dtype, int c_dtype, void* stream) {
  if (P != 3 || M <= P || M > kBand) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && c_dtype == 0)
    return launch<float, float>(x, coeff, base_w, y, BS, K, N, M, t0, delta, s);
  if (x_dtype == 1 && c_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, coeff, base_w, y, BS, K, N, M, t0, delta,
                                                s);
  if (x_dtype == 1 && c_dtype == 0)
    return launch<__nv_bfloat16, float>(x, coeff, base_w, y, BS, K, N, M, t0, delta, s);
  if (x_dtype == 0 && c_dtype == 1)
    return launch<float, __nv_bfloat16>(x, coeff, base_w, y, BS, K, N, M, t0, delta, s);
  return (int)cudaErrorInvalidValue;
}
