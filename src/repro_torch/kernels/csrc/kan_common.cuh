// Device-side building blocks shared by the KAN CUDA kernels.
//
// CUDA counterpart of repro/kernels/common.py (the Pallas in-kernel helpers):
//   * cardinal_values<P>     == cardinal_values_inblock: the P+1 cardinal
//     B-spline values by the Cox-de Boor triangle, same operation order;
//   * compact_basis<P>       == compact_basis_inblock: z = (x - t0)/delta with
//     a true IEEE division (no fast math: k must equal the reference's k at
//     knot values), k = clamp(floor z, P, M-1), xa = clamp(z - k, 0, 1);
//   * band_scatter<P, T>     == band_scatter: one input's dense M-wide band;
//   * gather_coeff_rows<..>  == gather_coeff_slabs: the coefficient rows an
//     input's window touches, one output column at a time (window_mask
//     gives the rows).
// The plain PyTorch versions live in repro_torch/kernels/common.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kan {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bfloat16)
}

// Value as the matrix unit would see it after a cast to T (astype(c.dtype)).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// B_{0,P}(xa + (P - i)) for i = 0..P, ascending basis index.
template <int P>
__device__ __forceinline__ void cardinal_values(float xa, float* vals) {
#pragma unroll
  for (int i = 0; i <= P; ++i) {
    const float u = xa + (float)(P - i);
    float b[P + 1];
#pragma unroll
    for (int s = 0; s <= P; ++s) b[s] = (u >= (float)s && u < (float)(s + 1)) ? 1.0f : 0.0f;
#pragma unroll
    for (int p = 1; p <= P; ++p) {
#pragma unroll
      for (int s = 0; s <= P - p; ++s) {
        const float left = (u - (float)s) / (float)p * b[s];
        const float right = ((float)s + (float)(p + 1) - u) / (float)p * b[s + 1];
        b[s] = left + right;
      }
    }
    vals[i] = b[0];
  }
}

// Compact N:M evaluation of one input: writes P+1 values, returns k.
template <int P>
__device__ __forceinline__ int compact_basis(float x, float t0, float delta, int M,
                                             float* vals) {
  const float z = __fdiv_rn(x - t0, delta);
  int k = (int)floorf(z);
  k = k < P ? P : (k > M - 1 ? M - 1 : k);
  float xa = z - (float)k;
  xa = fminf(fmaxf(xa, 0.0f), 1.0f);
  cardinal_values<P>(xa, vals);
  return k;
}

// The M-to-N multiplexer run in reverse: writes one input's dense M-wide
// band, its P+1 values at k-P .. k rounded to T as the product sees them
// (band.astype(c.dtype)), zeros elsewhere.
template <int P, typename T>
__device__ __forceinline__ void band_scatter(const float* vals, int k, int M, float* band) {
  for (int m = 0; m < M; ++m) band[m] = 0.0f;
#pragma unroll
  for (int i = 0; i <= P; ++i) band[k - P + i] = round_to<T>(vals[i]);
}

// Bit m set for each basis row B_{k-P} .. B_k an input in interval k touches.
template <int P>
__device__ __forceinline__ unsigned window_mask(int k) {
  return ((1u << (P + 1)) - 1u) << (k - P);
}

// The M-to-N multiplexer run forward: column n of the coefficient rows
// C[j, m, :] whose bit is set in `rows` (c_jn points at C[j, 0, n], rows
// `stride` elements apart).  Rows not set are never read and load as 0.
template <int MAXM, typename T>
__device__ __forceinline__ void gather_coeff_rows(const T* __restrict__ c_jn, size_t stride,
                                                  int M, unsigned rows, float* cm) {
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
    cm[m] = (m < M && ((rows >> m) & 1u)) ? to_float(c_jn[m * stride]) : 0.0f;
}

}  // namespace kan
