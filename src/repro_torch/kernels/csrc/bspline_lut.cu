// The tabulated B-spline unit (paper §III-B, Fig. 5) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bspline_lut.py (_bspline_lut_kernel,
// launched by bspline_lut_pallas): per input x, the Align unit
// z = (x - t0)/delta, the Compare unit k = clamp(floor z, P, M-1), the
// address addr = round(x_a * (S-1)) of the in-interval offset
// x_a = clamp(z - k, 0, 1), and the P+1 non-zero values of the cardinal
// B-spline from the (S, ceil((P+1)/2)) float half-table: the direct fetch
// T[addr][j] for j < half, else the inverted-address fetch T[S-1-addr][P-j],
// in ascending basis order.
//
// Design: one thread per input.  Each block copies the table into shared
// memory and reads it with direct indexed loads (the TPU kernel's one-hot
// matmuls are how an MXU reads a table; the function is the lookup).  The
// division is a true IEEE division (__fdiv_rn: k must equal the reference's
// at knot values) and the address rounds half to even (rintf, as
// jnp.round); nothing here can be contracted into an FMA.
//
// Bound on an H100 SXM: bytes.  Per input 4 bytes of x read, (P+1)*4 bytes
// of values and 4 bytes of k written: 24 bytes for P = 3, so MNIST-KAN
// layer 1's 2048 x 784 inputs move 38.5 MB (11.5 us at 3.35 TB/s).
#include "kan_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int P>
__global__ void __launch_bounds__(kThreads)
bspline_lut_kernel(const float* __restrict__ x, const float* __restrict__ lut,
                   float* __restrict__ vals, int* __restrict__ k_out, int n, int S, int M,
                   float t0, float delta) {
  extern __shared__ float lut_s[];
  constexpr int half = (P + 2) / 2;
  for (int e = threadIdx.x; e < S * half; e += kThreads) lut_s[e] = lut[e];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float z = __fdiv_rn(x[i] - t0, delta);
  int k = (int)floorf(z);
  k = k < P ? P : (k > M - 1 ? M - 1 : k);
  const float xa = fminf(fmaxf(z - (float)k, 0.0f), 1.0f);
  int addr = (int)rintf(xa * (float)(S - 1));
  addr = addr < 0 ? 0 : (addr > S - 1 ? S - 1 : addr);
  const int inv = S - 1 - addr;
#pragma unroll
  for (int b = 0; b <= P; ++b) {
    const int j = P - b;
    vals[(size_t)i * (P + 1) + b] = j < half ? lut_s[addr * half + j] : lut_s[inv * half + (P - j)];
  }
  k_out[i] = k;
}

template <int P>
int launch(const void* x, const void* lut, void* vals, void* k, int n, int S, int M, float t0,
           float delta, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)S * ((P + 2) / 2);
  auto kern = bspline_lut_kernel<P>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  kern<<<blocks, kThreads, smem, stream>>>(static_cast<const float*>(x),
                                          static_cast<const float*>(lut),
                                          static_cast<float*>(vals), static_cast<int*>(k), n, S,
                                          M, t0, delta);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 x (n,) and table (S, ceil((P+1)/2)); P in {1, 2, 3}; M = G+P.
// Writes vals (n, P+1) float32 and k (n,) int32.  Returns a cudaError_t.
extern "C" int bspline_lut(const void* x, const void* lut, void* vals, void* k, int n, int S,
                           int P, int M, float t0, float delta, void* stream) {
  if (S < 2 || M <= P || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return launch<1>(x, lut, vals, k, n, S, M, t0, delta, s);
    case 2: return launch<2>(x, lut, vals, k, n, S, M, t0, delta, s);
    case 3: return launch<3>(x, lut, vals, k, n, S, M, t0, delta, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
