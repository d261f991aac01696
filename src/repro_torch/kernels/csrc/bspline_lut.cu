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

const void* kernel_of(int P) {
  return P == 1 ? (const void*)bspline_lut_kernel<1>
                : (P == 2 ? (const void*)bspline_lut_kernel<2> : (const void*)bspline_lut_kernel<3>);
}

// the dynamic shared memory granted so far, per degree and device
int granted[3][64] = {};

}  // namespace

// The launch plan of a call (kan_common.cuh: PlanField; the instantiation
// is P-1), which the launcher below computes with this function.  Returns
// a cudaError_t.
extern "C" int bspline_lut_plan(int n, int S, int P, int* plan) {
  kan::plan_clear(plan);
  if (S < 2 || n < 0 || P < 1 || P > 3) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * S * ((P + 2) / 2);
  plan[kan::kGridX] = (n + kThreads - 1) / kThreads;
  plan[kan::kGridY] = 1;
  plan[kan::kGridZ] = 1;
  plan[kan::kBlockThreads] = kThreads;
  plan[kan::kDynSmem] = smem;
  plan[kan::kGrant] = smem;
  plan[kan::kVecBytes] = 4;
  plan[kan::kInst] = P - 1;
  return 0;
}

// float32 x (n,) and table (S, ceil((P+1)/2)); P in {1, 2, 3}; M = G+P.
// Writes vals (n, P+1) float32 and k (n,) int32.  Returns a cudaError_t.
extern "C" int bspline_lut(const void* x, const void* lut, void* vals, void* k, int n, int S,
                           int P, int M, float t0, float delta, void* stream) {
  if (M <= P) return (int)cudaErrorInvalidValue;
  int plan[kan::kPlanInts];
  const int err = bspline_lut_plan(n, S, P, plan);
  if (err != 0) return err;
  void* args[] = {&x, &lut, &vals, &k, &n, &S, &M, &t0, &delta};
  return kan::launch_planned(kernel_of(P), plan, args, static_cast<cudaStream_t>(stream),
                             granted[P - 1]);
}
