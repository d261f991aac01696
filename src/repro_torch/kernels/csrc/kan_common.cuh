// Device-side building blocks shared by the KAN CUDA kernels.
//
// CUDA counterpart of repro/kernels/common.py (the Pallas in-kernel helpers):
//   * cardinal_values<P>     == cardinal_values_inblock: the P+1 cardinal
//     B-spline values by the Cox-de Boor triangle, same operation order;
//   * compact_basis<P>       == compact_basis_inblock: z = (x - t0)/delta with
//     a true IEEE division (no fast math: k must equal the reference's k at
//     knot values), k = clamp(floor z, P, M-1), xa = clamp(z - k, 0, 1);
//   * window_mask<P>: the coefficient rows an input's window touches (the
//     rows gather_coeff_slabs reads);
//   * int_address<P> + rom_fetch<P> == int8_compact_values_inblock: the
//     integer Align/Compare units (Eq. 5, floor division as the reference's
//     `//`, int32 wrap-around as its int32 arithmetic) and the P+1 uint8 ROM
//     values by the direct and inverted-address fetch from the half-table
//     build_lut_u8 (held in shared memory by the int8 kernels): the table's
//     bytes by construction, no float arithmetic to round differently.  (The
//     reference's kernels evaluate the entries from the float Cox-de Boor
//     triangle instead, which rounds one entry of the P = 2, scale 192 table
//     the other way; see common.py.)
//   * cp_async<BYTES> / cp_async_commit / cp_async_wait<N>: Ampere's
//     asynchronous global-to-shared copies (cp.async), zero-filled past the
//     bytes read, used by the dense-band kernels' staging rings and the
//     sparse kernels' staged rows;
//   * atomic_add_acq_rel: a device-scope counter increment that releases
//     and acquires, for the split-K tickets;
//   * sm_count: the current device's SM count (host), cached;
//   * the launch plan (PlanField, kPlanInts): what a launcher computes from
//     its problem before it launches, written by each library's
//     `<library>_plan` export and read back by the launcher itself, so the
//     plan the lint checks (repro_torch/analysis/kernel_configs.py, which
//     holds the Python mirror in kernels/ops.py: KERNELS against the export
//     on the card) is the plan that launches; ptr_align, grant_smem and
//     launch_planned, the launchers' common steps.
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

// Bit m set for each basis row B_{k-P} .. B_k an input in interval k touches.
template <int P>
__device__ __forceinline__ unsigned window_mask(int k) {
  return ((1u << (P + 1)) - 1u) << (k - P);
}

// floor(a / b) for b > 0 (C's `/` truncates toward zero).
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Integer Align + Compare (Eq. 5): returns k, writes the ROM address.
// u = (G+2P) * x_q and u - qmax*k wrap as int32 does (unsigned arithmetic,
// so the wrap is defined).
template <int P>
__device__ __forceinline__ int int_address(int x_q, int G, int M, int qmax, int S, int* addr) {
  const int u = (int)((unsigned)(G + 2 * P) * (unsigned)x_q);
  int k = floor_div(u, qmax);
  k = k < P ? P : (k > M - 1 ? M - 1 : k);
  int a = (int)((unsigned)u - (unsigned)(qmax * k));
  a = a < 0 ? 0 : (a > qmax ? qmax : a);
  *addr = (a * (S - 1)) / qmax;     // a >= 0: truncation is the floor
  return k;
}

// The P+1 uint8 ROM values at `addr`, ascending basis index: B0(x_a + j)
// for j = P-i is the direct fetch rom[addr][j] for j < half, else the
// inverted-address fetch rom[S-1-addr][P-j] (paper Fig. 5).
template <int P>
__device__ __forceinline__ void rom_fetch(const uint8_t* rom, int S, int addr, int* vals) {
  constexpr int half = (P + 2) / 2;   // ceil((P+1)/2)
#pragma unroll
  for (int i = 0; i <= P; ++i) {
    const int j = P - i;
    vals[i] = j < half ? (int)rom[addr * half + j] : (int)rom[(S - 1 - addr) * half + (P - j)];
  }
}

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory of
// which only the first `src_bytes` (0 .. BYTES) are read; the rest of the
// BYTES shared bytes are zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(gmem),
                 "n"(BYTES), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// *p += v at device scope, with release and acquire semantics; returns the
// old value.  After a block barrier, one thread's release covers the
// writes of the whole block (the barrier orders them before it).
__device__ __forceinline__ unsigned atomic_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Streaming multiprocessors of the current device (host side), cached.
inline int sm_count() {
  static int count[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

// A launch plan, kPlanInts ints: the grid, threads per block (the
// instantiation's __launch_bounds__), the dynamic shared memory, the
// dynamic shared memory the launch must be granted, the bytes of the
// widest vector access to an operand row, the template instantiation
// (each library numbers its own), the SM count and resident blocks per SM
// a split assumed (0: none), then the kernel's own fields.
enum PlanField {
  kGridX, kGridY, kGridZ, kBlockThreads, kDynSmem, kGrant, kVecBytes, kInst, kSms, kPerSm,
  kExtra
};
constexpr int kPlanInts = 16;

inline void plan_clear(int* plan) {
  for (int i = 0; i < kPlanInts; ++i) plan[i] = 0;
}

// The largest power of two, at most 16, dividing a device address (16 for
// nullptr: an absent operand constrains nothing).
inline int ptr_align(const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  int b = 16;
  while (b > 1 && a % b != 0) b /= 2;
  return b;
}

// Raise `kern`'s dynamic shared memory limit to `bytes` on the current
// device whenever `bytes` exceeds what was granted there before
// (`granted`: 64 devices), even below 48 KB: static shared memory counts
// against the default limit.
inline cudaError_t grant_smem(const void* kern, int bytes, int* granted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev >= 0 && dev < 64) granted[dev] = bytes;
  return err;
}

// Grant and launch `kern` as `plan` says, with the kernel's arguments
// `args` (pointers to each); `granted` nullptr where the plan export has
// granted already (the plans that ask the occupancy calculator).  Returns
// cudaGetLastError() after the launch.
inline int launch_planned(const void* kern, const int* plan, void** args, cudaStream_t stream,
                          int* granted) {
  if (granted != nullptr) {
    const cudaError_t err = grant_smem(kern, plan[kGrant], granted);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchKernel(kern, dim3(plan[kGridX], plan[kGridY], plan[kGridZ]),
                   dim3(plan[kBlockThreads]), args, (size_t)plan[kDynSmem], stream);
  return (int)cudaGetLastError();
}

}  // namespace kan
