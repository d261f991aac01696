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
// Design (the layout of the float sparse kernel, kan_sparse_gemm.cu), ONE
// launch:
//   * a block holds up to 8 rows for 128 columns and 32 inputs j; the ROM
//     (build_lut_u8, S x ceil((P+1)/2) bytes) sits in shared memory;
//   * per input j the block first computes (k, ROM values) of every row
//     once into a shared-memory band of MAXM = 8 or 16 int32 slots (chosen
//     by M), and the union of the rows' windows (a bit per basis row);
//   * each thread (one column n) loads the touched int8 rows C[j, m, n] of
//     4 inputs before using any of them (untouched rows are never read) and
//     accumulates sum_m band[r][j][m] * C[j,m,n] in int32;
//   * K is split into 32-input slices; each slice adds its int32 sums into
//     an accumulator in device memory with atomics (integer addition: exact
//     in any order, so the result is deterministic), and the block that
//     finishes a column tile last (a ticket counter per tile) reads the
//     tile's sums, applies the epilogue, and leaves accumulator and ticket
//     zero for the next launch.  (Summing fp32 partials slice by slice, as
//     the float kernel must for a fixed order, costs the last block one
//     dependent load per slice and row.)
//
// Bound on an H100 SXM: the bytes of x_q, of the touched int8 slab rows and
// of y.  CF-KAN layer 1 at 8 rows (K = 2810, N = 512, M = 5): the rows'
// windows touch most of the 7.2 MB of int8 coefficients, ~2.2 us; the
// 2*8*2810*4*512 = 92 M operations take 0.05 us at the int8 tensor-core rate.
#include "kan_common.cuh"

namespace {

constexpr int kRows = 8;       // rows per block
constexpr int kJC = 32;        // inputs per K slice
constexpr int kCols = 128;     // columns per block == threads
constexpr int kUnroll = 4;     // inputs whose loads are in flight together
static_assert(kJC % kUnroll == 0, "a slice is a whole number of unrolled steps");

template <int P, int MAXM, int OUT>
__global__ void __launch_bounds__(kCols)
kan_sparse_int8_kernel(const int* __restrict__ x_q, const int8_t* __restrict__ coeff,
                       const float* __restrict__ scale, const uint8_t* __restrict__ rom,
                       int* __restrict__ sums, unsigned* __restrict__ tickets,
                       void* __restrict__ y, int BS, int K, int N, int M, int G, int S,
                       int qmax) {
  extern __shared__ uint8_t rom_s[];
  __shared__ int band_s[kRows][kJC][MAXM];
  __shared__ unsigned mask_s[kJC];
  __shared__ bool last_s;
  constexpr int half = (P + 2) / 2;

  const int tid = threadIdx.x;
  const int n = blockIdx.x * kCols + tid;
  const int slice = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int j0 = slice * kJC;
  const int nrows = min(kRows, BS - r0);

  for (int e = tid; e < S * half; e += kCols) rom_s[e] = rom[e];
  if (tid < kJC) mask_s[tid] = 0u;
  __syncthreads();
  // Align/Compare + ROM: (k, values) of every (row, input) pair, once.
  for (int p = tid; p < kRows * kJC; p += kCols) {
    const int r = p / kJC, jj = p % kJC;
    const int j = j0 + jj;
    int* band = band_s[r][jj];
#pragma unroll
    for (int m = 0; m < MAXM; ++m) band[m] = 0;     // masked: contributes nothing
    if (r < nrows && j < K) {
      int addr, vals[P + 1];
      const int k = kan::int_address<P>(x_q[(size_t)(r0 + r) * K + j], G, M, qmax, S, &addr);
      kan::rom_fetch<P>(rom_s, S, addr, vals);
#pragma unroll
      for (int i = 0; i <= P; ++i) band[k - P + i] = vals[i];
      atomicOr(&mask_s[jj], kan::window_mask<P>(k));
    }
  }
  __syncthreads();

  int acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0;
  const int jn = min(kJC, K - j0);
  if (n < N) {
    for (int jb = 0; jb < jn; jb += kUnroll) {
      // The touched rows of C[j] for kUnroll inputs, all loads issued before
      // any is used.  An input past K has an empty mask and a zero band.
      int cm[kUnroll][MAXM];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = jb + u;
        const int8_t* c_jn = coeff + (size_t)(j0 + jj) * M * N + n;
        const unsigned rows = mask_s[jj];
#pragma unroll
        for (int m = 0; m < MAXM; ++m)
          cm[u][m] = (m < M && ((rows >> m) & 1u)) ? (int)c_jn[(size_t)m * N] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = jb + u;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nrows) {
            int s = acc[r];
#pragma unroll
            for (int m = 0; m < MAXM; ++m) s += band_s[r][jj][m] * cm[u][m];
            acc[r] = s;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nrows) atomicAdd(&sums[(size_t)(r0 + r) * N + n], acc[r]);
  }

  // The last slice of this column tile to finish writes the tile.
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) last_s = atomicAdd(&tickets[tile], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (n < N) {
    for (int r = 0; r < nrows; ++r) {
      const size_t o = (size_t)(r0 + r) * N + n;
      const int s = __ldcg(&sums[o]);
      sums[o] = 0;                      // zero for the next launch
      if constexpr (OUT == 2) {
        static_cast<int*>(y)[o] = s;
      } else {
        const float v = (float)s * scale[n];            // dequant epilogue
        if constexpr (OUT == 0) static_cast<float*>(y)[o] = v;
        else static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16(v);
      }
    }
  }
  if (tid == 0) tickets[tile] = 0u;   // ready for the next launch on this workspace
}

template <int P, int MAXM, int OUT>
int launch(const void* x_q, const void* coeff, const void* scale, const void* rom,
           void* tickets, void* sums, void* y, int BS, int K, int N, int M, int G, int S,
           int qmax, cudaStream_t stream) {
  const int slices = (K + kJC - 1) / kJC;
  dim3 grid((N + kCols - 1) / kCols, slices, (BS + kRows - 1) / kRows);
  const size_t rom_bytes = (size_t)S * ((P + 2) / 2);
  kan_sparse_int8_kernel<P, MAXM, OUT><<<grid, kCols, rom_bytes, stream>>>(
      static_cast<const int*>(x_q), static_cast<const int8_t*>(coeff),
      static_cast<const float*>(scale), static_cast<const uint8_t*>(rom),
      static_cast<int*>(sums), static_cast<unsigned*>(tickets), y, BS, K, N, M, G, S, qmax);
  return (int)cudaGetLastError();
}

template <int P, int MAXM>
int dispatch_out(const void* x_q, const void* coeff, const void* scale, const void* rom,
                 void* tickets, void* sums, void* y, int BS, int K, int N, int M, int G,
                 int S, int qmax, int out, cudaStream_t s) {
  if (out == 2 && scale == nullptr)
    return launch<P, MAXM, 2>(x_q, coeff, scale, rom, tickets, sums, y, BS, K, N, M, G, S,
                              qmax, s);
  if (out == 0 && scale != nullptr)
    return launch<P, MAXM, 0>(x_q, coeff, scale, rom, tickets, sums, y, BS, K, N, M, G, S,
                              qmax, s);
  if (out == 1 && scale != nullptr)
    return launch<P, MAXM, 1>(x_q, coeff, scale, rom, tickets, sums, y, BS, K, N, M, G, S,
                              qmax, s);
  return (int)cudaErrorInvalidValue;
}

template <int P>
int dispatch_m(const void* x_q, const void* coeff, const void* scale, const void* rom,
               void* tickets, void* sums, void* y, int BS, int K, int N, int M, int G, int S,
               int qmax, int out, cudaStream_t s) {
  if (M <= 8)
    return dispatch_out<P, 8>(x_q, coeff, scale, rom, tickets, sums, y, BS, K, N, M, G, S,
                              qmax, out, s);
  return dispatch_out<P, 16>(x_q, coeff, scale, rom, tickets, sums, y, BS, K, N, M, G, S,
                             qmax, out, s);
}

}  // namespace

// Workspace of one call at (BS, K, N), in two buffers the caller keeps,
// both zero before a call and left zero by it: the ticket counters, one
// uint32 per column tile and row block, and the int32 accumulators (BS, N).
extern "C" long long kan_sparse_int8_gemm_tickets(int BS, int N) {
  return (long long)((N + kCols - 1) / kCols) * ((BS + kRows - 1) / kRows);
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
  if (M != G + P || M <= P || M > 16 || S < 2 || qmax < 1 || S * ((P + 2) / 2) > 16384)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return dispatch_m<1>(x_q, coeff, scale, rom, tickets, sums, y, BS, K, N, M, G, S,
                                 qmax, out, s);
    case 2: return dispatch_m<2>(x_q, coeff, scale, rom, tickets, sums, y, BS, K, N, M, G, S,
                                 qmax, out, s);
    case 3: return dispatch_m<3>(x_q, coeff, scale, rom, tickets, sums, y, BS, K, N, M, G, S,
                                 qmax, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
