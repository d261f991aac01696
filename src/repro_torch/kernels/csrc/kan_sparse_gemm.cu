// Compact N:M sparse KAN GEMV for Hopper (sm_90a), the decode path.
//
// Replaces the TPU kernel repro/kernels/kan_sparse_gemm.py (_sparse_kernel,
// launched by kan_sparse_gemm_pallas): Y = B(x) @ C + ReLU(x) @ Wb where each
// input contracts only its P+1 non-zero basis values against the coefficient
// slab C[j, k-P .. k, :] it touches (the paper's N:M vector PE).
//
// Design (decode has <= 8 rows, so this is a memory-bound GEMV), ONE launch:
//   * a block holds up to 8 rows for 128 columns and 32 inputs j.  The rows
//     share the block, so each touched C row C[j, m, n0:n0+128] is read from
//     device memory ONCE for all rows (a per-j mask of the rows' windows
//     selects which m rows to load; untouched rows are never read);
//   * threads run along n, so every load of C and Wb is coalesced;
//   * per input j the block first evaluates (vals, k) of every row once into
//     a shared-memory band of MAXM slots (kan_common.cuh, fp32), then each
//     thread accumulates sum_m band[r][j][m] * C[j,m,n] + ReLU(x[r,j]) *
//     Wb[j,n].  The band width MAXM is a compile-time 8 or 16, the smallest
//     that holds M = G+P (16 serves G = 10, MNIST-KAN), so a row takes MAXM
//     FMAs per input, of which P+1 are non-zero; the loads, not the FMAs,
//     set the time;
//   * each thread issues the loads of kUnroll = 4 inputs before it uses any
//     of them, so a block has up to 4 x 9 loads per thread in flight instead
//     of waiting out one device-memory latency per input;
//   * the grid splits K into 32-input slices so that enough blocks pull
//     device memory at once; each slice writes an fp32 partial, and the
//     block that finishes a column tile last (a ticket counter per tile)
//     sums that tile's slices in slice order (deterministic, no float
//     atomics), casts to x's dtype and resets its ticket for the next call.
// Compiled for spline degrees P in {1, 2, 3} (GKAN has P = 1), as the TPU
// kernel takes any P; M = G+P <= 16.
// Numerics follow the TPU kernel: basis values rounded to C's dtype before
// the product, ReLU(x) rounded to Wb's dtype, fp32 accumulation.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes of the touched slab rows plus
// Wb.  K = 512, N = 1024, fp32: ~8.4 MB + 2.1 MB at 1 row (~3.1 us);
// at 4 rows the rows' windows cover most of the M = 8 basis rows, up to
// ~16.8 MB + 2.1 MB (~5.6 us; tanh'd normal inputs touch ~14.8 MB, ~5.1 us).
#include "kan_common.cuh"

namespace {

constexpr int kRows = 8;       // rows per block
constexpr int kJC = 32;        // inputs per K slice
constexpr int kCols = 128;     // columns per block == threads
constexpr int kUnroll = 4;     // inputs whose loads are in flight together
static_assert(kJC % kUnroll == 0, "a slice is a whole number of unrolled steps");

template <typename TX, typename TC, int P, int MAXM>
__global__ void __launch_bounds__(kCols)
kan_sparse_kernel(const TX* __restrict__ x, const TC* __restrict__ coeff,
                  const TC* __restrict__ base_w, float* __restrict__ partial,
                  unsigned* __restrict__ tickets, TX* __restrict__ y, int BS, int K, int N,
                  int M, float t0, float delta) {
  __shared__ float band_s[kRows][kJC][MAXM];
  __shared__ float xr_s[kRows][kJC];
  __shared__ unsigned mask_s[kJC];
  __shared__ bool last_s;

  const int tid = threadIdx.x;
  const int n = blockIdx.x * kCols + tid;
  const int slice = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int j0 = slice * kJC;
  const int nrows = min(kRows, BS - r0);
  const bool has_base = base_w != nullptr;

  if (tid < kJC) mask_s[tid] = 0u;
  __syncthreads();
  // B-spline unit: (vals, k) of every (row, input) pair of this slice, once.
  for (int p = tid; p < kRows * kJC; p += kCols) {
    const int r = p / kJC, jj = p % kJC;
    const int j = j0 + jj;
    float* band = band_s[r][jj];
    float xr = 0.0f;
    if (r < nrows && j < K) {
      const float xf = kan::to_float(x[(size_t)(r0 + r) * K + j]);
      float vals[P + 1];
      const int k = kan::compact_basis<P>(xf, t0, delta, M, vals);
      kan::band_scatter<P, TC>(vals, k, MAXM, band);
      xr = kan::round_to<TC>(fmaxf(xf, 0.0f));
      atomicOr(&mask_s[jj], kan::window_mask<P>(k));
    } else {
#pragma unroll
      for (int m = 0; m < MAXM; ++m) band[m] = 0.0f;   // masked: contributes nothing
    }
    xr_s[r][jj] = xr;
  }
  __syncthreads();

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  const int jn = min(kJC, K - j0);
  if (n < N) {
    for (int jb = 0; jb < jn; jb += kUnroll) {
      // The M-to-N multiplexer run forward: the touched rows of C[j] for
      // kUnroll inputs, all loads issued before any is used.  An input past
      // K has an empty mask and a zero band, so it loads and adds nothing.
      float cm[kUnroll][MAXM];
      float wb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = jb + u;
        const size_t j = (size_t)(j0 + jj);
        kan::gather_coeff_rows<MAXM>(coeff + j * M * N + n, (size_t)N, M, mask_s[jj],
                                      cm[u]);
        wb[u] = (has_base && jj < jn) ? kan::to_float(base_w[j * N + n]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = jb + u;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < nrows) {
            float s = acc[r];
#pragma unroll
            for (int m = 0; m < MAXM; ++m) s = fmaf(band_s[r][jj][m], cm[u][m], s);
            acc[r] = fmaf(xr_s[r][jj], wb[u], s);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nrows) partial[((size_t)slice * BS + r0 + r) * N + n] = acc[r];
  }

  // The last slice of this column tile to finish sums all its slices.
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) last_s = atomicAdd(&tickets[tile], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (n < N) {
    for (int r = 0; r < nrows; ++r) {
      float s = 0.0f;
      for (int sl = 0; sl < (int)gridDim.y; ++sl)   // slice order: deterministic
        s += __ldcg(&partial[((size_t)sl * BS + r0 + r) * N + n]);
      y[(size_t)(r0 + r) * N + n] = kan::from_float<TX>(s);
    }
  }
  if (tid == 0) tickets[tile] = 0u;   // ready for the next launch on this workspace
}

template <typename TX, typename TC, int P>
int launch(const void* x, const void* coeff, const void* base_w, void* tickets, void* partial,
           void* y, int BS, int K, int N, int M, float t0, float delta, cudaStream_t stream) {
  const int slices = (K + kJC - 1) / kJC;
  dim3 grid((N + kCols - 1) / kCols, slices, (BS + kRows - 1) / kRows);
  auto kern = M <= 8 ? kan_sparse_kernel<TX, TC, P, 8> : kan_sparse_kernel<TX, TC, P, 16>;
  kern<<<grid, kCols, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TC*>(coeff),
      static_cast<const TC*>(base_w), static_cast<float*>(partial),
      static_cast<unsigned*>(tickets), static_cast<TX*>(y), BS, K, N, M, t0, delta);
  return (int)cudaGetLastError();
}

template <typename TX, typename TC>
int dispatch_p(const void* x, const void* coeff, const void* base_w, void* tickets,
               void* partial, void* y, int BS, int K, int N, int M, int P, float t0, float delta,
               cudaStream_t s) {
  switch (P) {
    case 1: return launch<TX, TC, 1>(x, coeff, base_w, tickets, partial, y, BS, K, N, M, t0,
                                     delta, s);
    case 2: return launch<TX, TC, 2>(x, coeff, base_w, tickets, partial, y, BS, K, N, M, t0,
                                     delta, s);
    case 3: return launch<TX, TC, 3>(x, coeff, base_w, tickets, partial, y, BS, K, N, M, t0,
                                     delta, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Workspace of one call at (BS, K, N), in two buffers the caller keeps:
// the ticket counters, one uint32 per column tile and row block, which
// must be zero before a call and which every call leaves zero; and the
// K slices' fp32 partials, any contents.
extern "C" long long kan_sparse_gemm_tickets(int BS, int N) {
  return (long long)((N + kCols - 1) / kCols) * ((BS + kRows - 1) / kRows);
}
extern "C" long long kan_sparse_gemm_partials(int BS, int K, int N) {
  return (long long)((K + kJC - 1) / kJC) * BS * N;
}

// Compiled for P in {1, 2, 3} and M <= 16.  dtype codes: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int kan_sparse_gemm(const void* x, const void* coeff, const void* base_w,
                               void* tickets, void* partial, void* y, int BS, int K, int N,
                               int M, int P, float t0, float delta, int x_dtype, int c_dtype,
                               void* stream) {
  if (P < 1 || P > 3 || M <= P || M > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && c_dtype == 0)
    return dispatch_p<float, float>(x, coeff, base_w, tickets, partial, y, BS, K, N, M, P, t0,
                                    delta, s);
  if (x_dtype == 1 && c_dtype == 1)
    return dispatch_p<__nv_bfloat16, __nv_bfloat16>(x, coeff, base_w, tickets, partial, y, BS,
                                                    K, N, M, P, t0, delta, s);
  if (x_dtype == 1 && c_dtype == 0)
    return dispatch_p<__nv_bfloat16, float>(x, coeff, base_w, tickets, partial, y, BS, K, N, M,
                                            P, t0, delta, s);
  if (x_dtype == 0 && c_dtype == 1)
    return dispatch_p<float, __nv_bfloat16>(x, coeff, base_w, tickets, partial, y, BS, K, N, M,
                                            P, t0, delta, s);
  return (int)cudaErrorInvalidValue;
}
