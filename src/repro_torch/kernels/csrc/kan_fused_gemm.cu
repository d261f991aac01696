// Fused KAN GEMM for Hopper (sm_90a): Y = B(x) @ C + ReLU(x) @ Wb in ONE launch.
//
// Replaces the TPU kernel repro/kernels/kan_fused_gemm.py (_fused_kernel,
// launched by kan_fused_gemm_pallas).  What it keeps from that kernel: the
// dense (rows, K*M) B-spline band is built on chip from the raw x tile and is
// never written to device memory, and the base term reuses the same resident
// x tile inside the same K loop, so a KAN layer is one launch.
//
// Bound on an H100 SXM (at the main-path prefill shape, rows = 512, K = 512,
// N = 1024, M = 8): the function needs P+1 basis products and one base
// product per input and output, 2*rows*K*(P+2)*N ~= 2.7 GFLOP of fp32 FMA,
// against ~22 MB moved (x, C, Wb, y once each): compute-bound on the
// 67 TFLOP/s fp32 CUDA-core rate (~0.040 ms).  The dense band multiplies the
// other M-(P+1) slots too (zeros), 2*rows*K*(M+1)*N = 4.8 GFLOP, the work a
// cuBLAS SGEMM over the materialised band does.  The data stay in fp32 FMAs:
// no TF32 (the port's parity tolerances are set for fp32 sums).
//
// Design (a SIMT GEMM that feeds the FP32 pipe):
//   * a block computes a 128 x 128 output tile with 256 threads (128 x 64
//     with 128 threads where N <= 64, 128 x 256 with 512 threads where
//     N >= 256, which halves how often a band is rebuilt), 8 x 8 outputs
//     per thread; per column of the step a thread reads its 8 rows and 8
//     columns as four float4 (bf16 coefficients: two 8-byte loads widened
//     to fp32), 64 FMAs per 4 shared loads;
//   * the base term is folded into the band: a K step of BK = 36/(M+1)
//     inputs has BK*M spline columns then BK ReLU(x) columns, and the staged
//     B tile is the matching BK*M rows of C followed by BK rows of Wb, so
//     one inner loop runs over both.  The band is stored slot-major
//     (column, 128 rows) so a thread's rows are contiguous;
//   * C and Wb arrive by 16-byte cp.async copies into a ring of three
//     stages (byte-exact staging; bf16 is widened when read), two steps
//     ahead; the band is double-buffered, and the x values of step s+1 are
//     loaded before step s's FMAs and turned into its band after them, so
//     one __syncthreads per step.  An N or pointer that does not allow
//     16-byte copies takes 4-byte copies (fp32) or element loads (bf16);
//   * split-K where the output tiles leave resident block slots empty
//     (512 x 1024 -> 512: 16 tiles; MNIST-KAN's 2048 x 784 -> 64: 16 tiles):
//     the K steps are shared out over gridDim.z slices, as many as fill one
//     wave (two 256-thread blocks per SM), each writes its fp32 partial tile,
//     and the last slice of a tile to finish (a ticket counter per tile)
//     adds the slices in slice order, so two calls give the same bits (no
//     float atomics), and resets its ticket;
//   * ragged edges are masked: an input past K or a row past BS contributes
//     zeros, and columns past N are not stored.
// Compiled for spline degrees P in {1, 2, 3} (GKAN has P = 1), as the
// TPU kernel takes any P; M = G+P <= 64.
// Numerics follow the TPU kernel: basis values are rounded to C's dtype
// before the product (band.astype(c.dtype)), ReLU(x) is rounded to Wb's
// dtype, accumulation is fp32, the output is x's dtype.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, fp32; the
// previous design, 64 x 64 SIMT tiles, in brackets): 0.1558 ms at
// 512 x 512 -> 1024 (0.5376) and 0.1622 ms at 512 x 1024 -> 512 (1.0980),
// against 0.1107 and 0.1099 ms for cuBLAS SGEMM over the materialised band.
// Its FMAs alone run at about 49 TFLOP/s; the band's evaluation (two IEEE
// divisions by 3 per basis value, as the reference orders them), the
// split-K partials and the barriers add the rest (tools/kernel_breakdown.py).
#include <algorithm>

#include "kan_common.cuh"

namespace {

constexpr int kBM = 128;           // output rows per block
constexpr int kKW = 36;            // target band columns per K step: BK*(M+1) <= kKW
constexpr int kStages = 3;         // cp.async ring of C/Wb rows
constexpr int kMaxSplits = 32;

template <typename T> constexpr int kVec = 16 / (int)sizeof(T);   // elements per 16-byte copy

// The 8 coefficients of a thread's columns (tx*4 .. +3 and BN/2 + tx*4 .. +3)
// in one staged row, as fp32.
template <int BN>
__device__ __forceinline__ void load_b8(const float* row, int tx, float* b) {
  const float4 lo = *reinterpret_cast<const float4*>(row + tx * 4);
  const float4 hi = *reinterpret_cast<const float4*>(row + BN / 2 + tx * 4);
  b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
  b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
}
template <int BN>
__device__ __forceinline__ void load_b8(const __nv_bfloat16* row, int tx, float* b) {
  const uint2 lo = *reinterpret_cast<const uint2*>(row + tx * 4);
  const uint2 hi = *reinterpret_cast<const uint2*>(row + BN / 2 + tx * 4);
  const unsigned w[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {              // bf16 -> fp32 is exact: the high half
    b[2 * i] = __uint_as_float(w[i] << 16);
    b[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Stage the B rows of K step `step` (BK*M rows of C viewed as (K*M, N), then
// BK rows of Wb) for columns n0 .. n0+BN-1; rows past K and columns past N
// are zeros.
template <typename TC, int BN, int THREADS, bool VEC>
__device__ __forceinline__ void load_stage(TC* dst, const TC* __restrict__ coeff,
                                           const TC* __restrict__ base_w, int step, int BK,
                                           int M, int K, int N, int n0, int tid) {
  constexpr int V = kVec<TC>;
  const int j0 = step * BK;
  const int nj = min(BK, K - j0);
  const int c_rows = BK * M, rows = c_rows + (base_w != nullptr ? BK : 0);
  const int per_row = VEC ? BN / V : BN;
  for (int e = tid; e < rows * per_row; e += THREADS) {
    const int r = e / per_row, c = (e % per_row) * (VEC ? V : 1);
    const TC* src;
    bool ok;
    if (r < c_rows) {
      ok = r < nj * M && n0 + c < N;
      src = coeff + ((size_t)j0 * M + r) * N + n0 + c;
    } else {
      ok = r - c_rows < nj && n0 + c < N;
      src = base_w + (size_t)(j0 + r - c_rows) * N + n0 + c;
    }
    if constexpr (VEC)
      kan::cp_async<16>(dst + r * BN + c, ok ? src : coeff, ok ? 16 : 0);
    else if constexpr (sizeof(TC) == 4)
      kan::cp_async<4>(dst + r * BN + c, ok ? src : coeff, ok ? 4 : 0);
    else dst[r * BN + c] = ok ? *src : kan::from_float<TC>(0.0f);
  }
}

// Write the band columns of one (row, input) pair: M basis slots (the P+1
// values at k-P .. k rounded to TC, zeros elsewhere) and, with a base term,
// ReLU(x) rounded to TC.  `valid` false writes zeros.
template <typename TC, int P>
__device__ __forceinline__ void write_pair(float* band, int r, int jj, float xf, bool valid,
                                           int M, int BK, bool has_base, float t0,
                                           float delta) {
  float* col = band + jj * M * kBM + r;
  for (int m = 0; m < M; ++m) col[m * kBM] = 0.0f;
  float xr = 0.0f;
  if (valid) {
    float vals[P + 1];
    const int k = kan::compact_basis<P>(xf, t0, delta, M, vals);
#pragma unroll
    for (int i = 0; i <= P; ++i) col[(k - P + i) * kBM] = kan::round_to<TC>(vals[i]);
    xr = kan::round_to<TC>(fmaxf(xf, 0.0f));
  }
  if (has_base) band[(BK * M + jj) * kBM + r] = xr;
}

template <typename TX, typename TC, int P, int BN, bool VEC>
__global__ void __launch_bounds__(2 * BN, 256 / BN)
kan_fused_kernel(const TX* __restrict__ x, const TC* __restrict__ coeff,
                 const TC* __restrict__ base_w, float* __restrict__ partial,
                 unsigned* __restrict__ tickets, TX* __restrict__ y, int BS, int K, int N,
                 int M, int BK, int steps_per_split, float t0, float delta) {
  constexpr int THREADS = 2 * BN;
  // (row, input) pairs per thread and step, enough for BK <= kKW/(P+2)
  // (M >= P+1); at least 8, the unrolling the P = 3 tiles were timed with
  constexpr int kNeed = (kBM * (kKW / (P + 2)) + THREADS - 1) / THREADS;
  constexpr int kPairs = kNeed > 8 ? kNeed : 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last_s;
  const bool has_base = base_w != nullptr;
  const int W = BK * (M + 1);                       // band columns per step (allocated)
  const int Wc = BK * M + (has_base ? BK : 0);      // columns the FMAs run over
  TC* ring = reinterpret_cast<TC*>(smem);           // kStages x (W, BN) rows of C, Wb
  float* band_s = reinterpret_cast<float*>(smem + (size_t)kStages * W * BN * sizeof(TC));

  const int tid = threadIdx.x;
  const int tx = tid % (BN / 8), ty = tid / (BN / 8);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int steps = (K + BK - 1) / BK;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(steps, s_begin + steps_per_split);
  const int npairs = kBM * BK;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (s_begin + st < s_end)
      load_stage<TC, BN, THREADS, VEC>(ring + st * W * BN, coeff, base_w, s_begin + st, BK, M,
                                       K, N, n0, tid);
    kan::cp_async_commit();
  }
  if (s_begin < s_end) {                            // the band of the first step
    for (int p = tid; p < npairs; p += THREADS) {
      const int r = p % kBM, jj = p / kBM, row = m0 + r, j = s_begin * BK + jj;
      const bool ok = row < BS && j < K;
      write_pair<TC, P>(band_s, r, jj, ok ? kan::to_float(x[(size_t)row * K + j]) : 0.0f, ok,
                        M, BK, has_base, t0, delta);
    }
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int s = s_begin; s < s_end; ++s) {
    const int it = s - s_begin;
    kan::cp_async_wait<kStages - 2>();              // step s's B rows have landed
    __syncthreads();                                // ... and its band; step s-1 is done
    if (s + kStages - 1 < s_end)
      load_stage<TC, BN, THREADS, VEC>(ring + ((it + kStages - 1) % kStages) * W * BN, coeff,
                                       base_w, s + kStages - 1, BK, M, K, N, n0, tid);
    kan::cp_async_commit();
    // x of step s+1, loaded now, turned into its band after this step's FMAs
    const bool next = s + 1 < s_end;
    float xv[kPairs];
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int p = tid + q * THREADS;
      const int r = p % kBM, jj = p / kBM, row = m0 + r, j = (s + 1) * BK + jj;
      xv[q] = (next && p < npairs && row < BS && j < K) ? kan::to_float(x[(size_t)row * K + j])
                                                        : 0.0f;
    }
    const float* a_s = band_s + (it % 2) * W * kBM;
    const TC* b_s = ring + (it % kStages) * W * BN;
#pragma unroll 4
    for (int kk = 0; kk < Wc; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(a_s + kk * kBM + ty * 4);
      const float4 a_hi = *reinterpret_cast<const float4*>(a_s + kk * kBM + 64 + ty * 4);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      float b[8];
      load_b8<BN>(b_s + kk * BN, tx, b);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (next) {
      float* nb = band_s + ((it + 1) % 2) * W * kBM;
#pragma unroll
      for (int q = 0; q < kPairs; ++q) {
        const int p = tid + q * THREADS;
        if (p >= npairs) break;
        const int r = p % kBM, jj = p / kBM, row = m0 + r, j = (s + 1) * BK + jj;
        write_pair<TC, P>(nb, r, jj, xv[q], row < BS && j < K, M, BK, has_base, t0, delta);
      }
    }
  }

  // Thread (ty, tx) holds rows ty*4 + i (64 + ty*4 + i - 4 for i >= 4) and
  // columns tx*4 + j (BN/2 + tx*4 + j - 4 for j >= 4) of the tile.
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (row >= BS) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4);
        if (n < N) y[(size_t)row * N + n] = kan::from_float<TX>(acc[i][j]);
      }
    }
    return;
  }
  // Split K: this slice's whole tile goes to the workspace, tile-major
  // ((tile, slice, kBM, BN) fp32), as float4; the last slice of the tile to
  // finish (a ticket counter per tile) adds the slices in slice order, so
  // two calls give the same bits.
  float* part = partial + (size_t)tile * gridDim.z * kBM * BN;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
    float* dst = part + ((size_t)blockIdx.z * kBM + r) * BN + tx * 4;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dst + BN / 2) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&tickets[tile], 1u) == gridDim.z - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int e = tid; e < kBM * BN / 4; e += THREADS) {
    const int r = e / (BN / 4), c = e % (BN / 4) * 4, row = m0 + r;
    if (row >= BS) continue;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int z = 0; z < (int)gridDim.z; ++z) {   // slice order: deterministic
      const float4 p =
          __ldcg(reinterpret_cast<const float4*>(part + ((size_t)z * kBM + r) * BN + c));
      v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
    }
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (n0 + c + q < N) y[(size_t)row * N + n0 + c + q] = kan::from_float<TX>(vs[q]);
  }
  if (tid == 0) tickets[tile] = 0u;   // ready for the next launch on this workspace
}

// Output columns per block: 64 where N <= 64, 256 where N >= 256 (the band
// is rebuilt for every column tile; 512 threads) if 16-byte copies serve
// and the ring fits (M <= 35), else 128.
int tile_n(int N, int M, bool vec) {
  return N <= 64 ? 64 : (N >= 256 && vec && M <= 35 ? 256 : 128);
}
int tiles(int BS, int N, int BN) { return ((N + BN - 1) / BN) * ((BS + kBM - 1) / kBM); }

// The most slices a call is split into (launch: as many as fill one wave of
// resident blocks, at most 256/BN per SM by the launch bounds).
int max_splits(int BS, int N, int BN, int sms) {
  return max(1, min(kMaxSplits, 256 / BN * sms / tiles(BS, N, BN)));
}

// The instantiations, numbered ((x dtype * 2 + C dtype) * 3 + P-1) * 5 + the
// tile: 0 = 64 columns by element, 1 = 64 by 16-byte copies, 2 = 128 by
// element, 3 = 128 by 16-byte copies, 4 = 256 by 16-byte copies.
constexpr int kTileKinds = 5;
constexpr int kInsts = 4 * 3 * kTileKinds;
int tile_kind(int BN, bool vec) { return BN == 64 ? (int)vec : (BN == 128 ? 2 + (int)vec : 4); }

template <typename TX, typename TC, int P>
const void* kernel_of_tile(int kind) {
  switch (kind) {
    case 0: return (const void*)kan_fused_kernel<TX, TC, P, 64, false>;
    case 1: return (const void*)kan_fused_kernel<TX, TC, P, 64, true>;
    case 2: return (const void*)kan_fused_kernel<TX, TC, P, 128, false>;
    case 3: return (const void*)kan_fused_kernel<TX, TC, P, 128, true>;
    default: return (const void*)kan_fused_kernel<TX, TC, P, 256, true>;
  }
}
template <typename TX, typename TC>
const void* kernel_of_p(int P, int kind) {
  return P == 1 ? kernel_of_tile<TX, TC, 1>(kind)
                : (P == 2 ? kernel_of_tile<TX, TC, 2>(kind) : kernel_of_tile<TX, TC, 3>(kind));
}
const void* kernel_of(int inst) {
  const int kind = inst % kTileKinds, P = inst / kTileKinds % 3 + 1, dt = inst / (3 * kTileKinds);
  switch (dt) {
    case 0: return kernel_of_p<float, float>(P, kind);
    case 1: return kernel_of_p<float, __nv_bfloat16>(P, kind);
    case 2: return kernel_of_p<__nv_bfloat16, float>(P, kind);
    default: return kernel_of_p<__nv_bfloat16, __nv_bfloat16>(P, kind);
  }
}

// the dynamic shared memory granted so far, per instantiation and device
int granted[kInsts][64] = {};

}  // namespace

// The launch plan of a call (kan_common.cuh: PlanField), which the launcher
// below computes with this function; kernel fields: BN, BK, K steps per
// slice.  `align`: the smallest ptr_align of coeff and base_w.  Grants the
// chosen instantiation this plan's shared memory and asks the occupancy
// calculator for its resident blocks per SM, which the split counts on.
// Returns a cudaError_t.
extern "C" int kan_fused_gemm_plan(int BS, int K, int N, int M, int P, int x_dtype, int c_dtype,
                                   int align, int* plan) {
  kan::plan_clear(plan);
  if (P < 1 || P > 3 || M <= P || M > 64 || BS < 1 || K < 0 || N < 1 || x_dtype < 0 ||
      x_dtype > 1 || c_dtype < 0 || c_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int esize = c_dtype == 0 ? 4 : 2;
  const bool vec = N % (16 / esize) == 0 && align % 16 == 0;
  const int BN = tile_n(N, M, vec);
  const int BK = max(1, kKW / (M + 1));
  const int W = BK * (M + 1);
  const int inst = ((x_dtype * 2 + c_dtype) * 3 + P - 1) * kTileKinds + tile_kind(BN, vec);
  const int smem = kStages * W * BN * esize + 2 * W * kBM * (int)sizeof(float);
  const int sms = kan::sm_count();
  // granted first: the calculator counts no more than the grant
  int per_sm = 1;
  cudaError_t err = kan::grant_smem(kernel_of(inst), smem, granted[inst]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(inst), 2 * BN, smem);
  if (err != cudaSuccess) return (int)err;
  // Split K only where the output tiles leave resident block slots empty:
  // as many slices as fill one wave, each a whole number of steps.
  const int steps = (K + BK - 1) / BK;
  int splits = min(max(1, per_sm * sms / tiles(BS, N, BN)), max_splits(BS, N, BN, sms));
  splits = min(splits, max(steps, 1));
  const int per_split = max(1, (steps + splits - 1) / splits);
  splits = max(1, (steps + per_split - 1) / per_split);
  plan[kan::kGridX] = (N + BN - 1) / BN;
  plan[kan::kGridY] = (BS + kBM - 1) / kBM;
  plan[kan::kGridZ] = splits;
  plan[kan::kBlockThreads] = 2 * BN;
  plan[kan::kDynSmem] = smem;
  plan[kan::kGrant] = smem;
  plan[kan::kVecBytes] = vec ? 16 : esize;
  plan[kan::kInst] = inst;
  plan[kan::kSms] = sms;
  plan[kan::kPerSm] = per_sm;
  plan[kan::kExtra] = BN;
  plan[kan::kExtra + 1] = BK;
  plan[kan::kExtra + 2] = per_split;
  return 0;
}

// Workspace of one call at (BS, K, N), in two buffers the caller keeps:
// the ticket counters, one uint32 per output tile, which must be zero
// before a call and which every call leaves zero; and the K slices' fp32
// partial tiles, any contents.
// Sized for any tile width a call at (BS, N) may take.
extern "C" long long kan_fused_gemm_tickets(int BS, int N) {
  return (long long)tiles(BS, N, tile_n(N, 64, false));
}
extern "C" long long kan_fused_gemm_partials(int BS, int K, int N) {
  long long most = 0;
  for (const int BN : {tile_n(N, 64, false), tile_n(N, 0, true)}) {
    const int s = max_splits(BS, N, BN, kan::sm_count());
    if (s > 1) most = std::max(most, (long long)tiles(BS, N, BN) * s * kBM * BN);
  }
  return most;
}

// Compiled for P in {1, 2, 3} and M <= 64.  dtype codes: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int kan_fused_gemm(const void* x, const void* coeff, const void* base_w,
                              void* tickets, void* partial, void* y, int BS, int K, int N,
                              int M, int P, float t0, float delta, int x_dtype, int c_dtype,
                              void* stream) {
  int plan[kan::kPlanInts];
  const int err = kan_fused_gemm_plan(BS, K, N, M, P, x_dtype, c_dtype,
                                      min(kan::ptr_align(coeff), kan::ptr_align(base_w)), plan);
  if (err != 0) return err;
  int BK = plan[kan::kExtra + 1], per_split = plan[kan::kExtra + 2];
  void* args[] = {&x, &coeff, &base_w, &partial, &tickets, &y, &BS, &K, &N, &M,
                  &BK, &per_split, &t0, &delta};
  return kan::launch_planned(kernel_of(plan[kan::kInst]), plan, args,
                             static_cast<cudaStream_t>(stream), nullptr);
}
