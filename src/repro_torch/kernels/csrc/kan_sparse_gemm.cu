// Compact N:M sparse KAN GEMV for Hopper (sm_90a), the decode path.
//
// Replaces the TPU kernel repro/kernels/kan_sparse_gemm.py (_sparse_kernel,
// launched by kan_sparse_gemm_pallas): Y = B(x) @ C + ReLU(x) @ Wb where each
// input contracts only its P+1 non-zero basis values against the coefficient
// slab C[j, k-P .. k, :] it touches (the paper's N:M vector PE).
// Numerics follow the TPU kernel: basis values rounded to C's dtype before
// the product, ReLU(x) rounded to Wb's dtype, fp32 accumulation.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes of the coefficient rows the
// rows' windows touch, of Wb, x and y.  K = 512, N = 1024, M = 8: at 4 rows
// of tanh'd normal inputs the windows touch ~88 % of the 16.8 MB of fp32
// coefficients, ~17 MB with Wb (~5.1 us; 2.6 us in bf16); at 1 row half.
// A decode call moves a few MB at most, so a call is a stream of bytes
// and, at the narrow layers (MNIST-KAN's 784 -> 64 and 64 -> 10), a chain
// of latencies: launch, one trip to device memory, the split-K sum.
//
// Design, ONE launch:
//   * a block holds up to 8 rows, a column tile of CT = V*TQ columns (V =
//     16 bytes of C's dtype: 4 fp32 or 8 bf16 columns a thread, TQ threads
//     along the columns, the smallest power of two in 4..32 that gives
//     about 16 column tiles) and a K slice of JS inputs, one or two rounds
//     of TJ = 256/TQ input lanes; JS is chosen from K, N, M, C's dtype and
//     the SM count for about two blocks per SM and at most 16 slices (at
//     most 96 KB of staged rows a block), never from the row count, so a
//     row's bits do not depend on the other rows of the call.
//     4 x 512 -> 1024 fp32: 16 tiles x 16 slices of 32 inputs;
//     8 x 784 -> 64: 4 tiles x 16 slices of 49;
//   * input jj = q*TJ + tj belongs to the TQ consecutive lanes tj of one
//     warp; each lane stages, by 16-byte cp.async into shared memory, and
//     later reads, only its own 16 bytes of the input's coefficient rows
//     C[j, 0..M-1, tile] and Wb row, one copy group a round.  A lane waits
//     for its own copies only: no barrier stands between the copies and
//     the contraction, and the contraction of round 0 overlaps the copies
//     of round 1.  Everything is asked for first: x of the group's rows,
//     then the rows (zero-filled past N; 4-byte elements where N is not a
//     whole number of 16-byte groups, 2-byte loads for a bf16 row of odd
//     length).  A block of at most kSelectRows = 2 rows copies, once x is
//     in, only the rows its windows touch (at 1 row half of them, ~1 us
//     less than copying all; at 2 rows the two tie); a fuller block copies
//     all M rows, since its windows cover most of them (~88 % at 4 rows),
//     and waiting for x first costs more;
//   * per (row, input) one packed entry, made by one lane of the group
//     (shared memory, a warp barrier): the offset of its window's first
//     row, the P+1 basis values rounded to C's dtype, and ReLU(x) rounded
//     to Wb's dtype;
//   * per (row, input) a lane reads the P+1 touched 16-byte groups of its
//     columns and takes P+1 FMAs per column, plus one for the base term;
//   * the TJ input lanes are summed in shared memory in a fixed order
//     (groups of 8 lanes, then the groups); a slice writes its fp32
//     partial tile (BS x N rounded up to 4, so a column quad is one 16-byte
//     access), and the block that finishes a column tile last (a ticket
//     counter per tile, taken by one thread with release and acquire
//     semantics after a block barrier: no fence per thread) sums the
//     tile's slices in a fixed order (groups of 8 slices in slice order, a
//     thread a group and column quad, then the groups in order), casts to
//     x's dtype and resets its ticket for the next launch.  Two calls give
//     the same bits; no float atomics.  One slice writes y directly.
//
// Times: PERF.md section 6 (chip_smoke.py, with the card's name and power
// limit) and tools/kernel_breakdown.py --only sparse, which also times the
// previous design (a MAXM-wide band per (row, input), scalar loads and a
// serial slice sum) beside this one.  The copies run at the card's rate;
// the lane sums, ticket and slice sum after them are the largest rest.
// Compiled for spline degrees P in {1, 2, 3} (GKAN has P = 1), M = G+P <= 16.
#include "kan_common.cuh"

namespace {

constexpr int kRows = 8;                  // rows per block
constexpr int kThreads = 256;
constexpr int kMinTQ = 4;
constexpr int kMaxStageBytes = 96 * 1024; // a slice's staged rows, at most
constexpr int kBlocksPerSM = 2;           // the split's target
constexpr int kTilesTarget = 16;          // column tiles the tile width aims for
constexpr int kSelectRows = 2;            // blocks of <= this many rows copy touched rows only
constexpr int kLaneGroup = 8;             // input lanes summed together
constexpr int kMaxSlices = 16;            // K slices of a tile, where the staged rows allow
constexpr int kSumBatch = 8;              // slices whose partials the tail loads at once
constexpr int kMaxRounds = 2;             // inputs of one thread group in a slice, at most

// Threads along the columns: the smallest power of two in kMinTQ..32 whose
// tile of V columns a thread gives about kTilesTarget tiles.
__host__ __device__ __forceinline__ int tile_quads(int N, int V) {
  int tq = kMinTQ;
  while (tq < 32 && tq * V * kTilesTarget < N) tq *= 2;
  return tq;
}

struct Split {
  int TQ, tiles_n, row_blocks, JS, slices;
};

// The tiling of a call: column tiles and K slices from (K, N, M, C's
// element size) and the SM count, row blocks from BS.
__host__ __device__ __forceinline__ Split split(int BS, int K, int N, int M, int esize,
                                                int sms) {
  Split s;
  const int V = 16 / esize;
  s.TQ = tile_quads(N, V);
  const int CT = V * s.TQ, TJ = kThreads / s.TQ;
  s.tiles_n = (N + CT - 1) / CT;
  s.row_blocks = (BS + kRows - 1) / kRows;
  const int want = max(1, kBlocksPerSM * sms / s.tiles_n);
  int js = max((K + want - 1) / want, (K + kMaxSlices - 1) / kMaxSlices);
  if (js > TJ) js = (js + TJ - 1) / TJ * TJ;                     // whole rounds of TJ inputs
  const int cap = max(TJ, min(kMaxRounds * TJ, kMaxStageBytes / ((M + 1) * CT * esize)) /
                              TJ * TJ);
  s.JS = min(js, cap);
  s.slices = max(1, (K + s.JS - 1) / s.JS);
  return s;
}

// Shared memory of a block, in bytes from its start: the slice's staged
// rows, reused for the input lanes' sums and their groups' sums and, in a
// tile's last block, the slice groups' sums; the slice's entries.
struct Layout {
  int area, total;                        // the entries start at `area`
};
__host__ __device__ __forceinline__ Layout layout(const Split& s, int M, int esize) {
  const int CT = 16 / esize * s.TQ, TJ = kThreads / s.TQ;
  Layout l;
  l.area = (max(s.JS * (M + 1) * CT * esize, (TJ + TJ / kLaneGroup) * kRows * CT * 4) + 15) /
           16 * 16;
  l.total = l.area + kRows * s.JS * 24;
  return l;
}

// The fp32 partials of a slice are (BS, Np), N rounded up to 4.
__host__ __device__ __forceinline__ int padded(int N) { return (N + 3) / 4 * 4; }

// 16 bytes of shared memory as V floats.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // bf16 -> fp32 is exact: the high half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}

// Copy this thread's 16 bytes (V columns from n) of the staged rows of
// input j to dst (rows CT elements apart): coefficient rows m < M whose
// bit is set in `rows`, and the Wb row if `base`.  Columns past N are
// zeros.
// U = 16 and 4: cp.async of U bytes; U = 2: plain loads.
template <typename TC, int U>
__device__ __forceinline__ void copy_own(TC* dst, const TC* __restrict__ coeff,
                                         const TC* __restrict__ base_w, unsigned rows, bool base,
                                         int j, int M, int N, int n, int CT) {
  constexpr int V = 16 / sizeof(TC), E = U / sizeof(TC);   // elements a thread, a copy
  for (int m = 0; m <= M; ++m) {
    if (m < M ? !((rows >> m) & 1u) : !base) continue;
    const TC* src = m < M ? coeff + ((size_t)j * M + m) * N : base_w + (size_t)j * N;
#pragma unroll
    for (int e = 0; e < V; e += E) {
      const bool ok = n + e < N;
      if constexpr (U == 2) dst[m * CT + e] = ok ? src[n + e] : kan::from_float<TC>(0.0f);
      else kan::cp_async<U>(dst + m * CT + e, ok ? src + n + e : coeff, ok ? U : 0);
    }
  }
}

// Wait until at most n of this thread's cp.async groups are in flight
// (past 3, at most 3: more complete is still right).
__device__ __forceinline__ void wait_pending(int n) {
  if (n >= 3) kan::cp_async_wait<3>();
  else if (n == 2) kan::cp_async_wait<2>();
  else if (n == 1) kan::cp_async_wait<1>();
  else kan::cp_async_wait<0>();
}

template <typename TX, typename TC, int P, int U>
__global__ void __launch_bounds__(kThreads, 2)
kan_sparse_kernel(const TX* __restrict__ x, const TC* __restrict__ coeff,
                  const TC* __restrict__ base_w, float* __restrict__ partial,
                  unsigned* __restrict__ tickets, TX* __restrict__ y, int BS, int K, int N,
                  int M, float t0, float delta, Split sp) {
  constexpr int V = 16 / sizeof(TC);
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ bool last_s;
  const Layout L = layout(sp, M, sizeof(TC));
  const int CT = V * sp.TQ, TJ = kThreads / sp.TQ, JS = sp.JS;
  const bool has_base = base_w != nullptr;
  const int R = M + (has_base ? 1 : 0);
  TC* c_s = reinterpret_cast<TC*>(smem);
  float4* val_s = reinterpret_cast<float4*>(smem + L.area);              // [kRows][JS]
  int2* ent_s = reinterpret_cast<int2*>(smem + L.area + kRows * JS * 16);

  const int tid = threadIdx.x;
  const int tq = tid % sp.TQ, tj = tid / sp.TQ;
  const int tile = blockIdx.x;
  const int n0 = (tile % sp.tiles_n) * CT, r0 = (tile / sp.tiles_n) * kRows;
  const int slice = blockIdx.y, j0 = slice * JS, js = min(JS, K - j0);
  const int nrows = min(kRows, BS - r0);
  const int Np = padded(N);
  const bool select = nrows <= kSelectRows;   // copy only the touched rows
  const int rounds = (JS + TJ - 1) / TJ;
  const unsigned all_rows = (1u << M) - 1u;
  TC* own = c_s + tq * V;                      // this thread's columns of the staged rows

  // Each input jj = q*TJ + tj of the slice belongs to the TQ threads of one
  // group (consecutive lanes of one warp), each of which stages, and later
  // reads, only its own 16 bytes of the input's rows: a thread waits for
  // its own copies, and no barrier stands between copies and contraction.
  // 1. Ask for everything: x of the group's rows (lane tq: rows tq, tq+TQ,
  //    ..) first, then (a fuller block) every row of every input.
  float xv[kMaxRounds][kRows / kMinTQ];
#pragma unroll
  for (int q = 0; q < kMaxRounds; ++q)
#pragma unroll
    for (int i = 0; i < kRows / kMinTQ; ++i) {
      const int jj = q * TJ + tj, r = tq + i * sp.TQ;
      xv[q][i] = (q < rounds && jj < js && r < nrows)
                     ? kan::to_float(x[(size_t)(r0 + r) * K + j0 + jj]) : 0.0f;
    }
  if (!select) {
    for (int q = 0; q < rounds; ++q) {
      const int jj = q * TJ + tj;
      if (jj < js)
        copy_own<TC, U>(own + jj * R * CT, coeff, base_w, all_rows, has_base, j0 + jj, M, N,
                        n0 + tq * V, CT);
      kan::cp_async_commit();                  // one group a round
    }
  }

  // 2. The B-spline unit: per (row, input) its window's offset in c_s, its
  //    P+1 values rounded to C's dtype and ReLU(x) rounded to Wb's; with
  //    `select`, the rows the group's windows touch (OR over the group).
  unsigned touched[kMaxRounds];
#pragma unroll
  for (int q = 0; q < kMaxRounds; ++q) {
    touched[q] = 0u;
    const int jj = q * TJ + tj;
#pragma unroll
    for (int i = 0; i < kRows / kMinTQ; ++i) {
      const int r = tq + i * sp.TQ;
      if (q < rounds && jj < js && r < nrows) {
        float vals[P + 1];
        const int k = kan::compact_basis<P>(xv[q][i], t0, delta, M, vals);
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int t = 0; t <= P; ++t) v[t] = kan::round_to<TC>(vals[t]);
        val_s[r * JS + jj] = make_float4(v[0], v[1], v[2], v[3]);
        ent_s[r * JS + jj] = make_int2(
            (jj * R + k - P) * CT, __float_as_int(kan::round_to<TC>(fmaxf(xv[q][i], 0.0f))));
        touched[q] |= kan::window_mask<P>(k);
      }
    }
    for (int o = 1; o < sp.TQ; o *= 2) touched[q] |= __shfl_xor_sync(0xffffffffu, touched[q], o);
  }
  __syncwarp();
  if (select) {
#pragma unroll
    for (int q = 0; q < kMaxRounds; ++q) {
      const int jj = q * TJ + tj;
      if (q < rounds) {
        if (jj < js)
          copy_own<TC, U>(own + jj * R * CT, coeff, base_w, touched[q], has_base, j0 + jj, M,
                          N, n0 + tq * V, CT);
        kan::cp_async_commit();
      }
    }
  }

  // 3. The contraction, round by round as this thread's copies land: per
  //    (row, input) P+1 16-byte shared loads and P+1 FMAs per column, then
  //    the base term.
  float acc[kRows][V];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.0f;
  for (int q = 0; q < rounds; ++q) {
    wait_pending(rounds - 1 - q);
    const int jj = q * TJ + tj;
    if (jj >= js) continue;
    float wb[V];
    if (has_base) load16(own + (jj * R + M) * CT, wb);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nrows) {
        const float4 vals = val_s[r * JS + jj];
        const int2 e = ent_s[r * JS + jj];
        const float vi[4] = {vals.x, vals.y, vals.z, vals.w};
        const TC* w = own + e.x;
#pragma unroll
        for (int i = 0; i <= P; ++i) {
          float cv[V];
          load16(w + i * CT, cv);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[r][v] = fmaf(vi[i], cv[v], acc[r][v]);
        }
        if (has_base) {
          const float xr = __int_as_float(e.y);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[r][v] = fmaf(xr, wb[v], acc[r][v]);
        }
      }
    }
  }

  // 4. Sum the TJ input lanes in shared memory (over the staged rows): each
  //    group of kLaneGroup lanes in lane order, then the groups in order; one
  //    slice writes y, more write their partials.
  __syncthreads();
  float* lane_s = reinterpret_cast<float*>(smem);                    // [TJ][kRows][CT]
  float4* group_s = reinterpret_cast<float4*>(smem + TJ * kRows * CT * 4);
  const int quads = CT / 4, nq = nrows * quads, ng = TJ / kLaneGroup;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int v = 0; v < V; v += 4)
      if (r < nrows)
        *reinterpret_cast<float4*>(lane_s + (tj * kRows + r) * CT + tq * V + v) =
            make_float4(acc[r][v], acc[r][v + 1], acc[r][v + 2], acc[r][v + 3]);
  __syncthreads();
  for (int it = tid; it < nq * ng; it += kThreads) {
    const int o = it % nq, g = it / nq, r = o / quads, c = (o % quads) * 4;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int l = 0; l < kLaneGroup; ++l)
      add4(s, *reinterpret_cast<const float4*>(
                  lane_s + ((g * kLaneGroup + l) * kRows + r) * CT + c));
    group_s[g * nq + o] = s;
  }
  __syncthreads();
  const bool one_slice = gridDim.y == 1;
  for (int o = tid; o < nq; o += kThreads) {
    const int r = o / quads, c = (o % quads) * 4;
    if (n0 + c >= N) continue;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int g = 0; g < ng; ++g) add4(s, group_s[g * nq + o]);
    if (one_slice) {
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (n0 + c + v < N) y[(size_t)(r0 + r) * N + n0 + c + v] = kan::from_float<TX>(sv[v]);
    } else {
      *reinterpret_cast<float4*>(partial + ((size_t)slice * BS + r0 + r) * Np + n0 + c) = s;
    }
  }
  if (one_slice) return;

  // 5. The last slice of this tile to finish sums the tile's slices: each
  //    group of G consecutive slices in slice order (one thread a group and
  //    column quad, kSumBatch loads in flight), then the groups in order.
  //    G is kSumBatch unless the group sums would not fit the shared area;
  //    it depends on the slice count only, so the order is the same at
  //    every row count.  Thread 0 takes the ticket with release and
  //    acquire semantics after the block barrier (so the block's partials
  //    are visible before it, and the others' after it).
  __syncthreads();
  if (tid == 0) last_s = kan::atomic_add_acq_rel(&tickets[tile], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last_s) return;
  const int S = gridDim.y, most = L.area / (kRows * CT * 4);
  const int G = max(kSumBatch, ((S + most - 1) / most + kSumBatch - 1) / kSumBatch * kSumBatch);
  const int ngroups = (S + G - 1) / G;
  float4* sum_s = reinterpret_cast<float4*>(smem);                // [ngroups][nq]
  for (int it = tid; it < ngroups * nq; it += kThreads) {
    const int g = it / nq, o = it % nq, r = o / quads, c = (o % quads) * 4;
    const float* src = partial + (size_t)(r0 + r) * Np + n0 + c;
    const int s1 = n0 + c < N ? min(S, (g + 1) * G) : 0;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s0 = g * G; s0 < s1; s0 += kSumBatch) {
      float4 v[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        if (s0 + u < s1)
          v[u] = __ldcg(reinterpret_cast<const float4*>(src + (size_t)(s0 + u) * BS * Np));
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        if (s0 + u < s1) add4(s, v[u]);
    }
    sum_s[it] = s;
  }
  __syncthreads();
  for (int o = tid; o < nq; o += kThreads) {
    const int r = o / quads, c = (o % quads) * 4;
    if (n0 + c >= N) continue;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int g = 0; g < ngroups; ++g) add4(s, sum_s[g * nq + o]);
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int v = 0; v < 4; ++v)
      if (n0 + c + v < N) y[(size_t)(r0 + r) * N + n0 + c + v] = kan::from_float<TX>(sv[v]);
  }
  if (tid == 0) tickets[tile] = 0u;   // ready for the next launch on this workspace
}

// The instantiations, numbered ((x dtype * 2 + C dtype) * 3 + P-1) * 3 + the
// copy unit: 0 = 16-byte groups, 1 = 4-byte elements, 2 = 2-byte elements
// (bf16 rows of odd length; not compiled for fp32 C).
constexpr int kInsts = 4 * 3 * 3;

template <typename TX, typename TC, int P>
const void* kernel_of_unit(int u) {
  if (u == 0) return (const void*)kan_sparse_kernel<TX, TC, P, 16>;
  if (u == 1) return (const void*)kan_sparse_kernel<TX, TC, P, 4>;
  if constexpr (sizeof(TC) == 2) return (const void*)kan_sparse_kernel<TX, TC, P, 2>;
  return nullptr;
}
template <typename TX, typename TC>
const void* kernel_of_p(int P, int u) {
  return P == 1 ? kernel_of_unit<TX, TC, 1>(u)
                : (P == 2 ? kernel_of_unit<TX, TC, 2>(u) : kernel_of_unit<TX, TC, 3>(u));
}
const void* kernel_of(int inst) {
  const int u = inst % 3, P = inst / 3 % 3 + 1, dt = inst / 9;
  switch (dt) {
    case 0: return kernel_of_p<float, float>(P, u);
    case 1: return kernel_of_p<float, __nv_bfloat16>(P, u);
    case 2: return kernel_of_p<__nv_bfloat16, float>(P, u);
    default: return kernel_of_p<__nv_bfloat16, __nv_bfloat16>(P, u);
  }
}

// the dynamic shared memory granted so far, per instantiation and device
int granted[kInsts][64] = {};

}  // namespace

// The launch plan of a call (kan_common.cuh: PlanField), which the launcher
// below computes with this function; kernel fields: TQ, JS, column tiles,
// row blocks.  `align`: the smallest ptr_align of coeff and base_w.
// Returns a cudaError_t.
extern "C" int kan_sparse_gemm_plan(int BS, int K, int N, int M, int P, int x_dtype,
                                    int c_dtype, int align, int* plan) {
  kan::plan_clear(plan);
  if (P < 1 || P > 3 || M <= P || M > 16 || K < 1 || BS < 1 || N < 1 || x_dtype < 0 ||
      x_dtype > 1 || c_dtype < 0 || c_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int esize = c_dtype == 0 ? 4 : 2;
  const Split s = split(BS, K, N, M, esize, kan::sm_count());
  // the copy unit: 16-byte groups, else 4-byte or (bf16 rows of odd length)
  // 2-byte elements
  auto aligned = [&](int b) { return (N * esize) % b == 0 && align % b == 0; };
  const int u = aligned(16) ? 0 : (aligned(4) ? 1 : 2);
  if (u == 2 && esize == 4) return (int)cudaErrorMisalignedAddress;
  plan[kan::kGridX] = s.tiles_n * s.row_blocks;
  plan[kan::kGridY] = s.slices;
  plan[kan::kGridZ] = 1;
  plan[kan::kBlockThreads] = kThreads;
  plan[kan::kDynSmem] = layout(s, M, esize).total;
  plan[kan::kGrant] = plan[kan::kDynSmem];
  plan[kan::kVecBytes] = u == 0 ? 16 : (u == 1 ? 4 : 2);
  plan[kan::kInst] = ((x_dtype * 2 + c_dtype) * 3 + P - 1) * 3 + u;
  plan[kan::kSms] = kan::sm_count();
  plan[kan::kExtra] = s.TQ;
  plan[kan::kExtra + 1] = s.JS;
  plan[kan::kExtra + 2] = s.tiles_n;
  plan[kan::kExtra + 3] = s.row_blocks;
  return 0;
}

// Workspace of one call at (BS, K, N), in two buffers the caller keeps:
// the ticket counters, one uint32 per column tile and row block, which
// must be zero before a call and which every call leaves zero; and the
// K slices' fp32 partials, (BS, N rounded up to 4) each, any contents.
// Both are the largest over the splits a launch on the current device may
// take: either dtype of C and any M (split() decides, as at launch).
namespace {
template <typename F>
long long most_over_splits(int BS, int K, int N, F size) {
  long long most = 0;
  for (int esize = 2; esize <= 4; esize *= 2)
    for (int M = 2; M <= 16; ++M) {
      const long long n = size(split(BS, K, N, M, esize, kan::sm_count()));
      most = n > most ? n : most;
    }
  return most;
}
}  // namespace
extern "C" long long kan_sparse_gemm_tickets(int BS, int N) {
  return most_over_splits(BS, 1, N, [](const Split& s) {
    return (long long)s.tiles_n * s.row_blocks;
  });
}
extern "C" long long kan_sparse_gemm_partials(int BS, int K, int N) {
  return most_over_splits(BS, K, N, [&](const Split& s) {
    return (long long)s.slices * BS * padded(N);
  });
}

// Compiled for P in {1, 2, 3} and M <= 16.  dtype codes: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int kan_sparse_gemm(const void* x, const void* coeff, const void* base_w,
                               void* tickets, void* partial, void* y, int BS, int K, int N,
                               int M, int P, float t0, float delta, int x_dtype, int c_dtype,
                               void* stream) {
  int plan[kan::kPlanInts];
  const int err = kan_sparse_gemm_plan(BS, K, N, M, P, x_dtype, c_dtype,
                                       min(kan::ptr_align(coeff), kan::ptr_align(base_w)), plan);
  if (err != 0) return err;
  Split s;
  s.TQ = plan[kan::kExtra];
  s.JS = plan[kan::kExtra + 1];
  s.tiles_n = plan[kan::kExtra + 2];
  s.row_blocks = plan[kan::kExtra + 3];
  s.slices = plan[kan::kGridY];
  void* args[] = {&x, &coeff, &base_w, &partial, &tickets, &y, &BS, &K, &N, &M, &t0, &delta, &s};
  const int inst = plan[kan::kInst];
  return kan::launch_planned(kernel_of(inst), plan, args, static_cast<cudaStream_t>(stream),
                             granted[inst]);
}
