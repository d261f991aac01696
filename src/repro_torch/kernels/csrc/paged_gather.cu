// Block-table gather for the paged KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_gather.py (_gather_kernel,
// launched by gather_blocks_pallas once per leaf): the logical contiguous
// view of every leaf of a paged cache,
//
//     view[layer, b, l*bs + o, ...] = pool[layer, clip(table[b, l]), o, ...],
//
// pure data movement with no arithmetic on the values.  On the TPU the block
// table rides in scalar-prefetch memory and each grid step is one DMA; here
// each CTA loads its own table entry and copies a part of one logical block.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes of every distinct physical
// block the table names, read once per layer, plus the views, written once.
// The continuous cell's step read (one layer, k and v: 2 x 96 blocks of
// 16 x 8 x 64 fp32, 6.3 MB written) is about 3.3 us; its shadow read (the
// 8 stacked layers, 50 MB written) about 26 us.  At the step read the copy
// is shorter than a memory round trip plus the launch, so what a design
// can win there is latency: every byte asked for at once, in one launch.
//
// Design, ONE launch for every leaf that shares a table (k and v, up to
// kMaxLeaves, each with its own pool, view, block size and dtype) and every
// layer of a stacked pool:
//   * the grid is (b * L + l, part of a block, leaf and layer): a CTA finds
//     its table entry, its leaf (the descriptors ride by value in the
//     kernel's parameters) and both addresses without a division, so the
//     table load, which every other load waits on, is issued first;
//   * a CTA copies one part of a block (kThreads x kUnroll x 16 bytes, 8 KB):
//     each thread issues its kUnroll 16-byte loads before its first store,
//     so the grid has every part's bytes in flight at once (3 MB a leaf at
//     the step read, against one 16-byte load per thread in the previous
//     design, a CUDA block per logical block, whose threads waited on 8
//     round trips in a row); 16-byte loads ask the L2 for whole 256-byte
//     lines;
//   * blocks whose byte size or base addresses are not 16-byte aligned are
//     copied one element at a time (4, 2 or 1 bytes), with the same grid and
//     the same loads-before-stores order, so one kernel serves fp32, bf16,
//     fp16, int8 and uint8 leaves;
//   * neighbouring threads move neighbouring words: every load and store is
//     coalesced;
//   * table ids are clipped to [0, n_blocks - 1] (jnp.take's mode="clip",
//     which the JAX package's plain version documents); the serving engine
//     never emits an id outside the pool (its tables are sentinel-filled).
// tools/kernel_breakdown.py --only gather times it beside 4 and 16 KB parts,
// plain loads, streaming stores, and a second design that lost at every
// shape: 1-D bulk copies (cp.async.bulk) of 16 or 32 KB parts through
// shared memory, issued by one thread of a 32-thread CTA.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W: PERF.md §6.  It launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <cstdint>

#include "kan_common.cuh"

// One leaf as the C entry takes it: pool (layers, n_blocks, block_bytes)
// and view (layers, B, L, block_bytes), both contiguous; elem_bytes is the
// element size (1, 2 or 4), the copy unit when 16 bytes do not fit.
struct PagedLeaf {
  const void* pool;
  void* view;
  long long block_bytes;
  int n_blocks;
  int layers;
  int elem_bytes;
};

namespace {

constexpr int kMaxLeaves = 4;
constexpr int kThreads = 128;
constexpr int kUnroll = 4;              // loads in flight per thread

struct Leaf {
  const uint8_t* pool;
  uint8_t* view;
  long long block_bytes;
  int first;                            // the leaf's first grid z (layer) index
  int part_bytes;                       // bytes a CTA copies
  int parts;                            // CTAs per block
  int n_blocks;
  int unit;                             // copy unit: 16, 4, 2 or 1 bytes
};
struct Leaves {
  Leaf leaf[kMaxLeaves];
  int n;
};

// A word of a pool, through the read-only path; a 16-byte word with the
// hint that the L2 fetch its whole 256-byte line (the CTA's neighbouring
// threads read the rest of it).
template <typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (sizeof(T) == 16) {
    T v;
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
  } else {
    return __ldg(p);
  }
}

// Copy len bytes (a whole number of T) from src to dst: each thread loads
// its kUnroll words, then stores them.  len <= blockDim.x * kUnroll * sizeof(T).
template <typename T>
__device__ __forceinline__ void copy_registers(const uint8_t* src, uint8_t* dst, int len) {
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  const int n = len / (int)sizeof(T);
  T r[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int k = threadIdx.x + u * blockDim.x;
    if (k < n) r[u] = load(s + k);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int k = threadIdx.x + u * blockDim.x;
    if (k < n) d[k] = r[u];
  }
}

// Grid (b * L + l, part, leaf and layer): no division on the way to the
// table entry, which every load of the CTA waits on.
__global__ void __launch_bounds__(kThreads)
paged_gather_kernel(const __grid_constant__ Leaves leaves, const int* __restrict__ table) {
  const int z = blockIdx.z;
  Leaf f = leaves.leaf[0];              // this CTA's leaf: the last that starts at or before z
#pragma unroll
  for (int i = 1; i < kMaxLeaves; ++i)
    if (i < leaves.n && z >= leaves.leaf[i].first) f = leaves.leaf[i];
  const int part = blockIdx.y;
  if (part >= f.parts) return;          // a leaf of fewer parts than the grid's
  const int bl = blockIdx.x;
  const long long layer = z - f.first;
  int id = __ldg(table + bl);
  id = id < 0 ? 0 : (id >= f.n_blocks ? f.n_blocks - 1 : id);
  const long long off = (long long)part * f.part_bytes;
  const int len = (int)min((long long)f.part_bytes, f.block_bytes - off);
  const uint8_t* src = f.pool + (layer * f.n_blocks + id) * f.block_bytes + off;
  uint8_t* dst = f.view + (layer * gridDim.x + bl) * f.block_bytes + off;
  if (f.unit == 16) {
    copy_registers<uint4>(src, dst, len);
  } else if (f.unit == 4) {
    copy_registers<uint32_t>(src, dst, len);
  } else if (f.unit == 2) {
    copy_registers<uint16_t>(src, dst, len);
  } else {
    copy_registers<uint8_t>(src, dst, len);
  }
}

// The launch plan of a call into `d` (the leaves as the kernel takes them)
// and `plan` (kan_common.cuh: PlanField; kernel fields: each leaf's copy
// unit).  A call with nothing to copy plans a (0, 0, 0) grid: no launch.
int plan_leaves(const PagedLeaf* leaves, int n_leaves, int B, int L, Leaves* d, int* plan) {
  kan::plan_clear(plan);
  *d = Leaves{};
  if (n_leaves < 1 || n_leaves > kMaxLeaves || B < 0 || L < 0)
    return (int)cudaErrorInvalidValue;
  long long layers = 0, parts = 0;
  int unit = 16;
  for (int i = 0; i < n_leaves; ++i) {
    const PagedLeaf& p = leaves[i];
    const int e = p.elem_bytes;
    if (p.layers < 0 || p.n_blocks < 1 || p.block_bytes < 0 || (e != 1 && e != 2 && e != 4) ||
        p.block_bytes % e)
      return (int)cudaErrorInvalidValue;
    if (p.layers == 0 || p.block_bytes == 0) continue;
    Leaf& f = d->leaf[d->n];
    f.pool = static_cast<const uint8_t*>(p.pool);
    f.view = static_cast<uint8_t*>(p.view);
    f.block_bytes = p.block_bytes;
    f.n_blocks = p.n_blocks;
    f.unit = p.block_bytes % 16 == 0 && kan::ptr_align(p.pool) == 16 &&
                     kan::ptr_align(p.view) == 16
                 ? 16 : e;
    f.part_bytes = kThreads * kUnroll * f.unit;
    const long long n = (p.block_bytes + f.part_bytes - 1) / f.part_bytes;
    if (n > 65535 || layers + p.layers > 65535) return (int)cudaErrorInvalidConfiguration;
    f.parts = (int)n;
    f.first = (int)layers;
    plan[kan::kExtra + d->n] = f.unit;
    unit = f.unit < unit ? f.unit : unit;
    ++d->n;
    layers += p.layers;
    parts = n > parts ? n : parts;
  }
  const long long bl = (long long)B * L;
  if (d->n == 0 || bl == 0) return 0;
  if (bl > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  plan[kan::kGridX] = (int)bl;
  plan[kan::kGridY] = (int)parts;
  plan[kan::kGridZ] = (int)layers;
  plan[kan::kBlockThreads] = kThreads;
  plan[kan::kVecBytes] = unit;
  return 0;
}

}  // namespace

// The launch plan of a call, as the launcher below computes it (the leaves'
// pool and view addresses only decide their copy units).  Returns a
// cudaError_t.
extern "C" int paged_gather_plan(const PagedLeaf* leaves, int n_leaves, int B, int L,
                                 int* plan) {
  Leaves d;
  const int err = plan_leaves(leaves, n_leaves, B, L, &d, plan);
  if (err != 0) kan::plan_clear(plan);
  return err;
}

// n_leaves (1..kMaxLeaves) leaves gathered through one table (B, L) int32,
// in one launch; a leaf with nothing to copy takes no CTA, and a call with
// nothing to copy launches nothing.  Returns a cudaError_t (0 = success).
extern "C" int paged_gather(const PagedLeaf* leaves, int n_leaves, const void* table, int B,
                            int L, void* stream) {
  Leaves d;
  int plan[kan::kPlanInts];
  const int err = plan_leaves(leaves, n_leaves, B, L, &d, plan);
  if (err != 0 || plan[kan::kGridX] == 0) return err;
  const int* tbl = static_cast<const int*>(table);
  void* args[] = {&d, &tbl};
  static int granted[64] = {};       // never raised: no dynamic shared memory
  return kan::launch_planned((const void*)paged_gather_kernel, plan, args,
                             static_cast<cudaStream_t>(stream), granted);
}
