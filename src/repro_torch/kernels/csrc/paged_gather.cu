// Block-table gather for the paged KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_gather.py (_gather_kernel,
// launched by gather_blocks_pallas): the logical contiguous view of a paged
// cache,
//
//     view[layer, b, l*bs + o, ...] = pool[layer, table[b, l], o, ...],
//
// pure data movement with no arithmetic on the values.  On the TPU the block
// table rides in scalar-prefetch memory and each grid step is one DMA; here
// each CUDA block loads its own table entry and copies one logical block.
//
// Design, ONE launch for every layer of a stacked pool:
//   * one CUDA block copies one logical block (layer, b, l): bs*KV*D
//     contiguous elements of the pool to bs*KV*D contiguous elements of the
//     view.  The grid is layers x B x L blocks, flattened;
//   * the copy treats the block as raw bytes in units of 16 bytes (uint4)
//     when the block's byte size and both base addresses are 16-byte
//     aligned (every fp32 and bf16 cache with KV*D a multiple of 8), else one
//     element at a time (4, 2 or 1 bytes), so one kernel serves fp32, bf16
//     and int8 pools;
//   * threads stride along the block, so neighbouring threads move
//     neighbouring 16-byte words: every load and store is coalesced;
//   * table ids are clipped to [0, n_blocks - 1] (jnp.take's mode="clip",
//     which the JAX package's plain version documents); the serving engine
//     never emits an id outside the pool (its tables are sentinel-filled).
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() after the launch.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes of every distinct physical
// block the table names, read once, plus the view, written once.  The
// kanformer-100m shadow view of 8 layers x 8 slots x 192 positions x 8 KV
// heads x 64 fp32 (25.2 MB written, at most 25.4 MB read) is about 15 us.
// What is not done yet: TMA bulk copies (cp.async.bulk) of whole blocks.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_gather_kernel(const T* __restrict__ pool, const int* __restrict__ table,
                    T* __restrict__ view, int n_blocks, int B, int L,
                    long long units_per_block) {
  const long long g = blockIdx.x;              // (layer, b, l) flattened
  const int l = (int)(g % L);
  const long long lb = g / L;
  const int b = (int)(lb % B);
  const long long layer = lb / B;
  int id = table[(long long)b * L + l];
  id = id < 0 ? 0 : (id >= n_blocks ? n_blocks - 1 : id);
  const T* src = pool + (layer * n_blocks + id) * units_per_block;
  T* dst = view + g * units_per_block;
  for (long long i = threadIdx.x; i < units_per_block; i += kThreads) dst[i] = src[i];
}

template <typename T>
int launch(const void* pool, const int* table, void* view, long long n_grid, int n_blocks,
           int B, int L, long long units, cudaStream_t stream) {
  paged_gather_kernel<T><<<(unsigned)n_grid, kThreads, 0, stream>>>(
      static_cast<const T*>(pool), table, static_cast<T*>(view), n_blocks, B, L, units);
  return (int)cudaGetLastError();
}

}  // namespace

// pool: (layers, n_blocks, block_bytes) bytes, contiguous; table: (B, L)
// int32; view: (layers, B, L, block_bytes) bytes.  elem_bytes is the
// element size (1, 2 or 4), used when 16-byte units do not fit.  Returns a
// cudaError_t (0 = success); a launch with nothing to copy is a no-op.
extern "C" int paged_gather(const void* pool, const void* table, void* view, int layers,
                            int n_blocks, int B, int L, long long block_bytes, int elem_bytes,
                            void* stream) {
  if (layers < 0 || n_blocks < 1 || B < 0 || L < 0 || block_bytes < 0 ||
      (elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4) || block_bytes % elem_bytes)
    return (int)cudaErrorInvalidValue;
  const long long n_grid = (long long)layers * B * L;
  if (n_grid == 0 || block_bytes == 0) return 0;
  if (n_grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(table);
  const bool vec16 = block_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(pool) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(view) % 16 == 0;
  if (vec16)
    return launch<uint4>(pool, tbl, view, n_grid, n_blocks, B, L, block_bytes / 16, s);
  if (elem_bytes == 4)
    return launch<uint32_t>(pool, tbl, view, n_grid, n_blocks, B, L, block_bytes / 4, s);
  if (elem_bytes == 2)
    return launch<uint16_t>(pool, tbl, view, n_grid, n_blocks, B, L, block_bytes / 2, s);
  return launch<uint8_t>(pool, tbl, view, n_grid, n_blocks, B, L, block_bytes, s);
}
