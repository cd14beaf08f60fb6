// Pieces shared by edge_relax.cu and edge_relax_partials.cu: the packed
// (value, source id) key, the frontier-compaction pass and the unpack.
//
//   key = (float bits of dist[src] + w) << 32 | source id
//
// Candidates are non-negative (dist >= 0, w > 0), so the float bits order
// like the value and the minimum key is exactly (min value, min source id
// on a tie), whatever order the threads run in.  Keys start at
// (bits(+inf), INT_MAX), the value for a destination with no candidate.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kEmptyKey =
    (0x7F800000ull << 32) | 0x7FFFFFFFull;   // (+inf, INT_MAX)

__device__ __forceinline__ unsigned long long pack_key(float c, int32_t s) {
  return ((unsigned long long)__float_as_uint(c) << 32) | (unsigned int)s;
}

// Prefill the keys; flag each tile that holds an edge with a path source
// and a finite weight, or is a forced first tile, and append it to `sched`
// (order is free: the min is order-independent).  `sched_n` ends as the
// active-tile count, on the device; the caller zeroes it on the stream.
__global__ void flag_tiles(const uint8_t* __restrict__ paths,
                           const int32_t* __restrict__ src,
                           const float* __restrict__ w,
                           const uint8_t* __restrict__ tile_first,
                           int64_t n_tiles, int tile_e,
                           int32_t* __restrict__ sched,
                           int32_t* __restrict__ sched_n,
                           unsigned long long* __restrict__ keys,
                           int64_t n_out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n_out;
       j += stride)
    keys[j] = kEmptyKey;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t base = t * tile_e;
    int hit = threadIdx.x == 0 && tile_first[t];
    for (int i = threadIdx.x; i < tile_e && !hit; i += blockDim.x) {
      const int64_t e = base + i;
      hit = paths[src[e]] && isfinite(w[e]);
    }
    if (__syncthreads_or(hit) && threadIdx.x == 0)
      sched[atomicAdd(sched_n, 1)] = (int32_t)t;
  }
}

__global__ void unpack(const unsigned long long* __restrict__ keys,
                       int64_t n_out, float* __restrict__ vals,
                       int32_t* __restrict__ wins) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_out) return;
  const unsigned long long k = keys[j];
  vals[j] = __uint_as_float((unsigned int)(k >> 32));
  wins[j] = (int32_t)(k & 0xFFFFFFFFull);
}

// Threads per block for a tile of `tile_e` slots, and blocks for the flag
// pass (enough to cover both the tiles and the keys, at most 32 per SM).
inline int tile_threads(int tile_e) {
  return tile_e >= 256 ? 256 : ((tile_e + 31) / 32) * 32;
}

inline int flag_blocks(int64_t n_tiles, int64_t n_out, int threads) {
  const int64_t key_blocks = (n_out + threads - 1) / threads;
  const int64_t want = n_tiles > key_blocks ? n_tiles : key_blocks;
  return (int)(want < 132 * 32 ? want : 132 * 32);
}

}  // namespace
