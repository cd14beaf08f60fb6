// Device and host code shared by edge_relax.cu and edge_relax_fused.cu:
// the packed (value, source id) key of the scatter-min, the tile schedule
// read from the layout's vertex->tile index (core/graph.py::TileIndex),
// and the query for the blocks a card holds at once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kEmptyKey =
    (0x7F800000ull << 32) | 0x7FFFFFFFull;   // (+inf, INT_MAX)
constexpr int kMaxWarps = 8;                 // blocks of at most 256 threads
constexpr int kWarpTiles = 8;                // more tiles: the warp walks
constexpr unsigned kFull = 0xFFFFFFFFu;

// Candidates are non-negative, so the float bits order like the value and
// the minimum key is (min value, min source id on a tie).
__device__ __forceinline__ unsigned long long pack_key(float c, int32_t s) {
  return ((unsigned long long)__float_as_uint(c) << 32) | (unsigned int)s;
}

__device__ __forceinline__ float key_val(unsigned long long k) {
  return __uint_as_float((unsigned int)(k >> 32));
}

__device__ __forceinline__ int32_t key_win(unsigned long long k) {
  return (int32_t)(k & 0xFFFFFFFFull);
}

// Schedule tile t unless this call (or round) has scheduled it already.
// The plain read (bypassing L1) skips the atomic for a tile already set.
__device__ __forceinline__ void schedule_tile(int32_t t,
                                              unsigned int* flags,
                                              int32_t* sched,
                                              int32_t* sched_n) {
  if (__ldcg(&flags[t]) == 0u && atomicExch(&flags[t], 1u) == 0u)
    sched[atomicAdd(sched_n, 1)] = t;
}

// Call f(t) for the tiles t = vt_tile[lo, hi) of each lane's index entry
// (lo == hi for a lane with nothing to schedule), leaving out every tile
// whose `skip` byte is set when `skip` is not null.  An entry of more than
// kWarpTiles tiles (a Kronecker hub) is walked by the whole warp.  All 32
// lanes of the warp must call it together.
template <typename F>
__device__ __forceinline__ void for_entry_tiles(
    int32_t lo, int32_t hi, const int32_t* __restrict__ vt_tile,
    const uint8_t* __restrict__ skip, F&& f) {
  const int lane = threadIdx.x & 31;
  const bool wide = hi - lo > kWarpTiles;
  if (!wide)
    for (int32_t k = lo; k < hi; ++k) {
      const int32_t t = vt_tile[k];
      if (skip == nullptr || !skip[t]) f(t);
    }
  for (unsigned todo = __ballot_sync(kFull, wide); todo; todo &= todo - 1) {
    const int owner = __ffs(todo) - 1;
    const int32_t wlo = __shfl_sync(kFull, lo, owner);
    const int32_t whi = __shfl_sync(kFull, hi, owner);
    for (int32_t k = wlo + lane; k < whi; k += 32) {
      const int32_t t = vt_tile[k];
      if (skip == nullptr || !skip[t]) f(t);
    }
  }
}

// Schedule the tiles of each lane's index entry (for_entry_tiles) in a
// one-state call's flags.
__device__ __forceinline__ void schedule_entries(
    int32_t lo, int32_t hi, const int32_t* __restrict__ vt_tile,
    const uint8_t* __restrict__ skip, unsigned int* flags, int32_t* sched,
    int32_t* sched_n) {
  for_entry_tiles(lo, hi, vt_tile, skip, [&](int32_t t) {
    schedule_tile(t, flags, sched, sched_n);
  });
}

// Blocks the card holds at once for `kernel` at `threads` (a multiple of
// 32, at most 256) a block; 0 if the query failed or no block fits (see
// no_blocks).  Asked once per kernel and block size (the process's cards
// are taken to be alike).
template <auto kKernel>
int resident_blocks(int threads) {
  static int known[kMaxWarps + 1] = {};
  int& got = known[threads / 32];
  if (got == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel,
                                                      threads, 0) !=
            cudaSuccess)
      return 0;
    got = sms * per_sm;
  }
  return got;
}

// The error to return when resident_blocks gave 0: the query's own, or
// cudaErrorInvalidConfiguration when the query succeeded and no block fits,
// so that a launcher never reports success having launched nothing.
inline int no_blocks() {
  const cudaError_t err = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
}

}  // namespace
