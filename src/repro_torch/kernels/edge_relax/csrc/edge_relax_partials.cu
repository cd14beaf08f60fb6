// edge_relax_partials for Hopper (sm_90a): one round of frontier-compacted,
// windowed scatter-min over all of a shard's slabs, with min-source-id
// winners and the round's traversal counters.
//
// Replaces the Pallas TPU kernel `edge_relax_partials` (src/repro/kernels/
// edge_relax/edge_relax.py:522, body `_partials_kernel` at :497, tile pass
// `_tile_pass` at :273), its ALT variant (:497-514, the cut at :324-327)
// included.  It computes what that kernel computes, not how: no [nt x nt]
// compaction plane and no [tile_e x block_v] compare plane.  It keeps edge_relax.cu's design: one
// 64-bit atomicMin per in-window candidate on the packed key
// (edge_relax_common.cuh), which is deterministic in any thread order.
//
// Two id spaces: `src` indexes the shard's local source range
// [0, n_src) (`dist_src`, `paths_src`, `parent_src`); `dst` indexes the
// global destination range [0, n_out).  Winners are shard-local source ids;
// the caller lifts them by the shard's first global id.
//
// Launch sequence (one call of edge_relax_partials_launch, on one stream):
//   0. cudaMemsetAsync zeroes the int32[4] counters
//      (n_trav, n_relax, n_tiles, n_pruned); counts[2] doubles as the
//      schedule's append counter, so it ends as the active-tile count.
//   1. flag_tiles: prefill the keys; schedule each tile with a path source
//      and a finite weight, or a forced first tile.
//   2. relax_partials_tiles: one block per tile of the static count; a block
//      at or above the scheduled count exits at once, the others walk one
//      scheduled tile, atomicMin each in-window candidate, and count n_trav
//      (in-window slots) and n_relax (those whose dst is not the source's
//      parent).  Each block reduces its counts (warp shuffles, then shared
//      memory) and adds them with one atomicAdd each.
//   3. unpack: keys -> (val f32, win i32).
//
// The ALT branch is the template flag kAlt of relax_partials_tiles, chosen
// by the launcher from a non-null `alt_lb`: an in-window candidate c to
// destination d enters the atomicMin only if
// __fadd_rn(c, alt_lb[d]) <= *prune_bound, whatever its parent.  A cut
// candidate whose dst is not the source's parent counts in n_pruned (a
// third per-thread counter, reduced with the other two) instead of n_relax,
// so n_relax without the cut is n_relax + n_pruned with it; n_trav stays
// the in-window count.  The prune bound is a device scalar read once per
// block, so the caller needs no host read.  Without ALT the kAlt = false
// instantiation is the kernel as it was before the branch existed, and
// n_pruned stays 0.
//
// Bound on this card: bytes.  The function must read `src` of every slot
// (4 B) and `tile_first` (1 B a tile) to find the active tiles, `dst` and
// `w` of the scheduled slots (8 B), `paths_src` of every source (1 B),
// `dist_src` of each source with a path and a real edge (4 B),
// `parent_src` of each source with an in-window candidate (4 B), and write
// `val` and `win` once (8 B per destination) and the counters; with ALT
// also 4 B of `alt_lb` per distinct in-window destination; over
// 3.35 TB/s.  The keys are scratch and not counted.  Operations (a compare
// and an add per slot) bound far below.  As in edge_relax.cu, the atomics on hub destinations of Kronecker
// graphs are the expected contention point.
#include "edge_relax_common.cuh"

namespace {

constexpr int kMaxWarps = 8;   // tile_threads() gives at most 256 threads

template <bool kAlt>
__global__ void relax_partials_tiles(const float* __restrict__ dist,
                                     const uint8_t* __restrict__ paths,
                                     const int32_t* __restrict__ parent,
                                     const int32_t* __restrict__ src,
                                     const int32_t* __restrict__ dst,
                                     const float* __restrict__ w,
                                     const float* __restrict__ lb_p,
                                     const float* __restrict__ ub_p,
                                     const float* __restrict__ alt_lb,
                                     const float* __restrict__ bound_p,
                                     const int32_t* __restrict__ sched,
                                     const int32_t* __restrict__ sched_n,
                                     int tile_e,
                                     unsigned long long* __restrict__ keys,
                                     int32_t* counts) {   // aliases sched_n
  // uniform across the block: every thread returns or none does
  if ((int32_t)blockIdx.x >= *sched_n) return;
  const float lb = *lb_p, ub = *ub_p;
  const float bound = kAlt ? *bound_p : 0.0f;
  const int64_t base = (int64_t)sched[blockIdx.x] * tile_e;
  int trav = 0, rlx = 0, prn = 0;
  for (int i = threadIdx.x; i < tile_e; i += blockDim.x) {
    const int64_t e = base + i;
    const int32_t s = src[e];
    if (!paths[s]) continue;
    const float c = __fadd_rn(dist[s], w[e]);
    if (c >= lb && c < ub) {
      const int32_t d = dst[e];
      const bool notpar = d != parent[s];
      trav += 1;
      if (!kAlt || __fadd_rn(c, alt_lb[d]) <= bound) {
        rlx += notpar;
        atomicMin(&keys[d], pack_key(c, s));
      } else {
        prn += notpar;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    trav += __shfl_down_sync(0xFFFFFFFFu, trav, off);
    rlx += __shfl_down_sync(0xFFFFFFFFu, rlx, off);
    if (kAlt) prn += __shfl_down_sync(0xFFFFFFFFu, prn, off);
  }
  __shared__ int part[3][kMaxWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part[0][warp] = trav;
    part[1][warp] = rlx;
    part[2][warp] = prn;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0, r = 0, p = 0;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
      t += part[0][k];
      r += part[1][k];
      p += part[2][k];
    }
    if (t) atomicAdd(&counts[0], t);
    if (r) atomicAdd(&counts[1], r);
    if (p) atomicAdd(&counts[3], p);
  }
}

}  // namespace

// Returns the cudaError_t of the first call that failed, else 0.
// `alt_lb` [n_out] and `prune_bound` (a device scalar) are both null
// without ALT.
extern "C" int edge_relax_partials_launch(
    const float* dist_src, const uint8_t* paths_src,
    const int32_t* parent_src, const int32_t* src, const int32_t* dst,
    const float* w, const uint8_t* tile_first, const float* lb,
    const float* ub, const float* alt_lb, const float* prune_bound,
    int64_t n_tiles, int tile_e, int64_t n_out,
    int32_t* sched, unsigned long long* keys, float* val, int32_t* win,
    int32_t* counts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, 4 * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  int32_t* sched_n = counts + 2;
  const int threads = tile_threads(tile_e);
  flag_tiles<<<flag_blocks(n_tiles, n_out, threads), threads, 0, st>>>(
      paths_src, src, w, tile_first, n_tiles, tile_e, sched, sched_n, keys,
      n_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (alt_lb != nullptr)
    relax_partials_tiles<true><<<(unsigned int)n_tiles, threads, 0, st>>>(
        dist_src, paths_src, parent_src, src, dst, w, lb, ub, alt_lb,
        prune_bound, sched, sched_n, tile_e, keys, counts);
  else
    relax_partials_tiles<false><<<(unsigned int)n_tiles, threads, 0, st>>>(
        dist_src, paths_src, parent_src, src, dst, w, lb, ub, nullptr,
        nullptr, sched, sched_n, tile_e, keys, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  unpack<<<(unsigned int)((n_out + 255) / 256), 256, 0, st>>>(keys, n_out,
                                                             val, win);
  return (int)cudaGetLastError();
}
