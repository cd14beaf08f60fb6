// edge_relax and edge_relax_partials for Hopper (sm_90a): one round of
// frontier-driven, windowed scatter-min with deterministic min-source-id
// winners and the round's traversal counters.
//
// Replaces two Pallas TPU kernels that compute the same round in two id
// spaces:
//   * `edge_relax` (src/repro/kernels/edge_relax/edge_relax.py:188, body
//     `_kernel` at :130, jnp prepass `schedule_tiles` at :98, ALT at
//     :158-164), one device's slabs with global source ids, whose
//     counters the reference takes in a jnp pass over every slot;
//   * `edge_relax_partials` (:522, body `_partials_kernel` at :497, ALT at
//     :497-514 with the cut in `_tile_pass` at :324-327), a shard's slabs
//     with shard-local source ids and the counters in the kernel.
// Both launchers below run the same three kernels.  `src` indexes
// [0, n_src) (`dist`, `paths`, `parent`); `dst` indexes [0, n_out).
// It computes what those kernels compute, not how: the TPU has no
// scatter, so it built a [tile_e x block_v] broadcast-compare plane per
// tile.  Here each in-window candidate does one 64-bit atomicMin into a
// key per destination:
//
//   key = (float bits of dist[src] + w) << 32 | source id
//
// Candidates are non-negative (dist >= 0, w > 0), so the float bits order
// like the value and the minimum key is exactly (min value, min source id
// on a tie), whatever order the threads run in.  A destination with no
// candidate keeps (bits(+inf), INT_MAX).
//
// Scratch, owned by the wrapper (ops.py) and kept between calls: `flags`
// (one word per tile, then the schedule's append counter; all 0 between
// calls), `sched` (one slot per tile) and `keys` (one per destination,
// kEmptyKey between calls).  A call leaves flags and keys as it found
// them, so no pass over NT or n_out prefills anything.
//
// Launch sequence (one call, all on one stream, three kernels):
//   1. schedule_frontier: zeroes the int32[4] counters (n_trav, n_relax,
//      n_tiles, n_pruned), then schedules the forced (tile_first) tiles
//      and, for each source with a path (`paths` read once, 1 B a
//      source), the tiles of its vertex->tile index entry (`vt_ptr`, `vt_tile`: the tiles that
//      hold a finite-weight slot of it).  Each tile is test-and-set in
//      `flags` and appended to `sched` when its flag flips, so it is
//      scheduled exactly once: the set is `schedule_tiles`' set (in
//      another order; the min is order-independent).  A source with more
//      than kWarpTiles tiles (a Kronecker hub) is walked by its whole
//      warp.  No slot is read to schedule a tile.
//   2. relax_tiles: a persistent grid (the blocks the card holds at once,
//      not one per tile) strides over the scheduled tiles (block 0 copies
//      their count into counts[2]); a block clears its tile's flag,
//      atomicMins each in-window candidate, and counts n_trav (in-window
//      slots), n_relax (those whose dst is not the source's parent and
//      that survive the ALT cut) and n_pruned (those the cut drops); warp
//      shuffles, then one atomicAdd per block.
//   3. unpack: keys -> (vals f32, wins i32), two destinations a thread,
//      resetting each key it finds touched and the append counter.
//
// The key, the index walk and the resident-grid query live in
// schedule.cuh, which edge_relax_fused.cu shares.
//
// Slots (edge_relax_batch_launch): S states relaxed over one shared slab
// and index in one launch of each kernel, as vmap of the TPU kernel adds
// a batch grid axis.  `dist`, `paths` and `parent` are [S, n_src], `lb`,
// `ub` and `prune_bound` [S], `alt_lb`, `vals` and `wins` [S, n_out],
// `counts` [S, 4], and the scratch holds a row per slot (`flags`
// [S, n_tiles + 1], `sched` [S, n_tiles], `keys` [S, n_out]).  gridDim.y
// runs over the int32 list `active` of the slots to relax; a slot not in
// it is not read and its rows of `vals`, `wins` and `counts` are not
// written.  The one-state entry points run the same kernels with no list
// and gridDim.y = 1, which is slot 0.
//
// The ALT branch is the template flag kAlt of relax_tiles, chosen by the
// launcher from a non-null `alt_lb`: an in-window candidate c to
// destination d enters only if __fadd_rn(c, alt_lb[d]) <= *prune_bound
// (the reference's `cand + alt_lb[dst] <= lbub[2]`), so a cut candidate
// never touches the key.  The prune bound is a device scalar, like lb and
// ub, so the caller needs no host read.
//
// Bound on this card: bytes, as relax_tiles reads them.  `paths` of every
// source (1 B), the index entries of the path sources (8 B of vt_ptr, 4 B
// per tile), the forced tiles (4 B each), `src` of every scheduled slot,
// `w` of each such slot whose source has a path and `dst` of each
// in-window candidate (4 B each), the gathers (`dist` of each path source,
// `parent` of each source with an in-window candidate, 4 B each; with ALT
// `alt_lb` of each distinct in-window destination), and `vals` and `wins`
// written once (8 B per destination); over 3.35 TB/s.  The keys and flags
// are scratch.  No arithmetic to speak of.  The atomics on the hub
// destinations of Kronecker graphs are the expected contention point.
#include <cuda_runtime.h>
#include <stdint.h>

#include "schedule.cuh"

namespace {

// The slot this block works on: active[blockIdx.y], or 0 with no list.
__device__ __forceinline__ int64_t block_slot(const int32_t* active) {
  return active == nullptr ? 0 : (int64_t)active[blockIdx.y];
}

__global__ void schedule_frontier(const uint8_t* __restrict__ paths,
                                  int64_t n_src,
                                  const int32_t* __restrict__ vt_ptr,
                                  const int32_t* __restrict__ vt_tile,
                                  const int32_t* __restrict__ forced,
                                  int64_t n_forced, int64_t n_tiles,
                                  const int32_t* __restrict__ active,
                                  unsigned int* __restrict__ flags,
                                  int32_t* __restrict__ sched,
                                  int32_t* __restrict__ counts) {
  const int64_t slot = block_slot(active);
  paths += slot * n_src;
  flags += slot * (n_tiles + 1);
  sched += slot * n_tiles;
  counts += slot * 4;
  int32_t* sched_n = (int32_t*)(flags + n_tiles);   // the append counter
  const int lane = threadIdx.x & 31;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (tid < 4) counts[tid] = 0;
  for (int64_t i = tid; i < n_forced; i += stride)
    schedule_tile(forced[i], flags, sched, sched_n);
  // warp-uniform trip count (stride is a multiple of 32), for the shuffles
  for (int64_t s = tid; s - lane < n_src; s += stride) {
    int32_t lo = 0, hi = 0;
    if (s < n_src && paths[s]) {
      lo = vt_ptr[s];
      hi = vt_ptr[s + 1];
    }
    schedule_entries(lo, hi, vt_tile, nullptr, flags, sched, sched_n);
  }
}

template <bool kAlt>
__global__ void relax_tiles(const float* __restrict__ dist,
                            const uint8_t* __restrict__ paths,
                            const int32_t* __restrict__ parent,
                            const int32_t* __restrict__ src,
                            const int32_t* __restrict__ dst,
                            const float* __restrict__ w,
                            const float* __restrict__ lb_p,
                            const float* __restrict__ ub_p,
                            const float* __restrict__ alt_lb,
                            const float* __restrict__ bound_p,
                            const int32_t* __restrict__ sched, int64_t n_src,
                            int64_t n_tiles, int64_t n_out, int tile_e,
                            const int32_t* __restrict__ active,
                            unsigned int* __restrict__ flags,
                            unsigned long long* __restrict__ keys,
                            int32_t* __restrict__ counts) {
  const int64_t slot = block_slot(active);
  dist += slot * n_src;
  paths += slot * n_src;
  parent += slot * n_src;
  lb_p += slot;
  ub_p += slot;
  if (kAlt) {
    alt_lb += slot * n_out;
    bound_p += slot;
  }
  flags += slot * (n_tiles + 1);
  sched += slot * n_tiles;
  keys += slot * n_out;
  counts += slot * 4;
  const int32_t n_sched = *(const int32_t*)(flags + n_tiles);
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[2] = n_sched;
  // uniform across the block: every thread returns or none does
  if ((int32_t)blockIdx.x >= n_sched) return;
  const float lb = *lb_p, ub = *ub_p;
  const float bound = kAlt ? *bound_p : 0.0f;
  int trav = 0, rlx = 0, prn = 0;
  for (int32_t j = blockIdx.x; j < n_sched; j += gridDim.x) {
    const int32_t t = sched[j];
    if (threadIdx.x == 0) flags[t] = 0u;
    const int64_t base = (int64_t)t * tile_e;
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
  }
  for (int off = 16; off > 0; off >>= 1) {
    trav += __shfl_down_sync(kFull, trav, off);
    rlx += __shfl_down_sync(kFull, rlx, off);
    if (kAlt) prn += __shfl_down_sync(kFull, prn, off);
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

// Destinations 2j and 2j+1 per thread (16-byte key loads; the buffers
// come from the caching allocator, so they are 16-byte aligned, and so is
// every slot's row when n_out is even; an odd n_out takes the scalar path
// past slot 0).
__global__ void unpack(unsigned long long* __restrict__ keys, int64_t n_out,
                       int64_t n_tiles, const int32_t* __restrict__ active,
                       unsigned int* __restrict__ flags,
                       float* __restrict__ vals, int32_t* __restrict__ wins) {
  const int64_t slot = block_slot(active);
  keys += slot * n_out;
  vals += slot * n_out;
  wins += slot * n_out;
  const int64_t j = 2 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (j == 0) flags[slot * (n_tiles + 1) + n_tiles] = 0u;  // append counter
  const bool aligned = slot == 0 || (n_out & 1) == 0;
  if (j + 1 < n_out && aligned) {
    const ulonglong2 k = *reinterpret_cast<const ulonglong2*>(keys + j);
    *reinterpret_cast<float2*>(vals + j) =
        make_float2(key_val(k.x), key_val(k.y));
    *reinterpret_cast<int2*>(wins + j) = make_int2(key_win(k.x),
                                                   key_win(k.y));
    if (k.x != kEmptyKey || k.y != kEmptyKey)
      *reinterpret_cast<ulonglong2*>(keys + j) =
          make_ulonglong2(kEmptyKey, kEmptyKey);
  } else {
    for (int64_t i = j; i < j + 2 && i < n_out; ++i) {
      const unsigned long long k = keys[i];
      vals[i] = key_val(k);
      wins[i] = key_win(k);
      if (k != kEmptyKey) keys[i] = kEmptyKey;
    }
  }
}

// Threads per block for a tile of `tile_e` slots.
inline int tile_threads(int tile_e) {
  return tile_e >= 256 ? 256 : ((tile_e + 31) / 32) * 32;
}

template <typename T>
T cap(int64_t want, int64_t most) {
  return (T)(want < most ? (want > 1 ? want : 1) : most);
}

// A slot's share of a resident grid of `most` blocks (at least one).
inline int64_t share(int64_t most, int64_t n_active) {
  return most / n_active > 1 ? most / n_active : 1;
}

int relax_round(const float* dist, const uint8_t* paths,
                const int32_t* parent, const int32_t* src, const int32_t* dst,
                const float* w, const int32_t* vt_ptr, const int32_t* vt_tile,
                const int32_t* forced, int64_t n_forced, const float* lb,
                const float* ub, const float* alt_lb,
                const float* prune_bound, int64_t n_src, int64_t n_tiles,
                int tile_e, int64_t n_out, const int32_t* active,
                int64_t n_active, unsigned int* flags, int32_t* sched,
                unsigned long long* keys, float* vals, int32_t* wins,
                int32_t* counts, cudaStream_t st) {
  cudaError_t err;
  if (n_active < 1 || n_active > 65535) return (int)cudaErrorInvalidValue;
  const int threads = tile_threads(tile_e);
  const int64_t items = n_src > n_forced ? n_src : n_forced;
  const int sched_blocks = resident_blocks<schedule_frontier>(256);
  if (sched_blocks == 0) return no_blocks();
  // the resident grid is shared among the slots
  const dim3 sched_grid(cap<unsigned>((items + 255) / 256,
                                      share(sched_blocks, n_active)),
                        (unsigned)n_active);
  schedule_frontier<<<sched_grid, 256, 0, st>>>(
      paths, n_src, vt_ptr, vt_tile, forced, n_forced, n_tiles, active,
      flags, sched, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (alt_lb != nullptr) {
    const int most = resident_blocks<relax_tiles<true>>(threads);
    if (most == 0) return no_blocks();
    relax_tiles<true><<<dim3(cap<unsigned>(n_tiles, share(most, n_active)),
                             (unsigned)n_active), threads, 0, st>>>(
        dist, paths, parent, src, dst, w, lb, ub, alt_lb, prune_bound,
        sched, n_src, n_tiles, n_out, tile_e, active, flags, keys, counts);
  } else {
    const int most = resident_blocks<relax_tiles<false>>(threads);
    if (most == 0) return no_blocks();
    relax_tiles<false><<<dim3(cap<unsigned>(n_tiles, share(most, n_active)),
                              (unsigned)n_active), threads, 0, st>>>(
        dist, paths, parent, src, dst, w, lb, ub, nullptr, nullptr, sched,
        n_src, n_tiles, n_out, tile_e, active, flags, keys, counts);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  unpack<<<dim3((unsigned int)((n_out + 511) / 512), (unsigned)n_active),
           256, 0, st>>>(keys, n_out, n_tiles, active, flags, vals, wins);
  return (int)cudaGetLastError();
}

}  // namespace

// The two entry points, one per reference function; each returns the
// cudaError_t of the first call that failed, else 0.  `alt_lb` [n_out]
// and `prune_bound` (a device scalar) are both null without ALT.  `flags`
// ([n_tiles + 1]) must be all 0 and `keys` all kEmptyKey on entry; a call
// that returns 0 leaves them so.
extern "C" int edge_relax_launch(
    const float* dist, const uint8_t* paths, const int32_t* parent,
    const int32_t* src, const int32_t* dst, const float* w,
    const int32_t* vt_ptr, const int32_t* vt_tile, const int32_t* forced,
    int64_t n_forced, const float* lb, const float* ub, const float* alt_lb,
    const float* prune_bound, int64_t n_src, int64_t n_tiles, int tile_e,
    int64_t n_out, unsigned int* flags, int32_t* sched,
    unsigned long long* keys, float* vals, int32_t* wins, int32_t* counts,
    void* stream) {
  return relax_round(dist, paths, parent, src, dst, w, vt_ptr, vt_tile,
                     forced, n_forced, lb, ub, alt_lb, prune_bound, n_src,
                     n_tiles, tile_e, n_out, nullptr, 1, flags, sched, keys,
                     vals, wins, counts, (cudaStream_t)stream);
}

// edge_relax over slots: the states of the `n_active` slots listed in
// `active` (int32, on the device) relaxed in one launch of each kernel
// (shapes in the header comment).  Each slot's scratch row must be clean
// on entry, as for edge_relax_launch; a call that returns 0 leaves it so.
extern "C" int edge_relax_batch_launch(
    const float* dist, const uint8_t* paths, const int32_t* parent,
    const int32_t* src, const int32_t* dst, const float* w,
    const int32_t* vt_ptr, const int32_t* vt_tile, const int32_t* forced,
    int64_t n_forced, const float* lb, const float* ub, const float* alt_lb,
    const float* prune_bound, int64_t n_src, int64_t n_tiles, int tile_e,
    int64_t n_out, const int32_t* active, int64_t n_active,
    unsigned int* flags, int32_t* sched, unsigned long long* keys,
    float* vals, int32_t* wins, int32_t* counts, void* stream) {
  if (active == nullptr) return (int)cudaErrorInvalidValue;
  return relax_round(dist, paths, parent, src, dst, w, vt_ptr, vt_tile,
                     forced, n_forced, lb, ub, alt_lb, prune_bound, n_src,
                     n_tiles, tile_e, n_out, active, n_active, flags, sched,
                     keys, vals, wins, counts, (cudaStream_t)stream);
}

extern "C" int edge_relax_partials_launch(
    const float* dist_src, const uint8_t* paths_src,
    const int32_t* parent_src, const int32_t* src, const int32_t* dst,
    const float* w, const int32_t* vt_ptr, const int32_t* vt_tile,
    const int32_t* forced, int64_t n_forced, const float* lb,
    const float* ub, const float* alt_lb, const float* prune_bound,
    int64_t n_src, int64_t n_tiles, int tile_e, int64_t n_out,
    unsigned int* flags, int32_t* sched, unsigned long long* keys,
    float* val, int32_t* win, int32_t* counts, void* stream) {
  return relax_round(dist_src, paths_src, parent_src, src, dst, w, vt_ptr,
                     vt_tile, forced, n_forced, lb, ub, alt_lb, prune_bound,
                     n_src, n_tiles, tile_e, n_out, nullptr, 1, flags, sched,
                     keys, val, win, counts, (cudaStream_t)stream);
}
