// edge_relax_fused for Hopper (sm_90a): up to `fused_rounds` rounds of
// frontier-compacted, windowed relaxation in one persistent cooperative
// kernel, with dist/parent/frontier and the round counters kept on the
// device between rounds.
//
// Replaces the Pallas TPU kernel `edge_relax_fused` (src/repro/kernels/
// edge_relax/edge_relax.py:431, body `_fused_kernel` at :360, tile pass
// `_tile_pass` at :273).  It computes that kernel's function, not its
// layout: the TPU version held the whole state in VMEM on a grid of one
// step and built a [NT x NT] compaction plane and a [TILE_E x BLOCK_V]
// compare plane, because it has no scatter.  Here every in-window
// candidate does one 64-bit atomicMin on the key
//
//   key = (float bits of dist[src] + w) << 32 | global source id
//
// exactly as edge_relax.cu does, so the minimum key is (min value, min
// source id on a tie) in any thread order.
//
// One launch (cudaLaunchCooperativeKernel) runs the rounds.  The grid is
// the co-resident maximum (the occupancy query at kThreads threads and no
// dynamic shared memory, times the SM count), or fewer blocks when the
// vertices and tiles need fewer, so that grid.sync() cannot deadlock.
// Each round r < max_r, all blocks in grid-stride loops:
//   1. prefill the keys to (+inf, INT_MAX) and note any(front); flag each
//      tile that holds an edge with paths[src] and a finite w, or is a
//      forced first tile, and append it to `sched` with an atomic counter.
//      paths[s] = front[s] && (dist[s] <= 0 || deg[s] > 1) is evaluated
//      inline from the resident state.                        grid.sync()
//   2. walk the scheduled tiles: atomicMin per in-window candidate; count
//      n_trav (in window) and n_relax (in window, dst != parent[src]),
//      reduced per block, one atomicAdd per block.            grid.sync()
//   3. commit over n_out: improved = val < dist[v]; where improved write
//      dist and parent (the winner); write front = improved everywhere;
//      count n_updates and n_extended (improved with deg > 1); flag any
//      improvement.                                           grid.sync()
//   4. every block reads the same flag from global memory after that
//      barrier and takes the same decision:
//      go = any_improved && r + 1 < max_r.
// max_r = (lb <= 0) ? 1 : fused_rounds is taken from the device scalar
// lb, so the call needs no host read.
//
// The ALT branch (edge_relax.py:360-406, operands :456-476) is the
// template flag kAlt, chosen by the launcher from a non-null `alt_lb`.  At
// the top of every round, after the barrier that ended the previous one,
// every block recomputes the prune bound
//   bound = fminf(prune_ub, __fmul_rn(__ldcg(&dist[tgt]), infl))
// from the resident dist, the bound the unfused path takes between calls
// (torch.minimum of the same f32 product), so a target that improves in
// round r tightens the cut in round r + 1 exactly as there.  In phase 2 an
// in-window candidate c to d is kept only if __fadd_rn(c, alt_lb[d]) <=
// bound; a cut candidate with d != parent[src] counts into
// counts[kPruned] (block-reduced like n_trav and n_relax) and n_relax
// counts only the kept ones, so n_relax without ALT equals n_relax +
// n_pruned with it, round by round, as on the unfused path.
//
// Hazards and what the code does about them:
// - dist/parent/front are written inside the kernel, so they are neither
//   const __restrict__ nor read through __ldg; every read of them, of the
//   keys, the schedule and the per-round scalars is __ldcg (L2, never a
//   stale L1 line).  src/dst/w/tile_first/deg are read-only.
// - The per-round scalars (sched_n, any_front, any_improved) are reset
//   only after a barrier that follows their last read; see
//   `RoundScalars` below.  counts[] slots n_rounds/n_tiles/n_exec are
//   written by block 0's thread 0 alone; the others by atomicAdd.
// - The first round reads the input tensors and copies every vertex's
//   dist and parent into the fresh outputs; later rounds read the outputs
//   and write dist and parent in place only where a vertex improves (each
//   vertex by the thread that owns it in the commit).
// - Padded vertices carry dist = +inf, front = 0, deg = 0 and are never
//   a destination, so they never improve.
//
// Bound on this card: bytes.  Per executed round: 4 B of src per slot of
// the slab and 1 B of tile_first per tile (the flag pass), 8 B of dst and
// w per scheduled slot, and 26 B per vertex: the key written and read
// back (16), dist read (4), front read and written (2), deg (4); with ALT
// 4 B of alt_lb per distinct destination of the round's in-window
// candidates.  Once per call, 12 B per vertex:
// dist written, parent read and written.
// Summed over the rounds the call executes, at 3.35 TB/s.  Arithmetic is
// a few operations per slot.  The hub atomics of Kronecker graphs, the
// writes of improved vertices and the three grid barriers per round are
// the expected costs above that bound.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kEmptyKey =
    (0x7F800000ull << 32) | 0x7FFFFFFFull;   // (+inf, INT_MAX)

// counts[]: FUSED_COUNTERS of kernels/edge_relax/ref.py
enum { kTrav, kRelax, kUpdates, kExtended, kRounds, kTiles, kExec, kPruned };

// RoundScalars: the int32 scratch scal[3], zeroed before the launch.
//   kSchedN      atomicAdd in phase 1; read by every block in phase 2;
//                reset by block 0 in phase 3.
//   kAnyFront    set in phase 1; read and reset by block 0 in phase 2.
//   kAnyImproved set in phase 3; read by every block after the phase-3
//                barrier; reset by block 0 in phase 2 of the next round,
//                which every block reaches only after that read.
enum { kSchedN, kAnyFront, kAnyImproved };

__device__ __forceinline__ bool on_path(const uint8_t* front,
                                        const float* dist,
                                        const int32_t* __restrict__ deg,
                                        int32_t s) {
  return __ldcg(front + s) &&
         (__ldcg(dist + s) <= 0.0f || __ldg(deg + s) > 1);
}

// Sum of v over the block, valid in thread 0.
__device__ __forceinline__ int block_sum(int v, int* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();                      // smem is free again
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads / 32; ++i) total += smem[i];
  return total;
}

template <bool kAlt>
__global__ void __launch_bounds__(kThreads) fused_rounds_kernel(
    const float* dist_in, const int32_t* parent_in, const uint8_t* front_in,
    const int32_t* __restrict__ deg, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst, const float* __restrict__ w,
    const uint8_t* __restrict__ tile_first, const float* __restrict__ lb_p,
    const float* __restrict__ ub_p, const float* __restrict__ alt_lb,
    const float* __restrict__ prune_ub_p, const float* __restrict__ infl_p,
    const int32_t* __restrict__ tgt_p, int64_t n_tiles, int tile_e,
    int64_t n_out, int fused_rounds, float* dist_out, int32_t* parent_out,
    uint8_t* front_out, int32_t* counts, unsigned long long* keys,
    int32_t* sched, int32_t* scal) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int smem[kThreads / 32];
  const float lb = *lb_p, ub = *ub_p;
  const int max_r = lb <= 0.0f ? 1 : fused_rounds;
  const float prune_ub = kAlt ? *prune_ub_p : 0.0f;
  const float infl = kAlt ? *infl_p : 0.0f;
  const int32_t tgt = kAlt ? *tgt_p : 0;
  const int64_t gtid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * kThreads;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;

  for (int r = 0;; ++r) {
    const float* dist = r == 0 ? dist_in : dist_out;
    const int32_t* parent = r == 0 ? parent_in : parent_out;
    const uint8_t* front = r == 0 ? front_in : front_out;
    const float bound =
        kAlt ? fminf(prune_ub, __fmul_rn(__ldcg(dist + tgt), infl)) : 0.0f;

    // 1. prefill, any(front), schedule
    int any_front = 0;
    for (int64_t v = gtid; v < n_out; v += gstride) {
      keys[v] = kEmptyKey;
      any_front |= __ldcg(front + v);
    }
    if (__syncthreads_or(any_front) && threadIdx.x == 0)
      atomicOr(&scal[kAnyFront], 1);
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int64_t base = t * tile_e;
      int hit = threadIdx.x == 0 && tile_first[t];
      for (int i = threadIdx.x; i < tile_e && !hit; i += kThreads) {
        const int64_t e = base + i;
        hit = isfinite(w[e]) && on_path(front, dist, deg, src[e]);
      }
      if (__syncthreads_or(hit) && threadIdx.x == 0)
        sched[atomicAdd(&scal[kSchedN], 1)] = (int32_t)t;
    }
    grid.sync();

    // 2. scatter-min over the scheduled tiles
    const int n_sched = __ldcg(&scal[kSchedN]);
    if (leader) {
      counts[kRounds] += __ldcg(&scal[kAnyFront]);
      counts[kTiles] += n_sched;
      counts[kExec] += 1;
      scal[kAnyFront] = 0;
      scal[kAnyImproved] = 0;
    }
    int trav = 0, rlx = 0, prn = 0;
    for (int64_t k = blockIdx.x; k < n_sched; k += gridDim.x) {
      const int64_t base = (int64_t)__ldcg(sched + k) * tile_e;
      for (int i = threadIdx.x; i < tile_e; i += kThreads) {
        const int64_t e = base + i;
        const int32_t s = src[e];
        if (!on_path(front, dist, deg, s)) continue;
        const float c = __fadd_rn(__ldcg(dist + s), w[e]);
        if (c >= lb && c < ub) {
          const int32_t d = dst[e];
          const bool notpar = d != __ldcg(parent + s);
          ++trav;
          if (kAlt && !(__fadd_rn(c, alt_lb[d]) <= bound)) {
            prn += notpar;
            continue;
          }
          rlx += notpar;
          atomicMin(&keys[d], ((unsigned long long)__float_as_uint(c) << 32) |
                                  (unsigned int)s);
        }
      }
    }
    trav = block_sum(trav, smem);
    rlx = block_sum(rlx, smem);
    if (kAlt) prn = block_sum(prn, smem);
    if (threadIdx.x == 0 && trav) {
      atomicAdd(&counts[kTrav], trav);
      atomicAdd(&counts[kRelax], rlx);
      if (kAlt) atomicAdd(&counts[kPruned], prn);
    }
    grid.sync();

    // 3. commit
    if (leader) scal[kSchedN] = 0;
    int upd = 0, ext = 0;
    for (int64_t v = gtid; v < n_out; v += gstride) {
      const unsigned long long key = __ldcg(keys + v);
      const float val = __uint_as_float((unsigned int)(key >> 32));
      const float d = __ldcg(dist + v);
      const bool imp = val < d;
      if (imp) {
        dist_out[v] = val;
        parent_out[v] = (int32_t)(key & 0xFFFFFFFFull);
      } else if (r == 0) {             // fill the fresh outputs once
        dist_out[v] = d;
        parent_out[v] = __ldcg(parent + v);
      }
      front_out[v] = imp;
      upd += imp;
      ext += imp && deg[v] > 1;
    }
    upd = block_sum(upd, smem);
    ext = block_sum(ext, smem);
    if (threadIdx.x == 0 && upd) {
      atomicAdd(&counts[kUpdates], upd);
      atomicAdd(&counts[kExtended], ext);
      atomicOr(&scal[kAnyImproved], 1);
    }
    grid.sync();

    // 4. the same decision in every block
    if (!(__ldcg(&scal[kAnyImproved]) && r + 1 < max_r)) break;
  }
}

}  // namespace

// cudaGetErrorName of a code that edge_relax_fused_launch returned.
extern "C" const char* edge_relax_fused_error_name(int code) {
  if (code == -1) return "no cooperative launch on this device";
  return cudaGetErrorName((cudaError_t)code);
}

// Returns 0, -1 when the device has no cooperative launch, else the
// cudaError_t of the step that failed.  `alt_lb` [n_out], `prune_ub`,
// `infl` and `tgt` (device scalars) are all null without ALT.
extern "C" int edge_relax_fused_launch(
    const float* dist_in, const int32_t* parent_in, const uint8_t* front_in,
    const int32_t* deg, const int32_t* src, const int32_t* dst,
    const float* w, const uint8_t* tile_first, const float* lb_p,
    const float* ub_p, const float* alt_lb, const float* prune_ub_p,
    const float* infl_p, const int32_t* tgt_p, int64_t n_tiles, int tile_e,
    int64_t n_out, int fused_rounds, float* dist_out, int32_t* parent_out,
    uint8_t* front_out, int32_t* counts, unsigned long long* keys,
    int32_t* sched, int32_t* scal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const void* kernel = alt_lb != nullptr
                           ? (const void*)fused_rounds_kernel<true>
                           : (const void*)fused_rounds_kernel<false>;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return (int)err;
  if (!coop) return -1;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, 0)) != cudaSuccess)
    return (int)err;
  // co-resident maximum, no more blocks than there is work for
  const int64_t resident = (int64_t)per_sm * sms;
  int64_t want = (n_out + kThreads - 1) / kThreads;
  if (n_tiles > want) want = n_tiles;
  const int blocks = (int)(want < resident ? want : resident);
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaMemsetAsync(counts, 0, 8 * sizeof(int32_t), st)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(scal, 0, 3 * sizeof(int32_t), st)) !=
      cudaSuccess)
    return (int)err;
  void* args[] = {&dist_in,  &parent_in,  &front_in,  &deg,
                  &src,      &dst,        &w,         &tile_first,
                  &lb_p,     &ub_p,       &alt_lb,    &prune_ub_p,
                  &infl_p,   &tgt_p,      &n_tiles,   &tile_e,
                  &n_out,    &fused_rounds, &dist_out, &parent_out,
                  &front_out, &counts,    &keys,      &sched,
                  &scal};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                    args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
