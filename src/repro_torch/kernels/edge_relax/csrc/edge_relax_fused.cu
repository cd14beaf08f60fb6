// edge_relax_fused for Hopper (sm_90a): up to `fused_rounds` rounds of
// windowed relaxation in one persistent cooperative kernel, with dist,
// parent, the frontier and the round counters kept on the device between
// rounds, and each round's work following the frontier, not the graph.
//
// Replaces the Pallas TPU kernel `edge_relax_fused` (src/repro/kernels/
// edge_relax/edge_relax.py:431, body `_fused_kernel` at :360, tile pass
// `_tile_pass` at :273, the ALT branch in both).  It computes that
// kernel's function, not its layout: the TPU version held the whole state
// in VMEM on a grid of one step, rebuilt a compacted schedule from every
// slot and committed over every vertex each round, because it has no
// scatter.  Here every in-window candidate does one 64-bit atomicMin on
//
//   key = (float bits of dist[src] + w) << 32 | global source id
//
// as edge_relax.cu does (schedule.cuh), so the minimum key is (min value,
// min source id on a tie) in any thread order.
//
// Design: after one O(N) pass at the start of a call, a round touches
// only the frontier, its tiles and the destinations it reaches.
//   0. once a call, one grid-stride pass over the vertices: copy dist and
//      parent into the fresh outputs, clear front_out, append each
//      frontier vertex to the list F_0 and, for each with a path
//      (paths[s] = front[s] && (dist[s] <= 0 || deg[s] > 1), evaluated
//      inline), set its mark and schedule the tiles of its vertex->tile
//      index entry (`vt_ptr`, `vt_tile`).                    grid.sync()
//   Round r (p = r & 1), two barriers:
//   1. relax: the forced tiles (`forced`, every round) and the round's
//      scheduled tiles, a block per tile; the block clears a scheduled
//      tile's flag, and each in-window candidate of a marked source
//      atomicMins its destination's key.  The atomicMin that moves a key
//      off kEmptyKey (its return value says so) appends the destination
//      to the touched list, so each is listed once.  n_trav, n_relax,
//      n_pruned are reduced per block, one atomicAdd per block.
//                                                            grid.sync()
//   2. commit over the touched list only (untouched keys hold +inf, which
//      improves nothing): where val < dist write dist and parent, count
//      n_updates and n_extended, append the vertex to F_{r+1} and, if the
//      call runs another round and the vertex has a path, set its mark for
//      round r + 1 and schedule its tiles; reset every touched key to
//      kEmptyKey; clear round r's marks from F_r.            grid.sync()
//   3. every block reads |F_{r+1}| after that barrier and takes the same
//      decision: go = |F_{r+1}| > 0 && r + 1 < max_r.  On the last round,
//      front_out is set from F_{r+1}.
// A tile is scheduled by a test-and-set of its flag (schedule.cuh), so
// each is listed once a round; dynamic scheduling leaves the forced
// (`tile_first`) tiles out, since every round runs them.  n_tiles is then
// |forced| + the scheduled count: schedule_tiles' active set.  n_rounds is
// |F_r| > 0, "the frontier was non-empty".  max_r = (lb <= 0) ? 1 :
// fused_rounds is taken from the device scalar lb, so no host read.
//
// Hazards and what the code does about them:
// - A vertex can be on F_r and improve again in round r.  The marks come
//   in two planes: round r reads plane p and its commit sets plane p ^ 1,
//   while clearing plane p from F_r, which nothing reads in that phase.
//   The frontier lists alternate the same way.  front_out is written only
//   once the last round is known, so it never needs clearing.
// - Every counter of the round scalars (`RoundScalars`) is reset by block
//   0's thread 0 in a phase after its last read and before its next
//   append; the last block to leave resets the rest, so a call leaves the
//   scratch as it found it: keys kEmptyKey, flags, marks and scalars 0.
// - dist_out/parent_out, the marks, lists, keys and scalars are written
//   inside the kernel, so every read of them is __ldcg (L2, never a stale
//   L1 line).  The inputs and the index are read-only.
// - Appends to a list are aggregated over the lanes that append together
//   (one atomicAdd per group), since a round touches up to n_out keys.
// - Padded vertices carry dist = +inf, front = 0, deg = 0 and are never a
//   destination, so they never improve.
//
// ALT (edge_relax.py:360-406, operands :456-476) is the template flag
// kAlt, chosen by the launcher from a non-null `alt_lb`.  At the top of
// every round, after the barrier that ended the previous one, every block
// recomputes bound = fminf(prune_ub, __fmul_rn(dist[tgt], infl)) from the
// resident dist, the bound the unfused path takes between calls; an
// in-window candidate c to d is kept only if __fadd_rn(c, alt_lb[d]) <=
// bound; a cut candidate with d != parent[src] counts into n_pruned and
// touches no key, and n_relax counts only the kept ones.
//
// The grid is fixed by rule, not by the work: the co-resident maximum
// (the occupancy query at kThreads threads, times the SM count), so that
// grid.sync() cannot deadlock.  tools/edge_relax_ablation.py times it
// against one block per SM in a copy of this file.
//
// Bound on this card: bytes.  Per executed round, as the kernel reads:
// 8 B of vt_ptr, 4 B of dist and 5 B per index entry (vt_tile,
// tile_first) of each path source, 4 B per forced tile, `src` of every
// scheduled slot, `w` of each slot of a marked source, `dst` of each
// in-window candidate and `parent` of each source with one (4 B each),
// with ALT `alt_lb` of each distinct in-window destination (4 B), per
// touched destination its key read and reset and its dist read (20 B),
// per improved one dist and parent written, deg read and its list entry
// (16 B).  Once a call, 18 B per vertex (dist, parent and front read and
// written) and 8 B per frontier vertex (deg, its list entry).  Over 3.35
// TB/s (chip_smoke.py::fused_bytes counts it).  Arithmetic is a few
// operations per slot.  Above that: the hub atomics of Kronecker graphs,
// two grid barriers a round and the launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "schedule.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// counts[]: FUSED_COUNTERS of kernels/edge_relax/ref.py
enum { kTrav, kRelax, kUpdates, kExtended, kRounds, kTiles, kExec, kPruned };

// RoundScalars: the int32 scratch scal[kScalars], all 0 between calls.
//   kSchedN + q   tiles scheduled for a round of parity q: appended in the
//                 commit before it (or pass 0), read in its relax, reset
//                 in its commit.
//   kTouchedN + q destinations touched in a round of parity q: appended in
//                 its relax, read in its commit, reset in the next relax.
//   kFrontN + q   the frontier list F_r of parity q: appended in the commit
//                 before (or pass 0), read in round r, reset in round r + 1's
//                 relax.
//   kLeft         blocks that have left; the last one resets the rest.
enum { kSchedN = 0, kTouchedN = 2, kFrontN = 4, kLeft = 6, kScalars = 8 };

struct Args {
  const float* dist_in;
  const int32_t* parent_in;
  const uint8_t* front_in;
  const int32_t* deg;
  const int32_t* src;
  const int32_t* dst;
  const float* w;
  const uint8_t* tile_first;
  const int32_t* vt_ptr;
  const int32_t* vt_tile;
  const int32_t* forced;
  int64_t n_forced;
  const float* lb;
  const float* ub;
  const float* alt_lb;         // null without ALT, as the next three
  const float* prune_ub;
  const float* infl;
  const int32_t* tgt;
  int tile_e;
  int64_t n_out;
  int fused_rounds;
  float* dist_out;
  int32_t* parent_out;
  uint8_t* front_out;
  int32_t* counts;
  unsigned long long* keys;    // [n_out], kEmptyKey between calls
  unsigned int* flags;         // [n_tiles], 0 between calls
  int32_t* sched;              // [n_tiles]
  int32_t* touched;            // [n_out]
  int32_t* lists;              // [2][n_out]: the frontier lists
  uint8_t* marks;              // [2][n_out], 0 between calls
  int32_t* scal;               // [kScalars], 0 between calls
};

// Append v to `list` (its length in *n): one atomicAdd for the lanes of a
// warp that append together.
__device__ __forceinline__ void append(int32_t* list, int32_t* n,
                                       int32_t v) {
  cg::coalesced_group g = cg::coalesced_threads();
  int32_t base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(n, (int)g.size());
  list[g.shfl(base, 0) + (int32_t)g.thread_rank()] = v;
}

// Sums of x, y and z over the block, valid in thread 0.
__device__ __forceinline__ void block_sums(int& x, int& y, int& z,
                                           int (*part)[kThreads / 32]) {
  for (int o = 16; o > 0; o >>= 1) {
    x += __shfl_down_sync(kFull, x, o);
    y += __shfl_down_sync(kFull, y, o);
    z += __shfl_down_sync(kFull, z, o);
  }
  __syncthreads();                      // part is free again
  if ((threadIdx.x & 31) == 0) {
    part[0][threadIdx.x >> 5] = x;
    part[1][threadIdx.x >> 5] = y;
    part[2][threadIdx.x >> 5] = z;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int k = 1; k < kThreads / 32; ++k) {
      x += part[0][k];
      y += part[1][k];
      z += part[2][k];
    }
}

template <bool kAlt>
__global__ void __launch_bounds__(kThreads) fused_rounds_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int part[3][kThreads / 32];
  const float lb = *a.lb, ub = *a.ub;
  const int max_r = lb <= 0.0f ? 1 : a.fused_rounds;
  const float prune_ub = kAlt ? *a.prune_ub : 0.0f;
  const float infl = kAlt ? *a.infl : 0.0f;
  const int32_t tgt = kAlt ? *a.tgt : 0;
  const int64_t n_out = a.n_out;
  const int lane = threadIdx.x & 31;
  const int64_t gtid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * kThreads;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
  int32_t* const scal = a.scal;

  // 0. copy, list the frontier, schedule round 0 (warp-uniform trip
  // count: gstride is a multiple of 32, for schedule_entries' shuffles)
  if (leader)
    for (int i = 0; i < 8; ++i) a.counts[i] = 0;
  for (int64_t v = gtid; v - lane < n_out; v += gstride) {
    int32_t lo = 0, hi = 0;
    if (v < n_out) {
      const float d = a.dist_in[v];
      a.dist_out[v] = d;
      a.parent_out[v] = a.parent_in[v];
      a.front_out[v] = 0;
      if (a.front_in[v]) {
        append(a.lists, &scal[kFrontN], (int32_t)v);
        if (d <= 0.0f || a.deg[v] > 1) {
          a.marks[v] = 1;
          lo = a.vt_ptr[v];
          hi = a.vt_ptr[v + 1];
        }
      }
    }
    schedule_entries(lo, hi, a.vt_tile, a.tile_first, a.flags, a.sched,
                     &scal[kSchedN]);
  }
  grid.sync();

  for (int r = 0;; ++r) {
    const int p = r & 1;
    const uint8_t* mark = a.marks + p * n_out;
    const int32_t* list = a.lists + p * n_out;
    const bool next = r + 1 < max_r;

    // 1. relax the forced and the scheduled tiles
    const int64_t n_sched = a.n_forced + __ldcg(&scal[kSchedN + p]);
    const int32_t n_front = __ldcg(&scal[kFrontN + p]);
    if (leader) {
      a.counts[kRounds] += n_front > 0;
      a.counts[kTiles] += (int32_t)n_sched;
      a.counts[kExec] += 1;
      scal[kTouchedN + (p ^ 1)] = 0;
      scal[kFrontN + (p ^ 1)] = 0;
    }
    const float bound =
        kAlt ? fminf(prune_ub, __fmul_rn(__ldcg(a.dist_out + tgt), infl))
             : 0.0f;
    int trav = 0, rlx = 0, prn = 0;
    for (int64_t k = blockIdx.x; k < n_sched; k += gridDim.x) {
      int32_t t;
      if (k < a.n_forced) {
        t = a.forced[k];
      } else {
        t = __ldcg(a.sched + (k - a.n_forced));
        if (threadIdx.x == 0) a.flags[t] = 0u;
      }
      const int64_t base = (int64_t)t * a.tile_e;
      for (int i = threadIdx.x; i < a.tile_e; i += kThreads) {
        const int64_t e = base + i;
        const int32_t s = a.src[e];
        if (!__ldcg(mark + s)) continue;
        const float c = __fadd_rn(__ldcg(a.dist_out + s), a.w[e]);
        if (c >= lb && c < ub) {
          const int32_t d = a.dst[e];
          const bool notpar = d != __ldcg(a.parent_out + s);
          ++trav;
          if (kAlt && !(__fadd_rn(c, a.alt_lb[d]) <= bound)) {
            prn += notpar;
            continue;
          }
          rlx += notpar;
          if (atomicMin(&a.keys[d], pack_key(c, s)) == kEmptyKey)
            append(a.touched, &scal[kTouchedN + p], d);
        }
      }
    }
    block_sums(trav, rlx, prn, part);
    if (threadIdx.x == 0 && trav) {
      atomicAdd(&a.counts[kTrav], trav);
      atomicAdd(&a.counts[kRelax], rlx);
      if (kAlt) atomicAdd(&a.counts[kPruned], prn);
    }
    grid.sync();

    // 2. commit over the touched destinations
    if (leader) scal[kSchedN + p] = 0;
    const int32_t n_touched = __ldcg(&scal[kTouchedN + p]);
    uint8_t* next_mark = a.marks + (p ^ 1) * n_out;
    int32_t* next_list = a.lists + (p ^ 1) * n_out;
    int upd = 0, ext = 0, unused = 0;
    for (int64_t i = gtid; i - lane < n_touched; i += gstride) {
      int32_t lo = 0, hi = 0;
      if (i < n_touched) {
        const int32_t v = __ldcg(a.touched + i);
        const unsigned long long key = __ldcg(a.keys + v);
        a.keys[v] = kEmptyKey;
        const float val = key_val(key);
        if (val < __ldcg(a.dist_out + v)) {
          const bool hub = a.deg[v] > 1;
          a.dist_out[v] = val;
          a.parent_out[v] = key_win(key);
          ++upd;
          ext += hub;
          append(next_list, &scal[kFrontN + (p ^ 1)], v);
          if (next && (val <= 0.0f || hub)) {
            next_mark[v] = 1;
            lo = a.vt_ptr[v];
            hi = a.vt_ptr[v + 1];
          }
        }
      }
      schedule_entries(lo, hi, a.vt_tile, a.tile_first, a.flags, a.sched,
                       &scal[kSchedN + (p ^ 1)]);
    }
    for (int64_t i = gtid; i < n_front; i += gstride)
      a.marks[p * n_out + __ldcg(list + i)] = 0;
    block_sums(upd, ext, unused, part);
    if (threadIdx.x == 0 && upd) {
      atomicAdd(&a.counts[kUpdates], upd);
      atomicAdd(&a.counts[kExtended], ext);
    }
    grid.sync();

    // 3. the same decision in every block
    const int32_t n_next = __ldcg(&scal[kFrontN + (p ^ 1)]);
    if (!(next && n_next > 0)) {
      for (int64_t i = gtid; i < n_next; i += gstride)
        a.front_out[__ldcg(next_list + i)] = 1;
      break;
    }
  }

  // the last block to leave resets the round scalars: every block has
  // read them by now
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&scal[kLeft], 1) == (int)gridDim.x - 1)
      for (int i = 0; i < kScalars; ++i) scal[i] = 0;
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
// `infl` and `tgt` (device scalars) are all null without ALT.  The scratch
// (`keys` [n_out], `flags` and `sched` [n_tiles], `touched` [n_out],
// `lists` [2 n_out], `marks` [2 n_out], `scal` [8]) must be clean on entry
// (keys kEmptyKey; flags, marks and scal 0); a call that returns 0 leaves
// it so.
extern "C" int edge_relax_fused_launch(
    const float* dist_in, const int32_t* parent_in, const uint8_t* front_in,
    const int32_t* deg, const int32_t* src, const int32_t* dst,
    const float* w, const uint8_t* tile_first, const int32_t* vt_ptr,
    const int32_t* vt_tile, const int32_t* forced, int64_t n_forced,
    const float* lb, const float* ub, const float* alt_lb,
    const float* prune_ub, const float* infl, const int32_t* tgt,
    int tile_e, int64_t n_out, int fused_rounds, float* dist_out,
    int32_t* parent_out, uint8_t* front_out, int32_t* counts,
    unsigned long long* keys, unsigned int* flags, int32_t* sched,
    int32_t* touched, int32_t* lists, uint8_t* marks, int32_t* scal,
    void* stream) {
  static int coop = -1;
  if (coop < 0) {
    int dev = 0, got = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&got, cudaDevAttrCooperativeLaunch,
                                      dev)) != cudaSuccess)
      return (int)err;
    coop = got;
  }
  if (!coop) return -1;
  const bool alt = alt_lb != nullptr;
  const void* kernel = alt ? (const void*)fused_rounds_kernel<true>
                           : (const void*)fused_rounds_kernel<false>;
  // the grid rule: the co-resident maximum
  const int blocks =
      alt ? resident_blocks<fused_rounds_kernel<true>>(kThreads)
          : resident_blocks<fused_rounds_kernel<false>>(kThreads);
  if (blocks == 0) return no_blocks();
  Args args{dist_in, parent_in, front_in, deg, src, dst, w, tile_first,
            vt_ptr, vt_tile, forced, n_forced, lb, ub, alt_lb, prune_ub,
            infl, tgt, tile_e, n_out, fused_rounds, dist_out, parent_out,
            front_out, counts, keys, flags, sched, touched, lists, marks,
            scal};
  void* params[] = {&args};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(kThreads), params, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
