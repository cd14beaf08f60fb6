// edge_relax for Hopper (sm_90a): one round of frontier-compacted,
// windowed scatter-min with deterministic min-source-id winners.
//
// Replaces the Pallas TPU kernel `edge_relax` (src/repro/kernels/edge_relax/
// edge_relax.py:188, body `_kernel` at :130, jnp prepass `schedule_tiles`
// at :98).  It computes what that kernel computes, not how: the TPU has no
// scatter, so it built a [TILE_E x BLOCK_V] broadcast-compare plane per
// tile.  Here each in-window candidate does one 64-bit atomicMin into a key
// per destination:
//
//   key = (float bits of dist[src] + w) << 32 | global source id
//
// The packed key, the flag pass and the unpack are in edge_relax_common.cuh.
//
// Launch sequence (one call of edge_relax_launch, all on one stream):
//   1. flag_tiles: prefill the keys; flag each tile that holds an edge with
//      a frontier source and a finite weight, or is a bucket's forced first
//      tile, and append it to `sched` (order is free: the min is
//      order-independent).  `sched_n` is the active-tile count and stays on
//      the device.
//   2. relax_tiles: one block per tile of the static count; a block at or
//      above *sched_n exits at once, the others walk one scheduled tile.
//   3. unpack: keys -> (vals f32, wins i32).
//
// The ALT branch (edge_relax.py:158-164, the `alt` operands at :219-241) is
// the template flag kAlt of relax_tiles, chosen by the launcher from a
// non-null `alt_lb`: an in-window candidate c to destination d enters only
// if __fadd_rn(c, alt_lb[d]) <= *prune_bound (the reference's
// `cand + alt_lb[dst] <= lbub[2]`), so a pruned candidate never touches the
// key.  The prune bound is a device scalar, like lb and ub, so the caller
// needs no host read.  Without ALT the kAlt = false instantiation is the
// kernel as it was before the branch existed.
//
// Bound on this card: bytes.  12 B per scheduled edge slot (src, dst, w),
// 5 B of gathers per frontier edge (paths i8 + dist f32), 8 B per output
// key written and read back, plus the prepass's 9 B per slot; with ALT 4 B
// of alt_lb per distinct destination of the in-window candidates.  No
// arithmetic to speak of.  The
// atomics on the hub destinations of Kronecker graphs are the expected
// contention point; a later version can pre-reduce per warp.
#include "edge_relax_common.cuh"

namespace {

template <bool kAlt>
__global__ void relax_tiles(const float* __restrict__ dist,
                            const uint8_t* __restrict__ paths,
                            const int32_t* __restrict__ src,
                            const int32_t* __restrict__ dst,
                            const float* __restrict__ w,
                            const float* __restrict__ lb_p,
                            const float* __restrict__ ub_p,
                            const float* __restrict__ alt_lb,
                            const float* __restrict__ bound_p,
                            const int32_t* __restrict__ sched,
                            const int32_t* __restrict__ sched_n, int tile_e,
                            unsigned long long* __restrict__ keys) {
  if ((int32_t)blockIdx.x >= *sched_n) return;
  const float lb = *lb_p, ub = *ub_p;
  const float bound = kAlt ? *bound_p : 0.0f;
  const int64_t base = (int64_t)sched[blockIdx.x] * tile_e;
  for (int i = threadIdx.x; i < tile_e; i += blockDim.x) {
    const int64_t e = base + i;
    const int32_t s = src[e];
    if (!paths[s]) continue;
    const float c = __fadd_rn(dist[s], w[e]);
    if (c >= lb && c < ub) {
      const int32_t d = dst[e];
      if (!kAlt || __fadd_rn(c, alt_lb[d]) <= bound)
        atomicMin(&keys[d], pack_key(c, s));
    }
  }
}

}  // namespace

// Returns the cudaError_t of the first launch that failed, else 0.
// `alt_lb` [n_out] and `prune_bound` (a device scalar) are both null
// without ALT.
extern "C" int edge_relax_launch(
    const float* dist, const uint8_t* paths, const int32_t* src,
    const int32_t* dst, const float* w, const uint8_t* tile_first,
    const float* lb, const float* ub, const float* alt_lb,
    const float* prune_bound, int64_t n_tiles, int tile_e, int64_t n_out,
    int32_t* sched, int32_t* sched_n, unsigned long long* keys, float* vals,
    int32_t* wins, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(sched_n, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const int threads = tile_threads(tile_e);
  flag_tiles<<<flag_blocks(n_tiles, n_out, threads), threads, 0, st>>>(
      paths, src, w, tile_first, n_tiles, tile_e, sched, sched_n, keys,
      n_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (alt_lb != nullptr)
    relax_tiles<true><<<(unsigned int)n_tiles, threads, 0, st>>>(
        dist, paths, src, dst, w, lb, ub, alt_lb, prune_bound, sched,
        sched_n, tile_e, keys);
  else
    relax_tiles<false><<<(unsigned int)n_tiles, threads, 0, st>>>(
        dist, paths, src, dst, w, lb, ub, nullptr, nullptr, sched, sched_n,
        tile_e, keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  unpack<<<(unsigned int)((n_out + 255) / 256), 256, 0, st>>>(keys, n_out,
                                                             vals, wins);
  return (int)cudaGetLastError();
}
