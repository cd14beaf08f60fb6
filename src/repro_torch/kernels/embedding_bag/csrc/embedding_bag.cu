// embedding_bag for Hopper (sm_90a): per bag, the sum, the weighted sum or
// the weighted mean of table rows.
//
// Replaces the Pallas TPU kernel `embedding_bag`
// (src/repro/kernels/embedding_bag/embedding_bag.py:48, body `_kernel` at
// :29).  It computes that kernel's function, not its schedule: the TPU
// version walks one grid step per lookup and revisits the bag's output
// block.  Here a group of G lanes owns one bag (G = the row's 16-byte
// chunks, rounded up to a power of two, at most 32: a half-warp for D = 64
// in f32, 8 lanes in bf16), each lane owns 16-byte chunks of the row, and
// the group loops over the bag's L lookups in order, accumulating in f32
// registers, then stores the bag's row once.  A row wider than 32 chunks
// takes several passes over the lookups, 32 chunks a pass.
//
// Arithmetic.  acc = __fadd_rn(acc, __fmul_rn(row, w)) for l = 0..L-1, from
// 0: a multiply and an add each rounded, never fused into an FMA, so the
// result is bitwise that of the plain version (ref.py), which does the
// same in the same order.  The mean divides once, after the loop, by the
// weight sum (also in lookup order), clamped at 1e-9 as `_kernel` does; a
// NaN weight sum stays NaN, as in torch.clamp.  No weights means weights
// of 1.0.  bf16 rows are widened with __bfloat162float.
//
// Ids.  As the Pallas kernel runs in interpret mode: an id in [-V, -1]
// wraps to id + V, any other id outside [0, V) is clamped to [0, V-1].
// Row offsets are 64-bit (a 10^7 x 64 f32 table is 2.56 GB), and so are
// B*L and the bag index.
//
// Bound on this card: bytes.  The least the card must move is every
// distinct id's row once, the ids and weights once (8 bytes a lookup) and
// the f32 output once, at 3.35 TB/s; 2*D flops a lookup are far below the
// f32 rate.  What the design does about it: no shared memory; a group's
// lanes read a row as consecutive 16-byte loads (one 256-byte segment for
// D = 64 f32); the group's ids and weights are read G at a time by its
// lanes and passed round by shuffles; the loop is unrolled so that several
// row loads are in flight per lane.  Repeated rows are not re-fetched from
// device memory when they hit the 50 MB L2, which under the Zipf ids of
// recsys traffic holds the hot head of the table.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Params {
  const void* table;
  const int32_t* ids;
  const float* w;     // null: every weight is 1
  float* out;
  long long V, B;
  int D, L, mean;
};

// 16 bytes of a row, widened to f32.
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ long long row_of(int32_t id, long long V) {
  long long r = id;
  if (r < 0) r += V;
  return r < 0 ? 0 : (r >= V ? V - 1 : r);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) bag_kernel(const Params p) {
  constexpr int VEC = 16 / sizeof(T);           // elements per 16 bytes
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const long long bag = (first + threadIdx.x) / G;
  // a warp whose groups all lie past the last bag has nothing to do; the
  // others keep every lane in the loops, so the shuffles see full warps
  if ((first + (threadIdx.x & ~31)) / G >= p.B) return;
  const int lane = threadIdx.x % G;
  const bool valid = bag < p.B;
  const int chunks = p.D / VEC;
  const T* table = static_cast<const T*>(p.table);
  const long long base = (valid ? bag : 0) * p.L;
  for (int c0 = 0; c0 < chunks; c0 += G) {
    const int c = c0 + lane;
    const bool active = valid && c < chunks;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    float wsum = 0.f;
    for (int l0 = 0; l0 < p.L; l0 += G) {
      long long my_row = 0;
      float my_w = 0.f;
      if (valid && l0 + lane < p.L) {
        my_row = row_of(p.ids[base + l0 + lane], p.V);
        my_w = p.w ? p.w[base + l0 + lane] : 1.f;
      }
      const int n = min(G, p.L - l0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const long long row = __shfl_sync(0xffffffffu, my_row, j, G);
        const float w = __shfl_sync(0xffffffffu, my_w, j, G);
        wsum = __fadd_rn(wsum, w);
        if (active) {
          float v[VEC];
          load16(table + row * p.D + static_cast<long long>(c) * VEC, v);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(v[e], w));
        }
      }
    }
    if (active) {
      if (p.mean) {
        const float d = wsum < 1e-9f ? 1e-9f : wsum;   // NaN stays NaN
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = __fdiv_rn(acc[e], d);
      }
      float* o = p.out + bag * p.D + static_cast<long long>(c) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(o + e) =
            make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
    }
  }
}

template <typename T, int G>
cudaError_t launch(const Params& p, cudaStream_t st) {
  constexpr long long per_block = kThreads / G;
  const long long blocks = (p.B + per_block - 1) / per_block;
  bag_kernel<T, G><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// Lanes per bag: the row's 16-byte chunks rounded up to a power of two,
// at most 32.
template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (p.D <= 0 || p.D % VEC) return cudaErrorInvalidValue;
  const int chunks = p.D / VEC;
  if (chunks <= 1) return launch<T, 1>(p, st);
  if (chunks <= 2) return launch<T, 2>(p, st);
  if (chunks <= 4) return launch<T, 4>(p, st);
  if (chunks <= 8) return launch<T, 8>(p, st);
  if (chunks <= 16) return launch<T, 16>(p, st);
  return launch<T, 32>(p, st);
}

}  // namespace

extern "C" const char* embedding_bag_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}

// dtype 0 = float32, 1 = bfloat16 table [V, D], row-contiguous and 16-byte
// aligned; ids [B, L] int32; w [B, L] float32 or null; out [B, D] float32;
// mean 0 = sum, 1 = mean.  Returns 0 or the cudaError_t of the launch.
extern "C" int embedding_bag_launch(int dtype, long long V, int D,
                                    long long B, int L, const void* table,
                                    const int32_t* ids, const float* w,
                                    float* out, int mean, void* stream) {
  const Params p{table, ids, w, out, V, B, D, L, mean};
  if (B == 0) return 0;
  if (V <= 0 || L < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = dtype == 0   ? dispatch<float>(p, st)
                          : dtype == 1 ? dispatch<__nv_bfloat16>(p, st)
                                       : cudaErrorInvalidValue;
  return (int)err;
}
