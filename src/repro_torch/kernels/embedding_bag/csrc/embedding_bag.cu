// embedding_bag for Hopper (sm_90a): per bag, the sum or the mean of table
// rows, weighted (`embedding_bag_launch`) or under a mask
// (`embedding_bag_masked_launch`).
//
// Replaces the Pallas TPU kernel `embedding_bag`
// (src/repro/kernels/embedding_bag/embedding_bag.py:48, body `_kernel` at
// :29), whose function the first entry computes; the masked entry computes
// the recsys layer's `embedding_bag_batched` (src/repro/models/recsys/
// embedding.py:33) from its raw ids and mask, which the layer otherwise
// turned into ids and weights with a pass of elementwise kernels.
//
// Bound on this card.  Bytes: the least the card must move is each
// distinct row read once (each distinct masked-in row, masked), the ids and
// weights (8 B a lookup) or the ids and mask (5 B), and the f32 output, at
// 3.35 TB/s; 2*D flops a lookup are far below the f32 rate.  At a small
// batch (512 bags of 50) the bound is a fraction of a microsecond and the
// kernel is bound by latency instead: by the chain of round trips to memory
// that a bag's lookups make.
//
// What the design does about it.  A group of G lanes owns a bag (G = the
// row's 16-byte chunks, rounded up to 8, 16 or 32; a half-warp for D = 64
// in f32), one chunk a lane; a row wider than 32 chunks takes several
// column passes.  Two paths, chosen by batch:
// - Staged, when every bag has a group on the card at once (one warp a
//   block).  The group lists 64 lookups at a time in shared memory (their
//   ids, and weights or mask bytes, read at once; the masked entry drops
//   the masked-out ones there), copies every listed row into a slot of its
//   own by 16-byte cp.async, waits once, then adds the rows from shared
//   memory in lookup order.  So a bag of 50 lookups costs about one round
//   trip for its ids and one for its rows, not one per few lookups.
// - Direct, at a larger batch, where the card is full of bags anyway: each
//   lane reads one lookup's id of the next G, the group shares them by
//   shuffles and loads the rows straight into registers, four lookups in
//   flight.  Staging through shared memory there costs more than it hides
//   (PERF.md, the `[embedding_bag design]` line).  The masked entry loads
//   no masked-out row.
//
// Arithmetic.  Both paths add in lookup order:
// acc = __fadd_rn(acc, __fmul_rn(row, w)) for l = 0..L-1 from +0, a
// multiply and an add each rounded, never fused into an FMA, so the result
// is bitwise that of the plain version (ref.py), which does the same in the
// same order.  The mean divides once, after the loop, by the weight sum
// (also in lookup order), clamped at 1e-9 as `_kernel` does; a NaN weight
// sum stays NaN, as in torch.clamp.  No weights means weights of 1.0.
// The masked entry adds each masked-in row (weight 1: `row * 1` is `row`)
// and nothing for a masked-out lookup; its mean divides by the count of
// masked-in lookups, 1e-9 when there is none.  bf16 rows are widened with
// __bfloat162float.
//
// Ids.  `embedding_bag_launch` as the Pallas kernel runs in interpret mode:
// an id in [-V, -1] wraps to id + V, any other id outside [0, V) is clamped
// to [0, V-1].  `embedding_bag_masked_launch` as `jnp.take` in the
// reference layer: a masked-in id in [-V, -1] wraps, one outside [-V, V)
// makes its bag NaN; a masked-out id is not read.  Row offsets are 64-bit
// (a 10^7 x 64 f32 table is 2.56 GB), and so are B*L and the bag index.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // threads a block of the direct path
constexpr int kSeg = 64;           // lookups a staged group lists at a time
constexpr int kUnroll = 4;         // lookups added a step
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* table;
  const int32_t* ids;
  const float* w;                  // weighted entry; null: every weight 1
  const unsigned char* mask;       // masked entry; null: all masked in
  float* out;
  long long V, B;
  int D, L, mean;
  int pitch;                       // bytes of a slot: a pass's slice of a row
  int passes;                      // column passes over a row
};

// A staged group's list of the rows it adds, in order.
struct List {
  long long off[kSeg];             // byte offset of the lookup's row
  float w[kSeg];                   // weighted: the lookup's weight
};

// A staged group's shared memory: its list, then a slot a listed row.
__host__ __device__ constexpr int group_bytes(int pitch) {
  return static_cast<int>(sizeof(List)) + kSeg * pitch;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}
// Returns once every cp.async copy of this lane has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// 16 bytes of a row, widened to f32.
__device__ __forceinline__ void widen(const uint4& x, float (&v)[4]) {
  v[0] = __uint_as_float(x.x);
  v[1] = __uint_as_float(x.y);
  v[2] = __uint_as_float(x.z);
  v[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void widen(const uint4& x, float (&v)[8]) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}

// A lookup as read: its id, and its weight or mask byte.
struct Lookup {
  int32_t id;
  float w;
  bool in;                         // l < L in a bag < B
  bool live;                       // masked in
};

template <bool kMasked>
__device__ __forceinline__ Lookup read_lookup(const Params& p, long long at,
                                              bool in) {
  Lookup f{0, 1.f, in, false};
  if (in) {
    f.id = __ldg(p.ids + at);
    if (kMasked) f.live = p.mask == nullptr || __ldg(p.mask + at) != 0;
    else if (p.w != nullptr) f.w = __ldg(p.w + at);
  }
  return f;
}

// The entry's id rule: `take` the lookup's row, at byte offset `off`; `oob`
// (masked): a masked-in id outside [-V, V), which makes the bag NaN.
template <bool kMasked>
__device__ __forceinline__ void resolve(const Lookup& f, long long V,
                                        long long row_bytes, long long& off,
                                        bool& take, bool& oob) {
  long long r = f.id;
  if (r < 0) r += V;
  if (kMasked) {
    const bool ok = r >= 0 && r < V;
    take = f.live && ok;
    oob = f.live && !ok;
  } else {
    take = f.in;
    oob = false;
    r = r < 0 ? 0 : (r >= V ? V - 1 : r);
  }
  off = take ? r * row_bytes : 0;
}

// The bag's result: the mean's divide, the masked entry's NaN bag.
template <bool kMasked, int VEC>
__device__ __forceinline__ void finish(const Params& p, float (&acc)[VEC],
                                       float wsum, int cnt, bool bad,
                                       float* o) {
  if (p.mean) {
    const float d = kMasked ? (cnt > 0 ? static_cast<float>(cnt) : 1e-9f)
                            : (wsum < 1e-9f ? 1e-9f : wsum);  // NaN stays
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = __fdiv_rn(acc[e], d);
  }
  if (kMasked && bad) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = __int_as_float(0x7fffffff);
  }
#pragma unroll
  for (int e = 0; e < VEC; e += 4)
    *reinterpret_cast<float4*>(o + e) =
        make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
}

// The staged path: one warp a block, 32 / G bags, every listed row of a
// bag in flight at once.
template <typename T, bool kMasked, int G>
__global__ void __launch_bounds__(32) staged_kernel(const Params p) {
  constexpr int VEC = 16 / sizeof(T);           // elements of a chunk
  constexpr int BPW = 32 / G;                   // bags a warp
  static_assert(kSeg % G == 0 && kSeg % kUnroll == 0, "whole steps");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x, g = lane / G, t = lane % G;
  const unsigned group = (G == 32 ? kFull : (1u << G) - 1) << (g * G);
  const unsigned below = (1u << lane) - 1;
  unsigned char* base = smem + g * group_bytes(p.pitch);
  List& list = *reinterpret_cast<List*>(base);
  unsigned char* ring = base + sizeof(List);
  const char* table = static_cast<const char*>(p.table);
  const long long row_bytes = static_cast<long long>(p.D) * sizeof(T);
  const int chunks = p.D / VEC, slot_chunks = p.pitch / 16;
  const long long bag = static_cast<long long>(blockIdx.x) * BPW + g;
  const bool valid = bag < p.B;
  for (int pass = 0; pass < p.passes; ++pass) {
    const int parts = min(slot_chunks, chunks - pass * slot_chunks);
    const bool active = t < parts;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    float wsum = 0.f;
    int cnt = 0;
    bool bad = false;
    for (int s0 = 0; s0 < p.L; s0 += kSeg) {
      __syncwarp();                             // the list and slots are free
      // list lookups s0 .. s0 + kSeg - 1: read them all, then sort
      Lookup raw[kSeg / G];
#pragma unroll
      for (int i = 0; i < kSeg / G; ++i) {
        const int l = s0 + i * G + t;
        raw[i] = read_lookup<kMasked>(p, bag * p.L + l, valid && l < p.L);
      }
      int n = 0;
#pragma unroll
      for (int i = 0; i < kSeg / G; ++i) {
        long long off;
        bool take, oob;
        resolve<kMasked>(raw[i], p.V, row_bytes, off, take, oob);
        const unsigned took = __ballot_sync(kFull, take) & group;
        bad |= (__ballot_sync(kFull, oob) & group) != 0;
        if (take) {
          const int pos = n + __popc(took & below);
          list.off[pos] = off;
          if (!kMasked) list.w[pos] = raw[i].w;
        }
        n += __popc(took);
      }
      cnt += n;
      __syncwarp();                             // the list is written
      // every listed row in flight at once: one round trip
      if (active)
        for (int i = 0; i < n; ++i)
          cp_async16(ring + i * p.pitch + t * 16,
                     table + list.off[i] + pass * p.pitch + t * 16);
      cp_async_wait_all();
      // each lane adds the chunks it copied itself, in lookup order
      for (int j = 0; j < n; j += kUnroll) {
        float w[kUnroll], v[kUnroll][VEC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          w[u] = kMasked || j + u >= n ? 1.f : list.w[j + u];
          if (active && j + u < n)
            widen(*reinterpret_cast<const uint4*>(ring + (j + u) * p.pitch +
                                                  t * 16), v[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j + u < n) {
            if (!kMasked) wsum = __fadd_rn(wsum, w[u]);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[e] = kMasked ? __fadd_rn(acc[e], v[u][e])
                               : __fadd_rn(acc[e], __fmul_rn(v[u][e], w[u]));
          }
        }
      }
    }
    if (valid && active)
      finish<kMasked>(p, acc, wsum, cnt, bad,
                      p.out + bag * p.D + (pass * slot_chunks + t) * VEC);
  }
}

// The direct path: kThreads / G bags a block, rows loaded to registers.
template <typename T, bool kMasked, int G>
__global__ void __launch_bounds__(kThreads) direct_kernel(const Params p) {
  constexpr int VEC = 16 / sizeof(T);
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const long long bag = (first + threadIdx.x) / G;
  // a warp whose groups all lie past the last bag has nothing to do; the
  // others keep every lane in the loops, so the shuffles see full warps
  if ((first + (threadIdx.x & ~31)) / G >= p.B) return;
  const int lane = threadIdx.x & 31, t = lane % G;
  const unsigned group = (G == 32 ? kFull : (1u << G) - 1) << (lane / G * G);
  const bool valid = bag < p.B;
  const int chunks = p.D / VEC;
  const char* table = static_cast<const char*>(p.table);
  const long long row_bytes = static_cast<long long>(p.D) * sizeof(T);
  for (int c0 = 0; c0 < chunks; c0 += G) {
    const int c = c0 + t;
    const bool active = valid && c < chunks;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    float wsum = 0.f;
    int cnt = 0;
    bool bad = false;
    for (int l0 = 0; l0 < p.L; l0 += G) {
      const Lookup f = read_lookup<kMasked>(p, bag * p.L + l0 + t,
                                            valid && l0 + t < p.L);
      long long off;
      bool take, oob;
      resolve<kMasked>(f, p.V, row_bytes, off, take, oob);
      if (kMasked) {
        cnt += __popc(__ballot_sync(kFull, take) & group);
        bad |= (__ballot_sync(kFull, oob) & group) != 0;
      }
      const int n = min(G, p.L - l0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const long long o = __shfl_sync(kFull, off, j, G);
        const float w = __shfl_sync(kFull, f.w, j, G);
        const bool tk = !kMasked || __shfl_sync(kFull, int(take), j, G);
        if (!kMasked) wsum = __fadd_rn(wsum, w);
        if (active && tk) {
          float v[VEC];
          widen(__ldg(reinterpret_cast<const uint4*>(table + o) + c), v);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[e] = kMasked ? __fadd_rn(acc[e], v[e])
                             : __fadd_rn(acc[e], __fmul_rn(v[e], w));
        }
      }
    }
    if (active)
      finish<kMasked>(p, acc, wsum, cnt, bad,
                      p.out + bag * p.D + static_cast<long long>(c) * VEC);
  }
}

// Co-resident blocks of the staged kernel (one warp, `smem` bytes) on the
// card; asked once per kernel and slot size (the process's cards are taken
// to be alike).
template <auto kKernel>
cudaError_t resident(int smem, int pitch, long long* blocks) {
  static long long known[33] = {};              // by pitch / 16
  long long& got = known[pitch / 16];
  if (got == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel,
                                                          32, smem);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    got = static_cast<long long>(sms) * per_sm;
  }
  *blocks = got;
  return cudaSuccess;
}

// Staged when every bag's group fits on the card at once, else direct.
// Every staged configuration needs under 48 KB of shared memory a block
// (32 KB of slots and the lists).
template <typename T, bool kMasked, int G>
cudaError_t launch(const Params& p, cudaStream_t st) {
  constexpr int BPW = 32 / G;
  const long long warps = (p.B + BPW - 1) / BPW;
  const int smem = BPW * group_bytes(p.pitch);
  long long fit = 0;
  const cudaError_t err =
      resident<staged_kernel<T, kMasked, G>>(smem, p.pitch, &fit);
  if (err != cudaSuccess) return err;
  if (warps <= fit) {
    staged_kernel<T, kMasked, G>
        <<<static_cast<unsigned>(warps), 32, smem, st>>>(p);
  } else {
    const long long blocks = (p.B * G + kThreads - 1) / kThreads;
    direct_kernel<T, kMasked, G>
        <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p);
  }
  return cudaGetLastError();
}

// Lanes per bag: the row's 16-byte chunks rounded up to 8, 16 or 32.
template <typename T, bool kMasked>
cudaError_t by_width(Params p, cudaStream_t st) {
  const int chunks = p.D / (16 / static_cast<int>(sizeof(T)));
  const int g = chunks <= 8 ? 8 : chunks <= 16 ? 16 : 32;
  p.pitch = (chunks < g ? chunks : g) * 16;
  p.passes = (chunks + g - 1) / g;
  if (g == 8) return launch<T, kMasked, 8>(p, st);
  if (g == 16) return launch<T, kMasked, 16>(p, st);
  return launch<T, kMasked, 32>(p, st);
}

template <bool kMasked>
int dispatch(int dtype, long long V, int D, long long B, int L,
             const void* table, const int32_t* ids, const float* w,
             const unsigned char* mask, float* out, int mean, void* stream) {
  if (B == 0) return 0;
  const int size = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (size == 0 || V <= 0 || L < 0 || D <= 0 || (D * size) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{table, ids, w, mask, out, V, B, D, L, mean, 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? by_width<float, kMasked>(p, st)
                              : by_width<__nv_bfloat16, kMasked>(p, st);
  return static_cast<int>(err);
}

}  // namespace


extern "C" const char* embedding_bag_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}

// dtype 0 = float32, 1 = bfloat16 table [V, D], row-contiguous and 16-byte
// aligned, rows of whole 16-byte chunks; ids [B, L] int32; w [B, L] float32
// or null; out [B, D] float32; mean 0 = sum, 1 = mean.  Returns 0 or the
// cudaError_t of the launch.
extern "C" int embedding_bag_launch(int dtype, long long V, int D,
                                    long long B, int L, const void* table,
                                    const int32_t* ids, const float* w,
                                    float* out, int mean, void* stream) {
  return dispatch<false>(dtype, V, D, B, L, table, ids, w, nullptr, out, mean,
                         stream);
}

// The same, for the recsys layer: mask [B, L] bool (one byte a lookup) or
// null for all masked in, in place of the weights.
extern "C" int embedding_bag_masked_launch(int dtype, long long V, int D,
                                           long long B, int L,
                                           const void* table,
                                           const int32_t* ids,
                                           const unsigned char* mask,
                                           float* out, int mean,
                                           void* stream) {
  return dispatch<true>(dtype, V, D, B, L, table, ids, nullptr, mask, out,
                        mean, stream);
}
