// flash_attention for Hopper (sm_90a): online-softmax attention with
// grouped-query heads, causal and sliding-window masks, and per-key
// positions (padding keys at a negative position, ring-buffer caches), in
// four designs chosen per call by the wrapper (ops.py::variant).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attn/flash_attn.py:77, body `_kernel` at :30).
// It computes that kernel's function, not its schedule: f32 scores scaled
// by 1/sqrt(D), f32 running max m, sum l and accumulator, rows with no
// visible key give 0 (l is clamped at 1e-30), output cast to the input type.
// The TPU kernel masks padded keys with `t_real`; here a key is visible iff
// its position is >= 0 (and <= the query's, and > query - window), which is
// the same function when positions are 0..T-1.
//
// Layout.  Every design takes element strides, so it reads the model's own
// layouts in place: q and out [B, S, KV, HG, D] (HG query heads share one
// KV head), k and v [B, T, KV, D] (one layer of the KV cache), positions
// q_pos [B, S] and k_pos [B, T].  A null q_pos (k_pos) means position s
// (t); with a null k_pos a block cuts its key range [lo, hi) to the keys
// its rows can see (causal: up to its last row's position; window: from
// its first row's position - window + 1).  A block's rows are the
// flattened (query position, head in group) pairs, so one K/V tile serves
// the whole group (the TPU kernel re-reads it per head).
//
// "tc" (prefill: bf16, D 64 or 128, S*HG >= 64 rows).  Bound by
// operations: 4*D flops per visible (query head, key) pair, 17.2 GFLOP at
// S = T = 2048, H = 16, D = 128, 0.017 ms at 989 TFLOP/s.  So both
// products run on the tensor cores: a block of 256 threads holds 128 rows,
// two warpgroups of 64; per 64-key tile S = Q K^T is a wgmma with Q and K
// in shared memory (bf16 products are exact in f32 and summed in f32, the
// TPU kernel's f32 dot_general on bf16 inputs), the online softmax runs
// in the accumulator registers (row max and sum over the 4 threads that
// share a row, exp2 of log2e-scaled scores), and O += P V is a second
// wgmma with P rounded to bf16 in registers (the one departure from the
// TPU kernel's f32 inside) and V read transposed from shared memory.
// S of tile j and P V of tile j-1 are issued together, so the softmax of
// tile j runs while P V is on the tensor cores.  Operands sit in shared
// memory in the 128-byte-swizzle layout (wgmma.cuh).  A producer warp
// keeps a 4-stage ring of K/V tiles full with TMA (one thread; 4-d tensor
// maps over the strided cache view, keys past T read as 0) and full /
// empty mbarriers, so the two warpgroups meet no barrier inside the loop;
// Q is copied once with cp.async.  Masks are applied to the score
// accumulators only on tiles that need them.  One flat grid takes the
// heaviest (latest) row tiles of every head first.  About 0.049 ms at the
// shape above, 350 TFLOP/s (PERF.md); the same design with every thread
// copying through cp.async and a barrier a tile took 0.084.
//
// "split" (decode: S*HG <= 8 rows, both dtypes).  Bound by bytes: every
// visible K/V row is read once (134 MB at B = 8, T = 4096, KV = 8, D = 128
// bf16, 0.040 ms at 3.35 TB/s).  B*KV blocks would leave most SMs idle,
// so the key range is cut into n_split chunks (flash-decoding, n_split
// chosen by the wrapper so that B*KV*n_split is about two blocks per SM).
// Each block streams its chunk with 16-byte loads, a group of D*size/16
// threads per key and 4 keys in flight per group, keeps a running (m, l,
// acc) per group, merges its groups in a fixed order and writes f32
// partials to scratch; flash_fwd_combine merges the chunks in chunk
// order.  So the result is deterministic.  A chunk with no visible key
// gives m = -inf, l = 0 and adds nothing.
//
// "split_tc" (bf16, D 64 or 128, 9..63 rows: granite-34b's MQA decode,
// 48 query heads over one KV head).  Bound by bytes like "split", but its
// rows do not fit split's per-group registers and shared memory, and
// B*KV blocks (4 for granite's 4 slots) would leave 128 of the 132 SMs
// idle.  So it is split's grid over "tc"'s tile: one block of one
// warpgroup (128 threads) per (key chunk, KV head, batch row), holding all
// of the group's flattened rows padded to 64 (the padding rows of Q are
// zero, read like the others and never written); chunks are whole 64-key
// tiles, n_split chosen by the wrapper (ops.py::split_count) so that
// B*KV*n_split fills the SMs.  Per tile: S = Q K^T by wgmma m64n64k16 with
// Q and K in shared memory in the 128-byte-swizzle layout, the online
// softmax in the accumulator registers, O += P V by wgmma with P rounded
// to bf16 (the same departure from the TPU kernel's f32 as "tc"), K/V fed
// by a cp.async double buffer (16-byte copies, keys past the chunk zero).
// The block writes split's f32 partials and flash_fwd_combine merges them
// in chunk order, so the result is deterministic.  A chunk with no
// visible key gives m = -inf, l = 0.
//
// "simt" (everything else: f32 prefill, D 16 or 32, f32 with 9..63
// rows).  f32 on the CUDA cores: 64-row x 64-key tiles, cp.async double
// buffering, scores in registers, one warp per row for the softmax through
// shared memory.  f32 stays here so that its results keep the f32
// tolerance (TF32 products would not).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* q_pos;
  const int32_t* k_pos;
  int B, S, T, KV, HG;
  long long qsb, qss, qsk, qsg;
  long long ksb, kst, ksk;
  long long vsb, vst, vsk;
  long long osb, oss, osk, osg;
  long long qpb, qps, kpb, kpt;
  int causal, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// N consecutive elements (N = 1, 2 or 4) of shared memory as floats.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = __bfloat162float(*p);
  }
}

// 16 bytes (4 floats or 8 bf16) as floats.
__device__ __forceinline__ void unpack16(const uint4& u, float (&out)[4]) {
  out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&out)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

__device__ __forceinline__ int query_pos(const Params& p, int b, int s) {
  return p.q_pos ? p.q_pos[b * p.qpb + s * p.qps] : s;
}
__device__ __forceinline__ int key_pos(const Params& p, int b, int t) {
  return p.k_pos ? p.k_pos[b * p.kpb + t * p.kpt] : t;
}
__device__ __forceinline__ bool visible(const Params& p, int kp, int qp) {
  return kp >= 0 && (!p.causal || kp <= qp) &&
         (!p.window || kp > qp - p.window);
}
// The keys [lo, hi) that rows at positions qmin..qmax may see: with a null
// k_pos key t sits at position t, so the causal and window cuts apply.
__device__ __forceinline__ void key_range(const Params& p, int qmin,
                                          int qmax, int& lo, int& hi) {
  lo = 0;
  hi = p.T;
  if (p.k_pos == nullptr) {
    if (p.causal) hi = min(hi, qmax + 1);
    if (p.window) lo = max(lo, qmin - p.window + 1);
  }
  hi = max(lo, hi);
}

// ---------------------------------------------------------------------------
// "simt": f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;

template <typename T, int D, int TR, int TC, int RPT, int KPT>
struct Tile {
  static constexpr int BR = TR * RPT;            // query rows per block
  static constexpr int BK = TC * KPT;            // keys per K/V tile
  static constexpr int KCH = 16 / sizeof(T);     // elements per 16 B copy
  static constexpr int LDK = D + KCH;            // K/V smem row (elements)
  static constexpr int LDQ = D + 4;              // Q smem row (floats)
  static constexpr int LDP = BK + 4;             // P smem row (floats)
  static constexpr int DPT = D / TC;             // output dims per thread
  static constexpr int VEC = DPT < 4 ? DPT : 4;  // ... read VEC at a time
  static constexpr int KV_BYTES = 2 * 2 * BK * LDK * (int)sizeof(T);
  static constexpr int SMEM = KV_BYTES +
      (BR * LDQ + BR * LDP + 3 * BR) * (int)sizeof(float) + BR * 4;
  static_assert(TR * TC == kThreads, "128 threads");
  static_assert(D % TC == 0 && D % KCH == 0 && D % 4 == 0, "head dim");
  static_assert(BK % 4 == 0 && DPT % VEC == 0, "tile");
};

template <typename T, int D, int TR, int TC, int RPT, int KPT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt(const Params p) {
  using L = Tile<T, D, TR, TC, RPT, KPT>;
  constexpr int BR = L::BR, BK = L::BK, KCH = L::KCH, LDK = L::LDK,
                LDQ = L::LDQ, LDP = L::LDP, DPT = L::DPT, VEC = L::VEC;
  extern __shared__ __align__(128) unsigned char smem[];
  T* kv_s = reinterpret_cast<T*>(smem);                 // [2 buf][K, V][BK][LDK]
  float* q_s = reinterpret_cast<float*>(smem + L::KV_BYTES);  // [BR][LDQ]
  float* p_s = q_s + BR * LDQ;                          // [BR][LDP]
  float* m_s = p_s + BR * LDP;
  float* l_s = m_s + BR;
  float* c_s = l_s + BR;
  int* qp_s = reinterpret_cast<int*>(c_s + BR);
  __shared__ int range_s[2];

  const int tid = threadIdx.x, tr = tid / TC, tc = tid % TC;
  const int warp = tid / 32, lane = tid % 32;
  const int n_rows = p.S * p.HG;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BR;   // heaviest tiles first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const T* Q = static_cast<const T*>(p.q) + b * p.qsb + kvh * p.qsk;
  const T* Kb = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksk;
  const T* Vb = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsk;

  for (int i = tid; i < BR * D; i += kThreads) {
    const int r = i / D, d = i % D, rho = row0 + r;
    float x = 0.f;
    if (rho < n_rows)
      x = to_f(Q[(rho / p.HG) * p.qss + (rho % p.HG) * p.qsg + d]);
    q_s[r * LDQ + d] = x;
  }
  for (int r = tid; r < BR; r += kThreads) {
    qp_s[r] = query_pos(p, b, min(row0 + r, n_rows - 1) / p.HG);
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int qmin = INT_MAX, qmax = INT_MIN;
    for (int r = 0; r < BR && row0 + r < n_rows; ++r) {
      qmin = min(qmin, qp_s[r]);
      qmax = max(qmax, qp_s[r]);
    }
    key_range(p, qmin, qmax, range_s[0], range_s[1]);
  }
  __syncthreads();
  const int lo = range_s[0], hi = range_s[1];

  auto load_tile = [&](int k0, int buf) {
    constexpr int CPR = D / KCH;                 // 16 B chunks per row
    T* base = kv_s + buf * 2 * BK * LDK;
    for (int i = tid; i < 2 * BK * CPR; i += kThreads) {
      const int which = i / (BK * CPR), rem = i % (BK * CPR);
      const int j = rem / CPR, c = rem % CPR, t = k0 + j;
      const T* src = which ? Vb : Kb;
      const long long st = which ? p.vst : p.kst;
      const bool ok = t < hi;                    // zero-fill past the range
      cp_async16(base + (which * BK + j) * LDK + c * KCH,
                 ok ? src + t * st + c * KCH : src, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;

  if (lo < hi) load_tile(lo, 0);
  int buf = 0;
  for (int k0 = lo; k0 < hi; k0 += BK, buf ^= 1) {
    if (k0 + BK < hi) {
      load_tile(k0 + BK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = kv_s + buf * 2 * BK * LDK;
    const T* vs = ks + BK * LDK;

    // scores: rows tr + TR*i, keys tc + TC*j
    float sc[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float kk[KPT][4];
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        load_n<4>(ks + (tc + TC * j) * LDK + c, kk[j]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float qq[4];
        load_n<4>(q_s + (tr + TR * i) * LDQ + c, qq);
#pragma unroll
        for (int j = 0; j < KPT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[i][j] = fmaf(qq[e], kk[j][e], sc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int key = tc + TC * j, t = k0 + key;
      const int kp = t < hi ? key_pos(p, b, t) : -1;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = tr + TR * i;
        p_s[r * LDP + key] =
            visible(p, kp, qp_s[r]) ? sc[i][j] * p.scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < BR; r += kThreads / 32) {
      float* row = p_s + r * LDP;
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float e = expf(row[j] - m_safe);    // masked: exp(-inf) = 0
        row[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V: rows tr + TR*i, dims tc*VEC + TC*VEC*c + e
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float corr = c_s[tr + TR * i];
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] *= corr;
    }
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float pp[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        load_n<4>(p_s + (tr + TR * i) * LDP + j, pp[i]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const T* vrow = vs + (j + jj) * LDK + tc * VEC;
#pragma unroll
        for (int c = 0; c < DPT / VEC; ++c) {
          float vv[VEC];
          load_n<VEC>(vrow + TC * VEC * c, vv);
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][c * VEC + e] = fmaf(pp[i][jj], vv[e], acc[i][c * VEC + e]);
        }
      }
    }
    __syncthreads();
  }

  T* O = static_cast<T*>(p.o) + b * p.osb + kvh * p.osk;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = tr + TR * i, rho = row0 + r;
    if (rho >= n_rows) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* out = O + (rho / p.HG) * p.oss + (rho % p.HG) * p.osg;
#pragma unroll
    for (int c = 0; c < DPT / VEC; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store_f(out + tc * VEC + TC * VEC * c + e, acc[i][c * VEC + e] / l);
  }
}

// 64 query rows x 64 keys a tile.
template <typename T, int D>
cudaError_t launch_simt(const Params& p, cudaStream_t st) {
  using L = Tile<T, D, 16, 8, 4, 8>;
  auto kern = flash_fwd_simt<T, D, 16, 8, 4, 8>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S * p.HG + L::BR - 1) / L::BR, p.KV, p.B);
  kern<<<grid, kThreads, L::SMEM, st>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "tc": bf16 tensor cores (wgmma) for prefill
// ---------------------------------------------------------------------------

namespace tc {
constexpr int kRows = 128;       // rows per block: two warpgroups of 64
constexpr int kConsumers = 256;  // the two warpgroups (warps 0-7)
constexpr int kThreads = kConsumers + 32;   // warp 8: the TMA producer
constexpr int kKeys = 64;        // keys per K/V tile (N of S = Q K^T)
constexpr int kStages = 4;       // K/V tiles in the ring
constexpr int kPanel = 64;       // columns of a 128-byte swizzle panel
template <int D>
struct Smem {
  static constexpr int Q = kRows * D * 2;        // the block's Q tile
  static constexpr int KV = kKeys * D * 2;       // K or V of one key tile
  static constexpr int TOTAL = Q + kStages * 2 * KV + 1024;  // + alignment
};
}  // namespace tc

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}
// Returns once the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\nbra.uni LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity) : "memory");
}
// A box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wg::wgmma_rs_n64(d, a, db);
  else wg::wgmma_rs_n128(d, a, db);
}

template <int D>
__global__ void __launch_bounds__(tc::kThreads, 1)
flash_fwd_tc(const Params p, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, int kv_first) {
  using SM = tc::Smem<D>;
  constexpr int BM = tc::kRows, BK = tc::kKeys, CPR = D / 8;  // 16 B chunks
  constexpr int NO = D / 2, NS = BK / 2;   // accumulator floats per thread
  constexpr int S = tc::kStages, NP = D / tc::kPanel;  // panels of a tile
  static_assert(BK == 64 && D % tc::kPanel == 0, "tile");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int qp_s[BM];
  __shared__ int qrange_s[2];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  // every swizzle atom 1024-byte aligned
  unsigned char* q_s =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* kv_s = q_s + SM::Q;       // [stage][K, V][panel][BK][64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_rows = p.S * p.HG;
  // one flat grid, heaviest row tiles of every (kv head, batch row) first
  const int n_heads = p.KV * p.B, n_blk = (n_rows + BM - 1) / BM;
  const int row0 = (n_blk - 1 - (int)blockIdx.x / n_heads) * BM;
  const int kvh = (int)blockIdx.x % n_heads % p.KV;
  const int b = (int)blockIdx.x % n_heads / p.KV;

  if (tid == 0) {
    qrange_s[0] = INT_MAX;
    qrange_s[1] = INT_MIN;
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], tc::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Q: [BM][D] in 64-column panels of 128-byte rows, 16-byte chunk c of
  // row r at chunk c ^ (r % 8) (the 128-byte swizzle); rows past the last
  // are zero.
  if (tid < tc::kConsumers) {
    const __nv_bfloat16* Q =
        static_cast<const __nv_bfloat16*>(p.q) + b * p.qsb + kvh * p.qsk;
    for (int i = tid; i < BM * CPR; i += tc::kConsumers) {
      const int row = i / CPR, cc = i % CPR, c = cc & 7;
      const int rho = row0 + row;
      const bool ok = rho < n_rows;
      cp_async16(q_s + (cc >> 3) * BM * 128 + row * 128 +
                     ((c ^ (row & 7)) << 4),
                 ok ? Q + (rho / p.HG) * p.qss + (rho % p.HG) * p.qsg + cc * 8
                    : Q,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  }
  if (tid < BM)
    qp_s[tid] = query_pos(p, b, min(row0 + tid, n_rows - 1) / p.HG);
  __syncthreads();
  if (tid < BM) {
    const bool ok = row0 + tid < n_rows;
    const int mn = __reduce_min_sync(~0u, ok ? qp_s[tid] : INT_MAX);
    const int mx = __reduce_max_sync(~0u, ok ? qp_s[tid] : INT_MIN);
    if (lane == 0) {
      atomicMin(&qrange_s[0], mn);
      atomicMax(&qrange_s[1], mx);
    }
  }
  if (tid < tc::kConsumers) {
    cp_async_wait<0>();
    wg::fence_proxy_async();
  }
  __syncthreads();
  const int qmin = qrange_s[0], qmax = qrange_s[1];
  int lo, hi;
  key_range(p, qmin, qmax, lo, hi);
  const int n_tiles = (hi - lo + BK - 1) / BK;
  const auto stage = [&](int it) {
    return kv_s + (it % S) * 2 * SM::KV;
  };

  // the warpgroup index, made warp-uniform for the compiler (a divergent
  // path around wgmma would serialize it)
  const int wgi = __shfl_sync(~0u, tid / 128, 0);
  if (wgi == tc::kConsumers / 128) {
    // ---- producer: one thread keeps the ring full with TMA ----
    if (lane == 0) {
      for (int it = 0; it < n_tiles; ++it) {
        if (it >= S) mbar_wait(&empty[it % S], (it / S - 1) & 1);
        uint64_t* bar = &full[it % S];
        mbar_expect_tx(bar, 2 * SM::KV);
        unsigned char* dst = stage(it);
        const int k0 = lo + it * BK;
        const int c1 = kv_first ? kvh : k0, c2 = kv_first ? k0 : kvh;
#pragma unroll
        for (int pn = 0; pn < NP; ++pn) {
          tma_load_4d(dst + pn * BK * 128, &k_map, bar, pn * tc::kPanel, c1,
                      c2, b);
          tma_load_4d(dst + SM::KV + pn * BK * 128, &v_map, bar,
                      pn * tc::kPanel, c1, c2, b);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  // This thread's two rows in the block: r0 and r0 + 8 (wgmma's
  // accumulator layout: warp w of a warpgroup holds rows 16 w .. 16 w + 15).
  const int r0 = wgi * 64 + (warp & 3) * 16 + (lane >> 2);
  const int qp0 = qp_s[r0], qp1 = qp_s[r0 + 8];
  const float sl = p.scale * kLog2e;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const unsigned char* q_wg = q_s + wgi * 64 * 128;

  // P V of the previous tile, from the bf16 A fragments pa (keys 16 kk ..
  // 16 kk + 15 in pa[kk]) and V [BK][D] in panels, MN-major (keys are the
  // K dimension: 16 keys = 2048 bytes); issued, not waited for.
  uint32_t pa[BK / 16][4] = {};             // tile -1: P = 0
  auto issue_pv = [&](const unsigned char* vs) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], wg::desc_sw128(vs + 2048 * kk, BK * 128));
    wg::commit();
  };

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = lo + it * BK;
    mbar_wait(&full[it % S], (it / S) & 1);
    const unsigned char* ks = stage(it);

    // S = Q K^T: D / 16 k-steps of m64n64k16, both operands K-major in
    // 128-byte-swizzled panels (a k-step is 32 bytes into its panel)
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::wgmma_ss_n64(
          s, wg::desc_sw128(q_wg + (kk / 4) * BM * 128 + 32 * (kk % 4), 16),
          wg::desc_sw128(ks + (kk / 4) * BK * 128 + 32 * (kk % 4), 16),
          kk > 0);
    wg::commit();
    // on the first tile P = 0 and V is this tile's: adds nothing
    issue_pv(stage(it > 0 ? it - 1 : it) + SM::KV);
    wg::wait<1>();                         // S is done, P V may run on
    wg::fence_regs(s);

    // s[4 j + e] is (row r0, key k0 + 8 j + 2 (lane % 4) + e), s[4 j + 2 +
    // e] the same key for row r0 + 8.  Mask only where a key may be hidden.
    const bool full_tile = p.k_pos == nullptr && k0 + BK <= hi &&
                           (!p.causal || k0 + BK - 1 <= qmin) &&
                           (!p.window || k0 > qmax - p.window);
    if (!full_tile) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = k0 + 8 * j + 2 * (lane & 3) + e;
          const int kp = t < hi ? key_pos(p, b, t) : -1;
          if (!visible(p, kp, qp0)) s[4 * j + e] = -INFINITY;
          if (!visible(p, kp, qp1)) s[4 * j + 2 + e] = -INFINITY;
        }
    }

    // online softmax in registers: a row's 64 scores lie on 4 threads
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(~0u, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(~0u, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // m_safe: a row with no visible key so far stays finite
    const float base0 = mn0 == -INFINITY ? 0.f : mn0 * sl;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1 * sl;
    const float corr0 = m0 == -INFINITY ? 0.f : exp2f(m0 * sl - base0);
    const float corr1 = m1 == -INFINITY ? 0.f : exp2f(m1 * sl - base1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(fmaf(s[4 * j + e], sl, -base0));  // -inf -> 0
        s[4 * j + 2 + e] = exp2f(fmaf(s[4 * j + 2 + e], sl, -base1));
        sum0 += s[4 * j + e];
        sum1 += s[4 * j + 2 + e];
      }
    l0 = l0 * corr0 + sum0;                // this thread's part of the row
    l1 = l1 * corr1 + sum1;

    wg::wait<0>();                         // P_{it-1} V_{it-1} is in O
    wg::fence_regs(o);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }
  if (n_tiles > 0) {
    wg::fence();
    issue_pv(stage(n_tiles - 1) + SM::KV);
    wg::wait<0>();
    wg::fence_regs(o);
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(~0u, l0, off);
    l1 += __shfl_xor_sync(~0u, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.osb +
                     kvh * p.osk + 2 * (lane & 3);
  const int rho0 = row0 + r0, rho1 = rho0 + 8;
  __nv_bfloat16* out0 = O + (rho0 / p.HG) * p.oss + (rho0 % p.HG) * p.osg;
  __nv_bfloat16* out1 = O + (rho1 / p.HG) * p.oss + (rho1 % p.HG) * p.osg;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    if (rho0 < n_rows)
      *reinterpret_cast<uint32_t*>(out0 + 8 * j) =
          pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (rho1 < n_rows)
      *reinterpret_cast<uint32_t*>(out1 + 8 * j) =
          pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

// A tensor map over one of k, v ([B, T, KV, D] through its strides), in
// boxes of 64 keys x 64 columns with the 128-byte swizzle; keys past T
// read as 0.  Its dimensions go by increasing stride: (D, KV, T, B) when
// kv_first, else (D, T, KV, B).
cudaError_t key_map(CUtensorMap* map, const void* base, const Params& p,
                    int d, long long sb, long long st, long long sk,
                    int kv_first) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
  }
  const cuuint64_t t = p.T > 0 ? p.T : 1;   // no key: the map goes unread
  const cuuint64_t dims[4] = {(cuuint64_t)d, kv_first ? (cuuint64_t)p.KV : t,
                              kv_first ? t : (cuuint64_t)p.KV,
                              (cuuint64_t)p.B};
  const cuuint64_t strides[3] = {(cuuint64_t)(kv_first ? sk : st) * 2,
                                 (cuuint64_t)(kv_first ? st : sk) * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {tc::kPanel, kv_first ? 1u : (cuuint32_t)tc::kKeys,
                             kv_first ? (cuuint32_t)tc::kKeys : 1u, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_tc(const Params& p, cudaStream_t st) {
  CUtensorMap k_map, v_map;
  const int kv_first = p.ksk <= p.kst && p.vsk <= p.vst;
  cudaError_t err = key_map(&k_map, p.k, p, D, p.ksb, p.kst, p.ksk, kv_first);
  if (err != cudaSuccess) return err;
  err = key_map(&v_map, p.v, p, D, p.vsb, p.vst, p.vsk, kv_first);
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_tc<D>;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::Smem<D>::TOTAL);
  if (err != cudaSuccess) return err;
  const int blocks = (p.S * p.HG + tc::kRows - 1) / tc::kRows * p.KV * p.B;
  kern<<<blocks, tc::kThreads, tc::Smem<D>::TOTAL, st>>>(p, k_map, v_map,
                                                       kv_first);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "split": split-KV decode (flash-decoding) and its combine step
// ---------------------------------------------------------------------------

namespace split {
constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // keys in flight per thread group
constexpr int kMaxRows = 8;      // S * HG of a split call
template <typename T, int D, int R>
struct Shape {
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per load
  static constexpr int TPK = D / VEC;              // threads per key
  static constexpr int G = kThreads / TPK;         // key groups per block
  static constexpr int SMEM = G * R * (D + 2) * (int)sizeof(float);
  static_assert(TPK >= 1 && TPK <= 32 && D % VEC == 0, "head dim");
};
}  // namespace split

// Partials: for each (b, kv head, chunk) n_rows records of D + 2 floats,
// (m, l, acc[D]), m in log2 units of the scaled scores.
template <typename T, int D, int R>
__global__ void __launch_bounds__(split::kThreads)
flash_fwd_split(const Params p, float* part, int n_split) {
  using SH = split::Shape<T, D, R>;
  constexpr int VEC = SH::VEC, TPK = SH::TPK, G = SH::G, U = split::kUnroll;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ml_s = reinterpret_cast<float*>(smem);    // m [G][R], l [G][R]
  float* acc_s = ml_s + 2 * G * R;                 // acc [G][R][D]

  const int tid = threadIdx.x, gi = tid / TPK, li = tid % TPK;
  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = p.S * p.HG;
  const T* Q = static_cast<const T*>(p.q) + b * p.qsb + kvh * p.qsk;
  const T* Kb = static_cast<const T*>(p.k) + b * p.ksb + kvh * p.ksk +
                li * VEC;
  const T* Vb = static_cast<const T*>(p.v) + b * p.vsb + kvh * p.vsk +
                li * VEC;
  const float sl = p.scale * kLog2e;

  float q[R][VEC];
  int qp[R];
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    qp[r] = 0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) q[r][e] = 0.f;
    if (r < n_rows) {
      const int s = r / p.HG;
      unpack16(*reinterpret_cast<const uint4*>(
                   Q + s * p.qss + (r % p.HG) * p.qsg + li * VEC),
               q[r]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) q[r][e] *= sl;
      qp[r] = query_pos(p, b, s);
      qmin = min(qmin, qp[r]);
      qmax = max(qmax, qp[r]);
    }
  }
  int lo, hi;
  key_range(p, qmin, qmax, lo, hi);
  const int len = (hi - lo + n_split - 1) / n_split;
  const int c0 = min(hi, lo + chunk * len), c1 = min(hi, c0 + len);

  float m[R], l[R], acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }
  // every thread runs the same number of steps (the shuffles need the
  // whole warp); group gi takes keys base + gi * U .. + U - 1
  for (int base = c0; base < c1; base += G * U) {
    uint4 kr[U], vr[U];
    int kp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + gi * U + u;
      const bool ok = t < c1;
      kr[u] = ok ? *reinterpret_cast<const uint4*>(Kb + t * p.kst)
                 : make_uint4(0, 0, 0, 0);
      vr[u] = ok ? *reinterpret_cast<const uint4*>(Vb + t * p.vst)
                 : make_uint4(0, 0, 0, 0);
      kp[u] = ok ? key_pos(p, b, t) : -1;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= n_rows) break;
      float sc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kf[VEC];
        unpack16(kr[u], kf);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot = fmaf(q[r][e], kf[e], dot);
#pragma unroll
        for (int off = TPK / 2; off; off >>= 1)
          dot += __shfl_xor_sync(~0u, dot, off);
        sc[u] = visible(p, kp[u], qp[r]) ? dot : -INFINITY;
      }
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u]);
      if (mx == -INFINITY) continue;       // nothing visible yet
      const float corr = exp2f(m[r] - mx);  // m = -inf: 0
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pu = exp2f(sc[u] - mx);
        float vf[VEC];
        unpack16(vr[u], vf);
        l[r] += pu;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(pu, vf[e], acc[r][e]);
      }
    }
  }

  // merge the G groups in group order
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (li == 0) {
      ml_s[gi * R + r] = m[r];
      ml_s[(G + gi) * R + r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc_s[(gi * R + r) * D + li * VEC + e] = acc[r][e];
  }
  __syncthreads();
  float* out = part + ((long long)(b * p.KV + kvh) * n_split + chunk) *
                          n_rows * (D + 2);
  for (int i = tid; i < n_rows * D; i += split::kThreads) {
    const int r = i / D, d = i % D;
    float mx = -INFINITY;
    for (int g = 0; g < G; ++g) mx = fmaxf(mx, ml_s[g * R + r]);
    float lsum = 0.f, a = 0.f;
    for (int g = 0; g < G; ++g) {
      const float mg = ml_s[g * R + r];
      const float w = mg == -INFINITY ? 0.f : exp2f(mg - mx);
      lsum = fmaf(w, ml_s[(G + g) * R + r], lsum);
      a = fmaf(w, acc_s[(g * R + r) * D + d], a);
    }
    out[r * (D + 2) + 2 + d] = a;
    if (d == 0) {
      out[r * (D + 2)] = mx;
      out[r * (D + 2) + 1] = lsum;
    }
  }
}

// One thread per (row, column) of a (KV head, batch row): merges the
// n_split partials of its row in chunk order and writes acc / max(l,
// 1e-30) in the output type.
template <typename T, int D>
__global__ void __launch_bounds__(128)
flash_fwd_combine(const Params p, const float* part, int n_split) {
  const int kvh = blockIdx.y, b = blockIdx.z, n_rows = p.S * p.HG;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows * D) return;
  const float* in = part + (long long)(b * p.KV + kvh) * n_split * n_rows *
                               (D + 2);
  T* O = static_cast<T*>(p.o) + b * p.osb + kvh * p.osk;
  const int r = i / D, d = i % D;
  float mx = -INFINITY;
  for (int c = 0; c < n_split; ++c)
    mx = fmaxf(mx, in[(c * n_rows + r) * (D + 2)]);
  float lsum = 0.f, a = 0.f;
  for (int c = 0; c < n_split; ++c) {
    const float* rec = in + (c * n_rows + r) * (D + 2);
    const float w = rec[0] == -INFINITY ? 0.f : exp2f(rec[0] - mx);
    lsum = fmaf(w, rec[1], lsum);
    a = fmaf(w, rec[2 + d], a);
  }
  store_f(O + (r / p.HG) * p.oss + (r % p.HG) * p.osg + d,
          a / fmaxf(lsum, 1e-30f));
}

template <typename T, int D>
cudaError_t launch_combine(const Params& p, const float* part, int n_split,
                           cudaStream_t st) {
  const int n = p.S * p.HG * D;
  flash_fwd_combine<T, D><<<dim3((n + 127) / 128, p.KV, p.B), 128, 0, st>>>(
      p, part, n_split);
  return cudaGetLastError();
}

template <typename T, int D, int R>
cudaError_t launch_split_rows(const Params& p, float* part, int n_split,
                              cudaStream_t st) {
  using SH = split::Shape<T, D, R>;
  auto kern = flash_fwd_split<T, D, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SH::SMEM);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_split, p.KV, p.B), split::kThreads, SH::SMEM, st>>>(
      p, part, n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<T, D>(p, part, n_split, st);
}

template <typename T, int D>
cudaError_t launch_split(const Params& p, float* part, int n_split,
                         cudaStream_t st) {
  const int rows = p.S * p.HG;
  if (rows > split::kMaxRows || n_split < 1 || part == nullptr)
    return cudaErrorInvalidValue;
  if (rows <= 2) return launch_split_rows<T, D, 2>(p, part, n_split, st);
  return launch_split_rows<T, D, split::kMaxRows>(p, part, n_split, st);
}

// ---------------------------------------------------------------------------
// "split_tc": split-KV on the tensor cores for 9..63 rows (MQA decode)
// ---------------------------------------------------------------------------

namespace stc {
constexpr int kRows = 64;        // one warpgroup's rows
constexpr int kThreads = 128;    // that warpgroup
constexpr int kKeys = 64;        // keys per K/V tile (N of S = Q K^T)
constexpr int kStages = 2;       // the cp.async double buffer
template <int D>
struct Smem {
  static constexpr int Q = kRows * D * 2;        // the block's Q tile
  static constexpr int KV = kKeys * D * 2;       // K or V of one key tile
  static constexpr int TOTAL = Q + kStages * 2 * KV + 1024;  // + alignment
};
}  // namespace stc

// Partials as flash_fwd_split writes them (m in log2 units of the scaled
// scores), for chunk blockIdx.x of whole 64-key tiles.
template <int D>
__global__ void __launch_bounds__(stc::kThreads)
flash_fwd_split_tc(const Params p, float* part, int n_split) {
  using SM = stc::Smem<D>;
  constexpr int BM = stc::kRows, BK = stc::kKeys, CPR = D / 8;  // 16 B chunks
  constexpr int NO = D / 2, NS = BK / 2;   // accumulator floats per thread
  static_assert(BK == 64 && D % 64 == 0, "tile");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int qp_s[BM];
  __shared__ int kp_s[stc::kStages][BK];
  // every swizzle atom 1024-byte aligned
  unsigned char* q_s =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* kv_s = q_s + SM::Q;   // [stage][K, V][panel][BK][64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = p.S * p.HG;
  using bf16 = __nv_bfloat16;
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.qsb + kvh * p.qsk;
  const bf16* Kb = static_cast<const bf16*>(p.k) + b * p.ksb + kvh * p.ksk;
  const bf16* Vb = static_cast<const bf16*>(p.v) + b * p.vsb + kvh * p.vsk;

  // Q: [BM][D] in 64-column panels of 128-byte rows, 16-byte chunk c of
  // row r at chunk c ^ (r % 8); rows past the last are zero.  Committed
  // with the first K/V tile.
  for (int i = tid; i < BM * CPR; i += stc::kThreads) {
    const int row = i / CPR, cc = i % CPR, c = cc & 7;
    const bool ok = row < n_rows;
    cp_async16(q_s + (cc >> 3) * BM * 128 + row * 128 + ((c ^ (row & 7)) << 4),
               ok ? Q + (row / p.HG) * p.qss + (row % p.HG) * p.qsg + cc * 8
                  : Q,
               ok ? 16 : 0);
  }
  if (tid < BM) qp_s[tid] = query_pos(p, b, min(tid, n_rows - 1) / p.HG);
  __syncthreads();
  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = 0; r < n_rows; ++r) {
    qmin = min(qmin, qp_s[r]);
    qmax = max(qmax, qp_s[r]);
  }
  int lo, hi;
  key_range(p, qmin, qmax, lo, hi);
  const int len = ((hi - lo + n_split - 1) / n_split + BK - 1) / BK * BK;
  const int c0 = min(hi, lo + chunk * len), c1 = min(hi, c0 + len);
  const int n_tiles = (c1 - c0 + BK - 1) / BK;

  // K and V of tile `it` into stage `st` (the 128-byte-swizzle layout TMA
  // writes in "tc"), and its keys' positions (-1 past the chunk)
  const auto load_tile = [&](int it, int st) {
    const int k0 = c0 + it * BK;
    unsigned char* dst = kv_s + st * 2 * SM::KV;
    for (int i = tid; i < 2 * BK * CPR; i += stc::kThreads) {
      const int which = i / (BK * CPR), rem = i % (BK * CPR);
      const int j = rem / CPR, cc = rem % CPR, c = cc & 7, t = k0 + j;
      const bool ok = t < c1;
      const bf16* src = which ? Vb : Kb;
      const long long stride = which ? p.vst : p.kst;
      cp_async16(dst + which * SM::KV + (cc >> 3) * BK * 128 + j * 128 +
                     ((c ^ (j & 7)) << 4),
                 ok ? src + t * stride + cc * 8 : src, ok ? 16 : 0);
    }
    if (tid < BK) kp_s[st][tid] = k0 + tid < c1 ? key_pos(p, b, k0 + tid) : -1;
    cp_async_commit();
  };

  // This thread's two rows: r0 and r0 + 8 (wgmma's accumulator layout).
  const int r0 = warp * 16 + (lane >> 2);
  const int qp0 = qp_s[r0], qp1 = qp_s[r0 + 8];
  const float sl = p.scale * kLog2e;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if (n_tiles > 0) load_tile(0, 0);
  else cp_async_commit();                  // Q alone
  if (n_tiles > 1) load_tile(1, 1);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) cp_async_wait<1>();
    else cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();
    const int st = it & 1;
    const unsigned char* ks = kv_s + st * 2 * SM::KV;
    const unsigned char* vs = ks + SM::KV;

    // S = Q K^T: D / 16 k-steps of m64n64k16, both operands K-major
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg::wgmma_ss_n64(
          s, wg::desc_sw128(q_s + (kk / 4) * BM * 128 + 32 * (kk % 4), 16),
          wg::desc_sw128(ks + (kk / 4) * BK * 128 + 32 * (kk % 4), 16),
          kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(s);

    // s[4 j + e] is (row r0, key 8 j + 2 (lane % 4) + e of the tile),
    // s[4 j + 2 + e] the same key for row r0 + 8
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = kp_s[st][8 * j + 2 * (lane & 3) + e];
        if (!visible(p, kp, qp0)) s[4 * j + e] = -INFINITY;
        if (!visible(p, kp, qp1)) s[4 * j + 2 + e] = -INFINITY;
      }

    // online softmax in registers: a row's 64 scores lie on 4 threads
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(~0u, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(~0u, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float base0 = mn0 == -INFINITY ? 0.f : mn0 * sl;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1 * sl;
    const float corr0 = m0 == -INFINITY ? 0.f : exp2f(m0 * sl - base0);
    const float corr1 = m1 == -INFINITY ? 0.f : exp2f(m1 * sl - base1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(fmaf(s[4 * j + e], sl, -base0));  // -inf -> 0
        s[4 * j + 2 + e] = exp2f(fmaf(s[4 * j + 2 + e], sl, -base1));
        sum0 += s[4 * j + e];
        sum1 += s[4 * j + 2 + e];
      }
    l0 = l0 * corr0 + sum0;                // this thread's part of the row
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    // O += P V: V [BK][D] in panels, MN-major (16 keys = 2048 bytes)
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], wg::desc_sw128(vs + 2048 * kk, BK * 128));
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(o);
    __syncthreads();                       // the stage is free again
    if (it + 2 < n_tiles) load_tile(it + 2, st);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(~0u, l0, off);
    l1 += __shfl_xor_sync(~0u, l1, off);
  }
  float* out = part + ((long long)(b * p.KV + kvh) * n_split + chunk) *
                          n_rows * (D + 2);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= n_rows) continue;
    float* rec = out + r * (D + 2);
    const float m = h ? m1 : m0;
    if ((lane & 3) == 0) {
      rec[0] = m == -INFINITY ? -INFINITY : m * sl;
      rec[1] = h ? l1 : l0;
    }
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      *reinterpret_cast<float2*>(rec + 2 + 8 * j + col) =
          make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
  }
}

template <int D>
cudaError_t launch_split_tc(const Params& p, float* part, int n_split,
                            cudaStream_t st) {
  if (p.S * p.HG > stc::kRows || n_split < 1 || part == nullptr)
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_split_tc<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, stc::Smem<D>::TOTAL);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_split, p.KV, p.B), stc::kThreads, stc::Smem<D>::TOTAL, st>>>(
      p, part, n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<__nv_bfloat16, D>(p, part, n_split, st);
}

// ---------------------------------------------------------------------------

enum Variant { kSimt = 0, kTc = 1, kSplit = 2, kSplitTc = 3 };

template <typename T, int D>
cudaError_t dispatch_variant(int variant, const Params& p, float* part,
                             int n_split, cudaStream_t st) {
  switch (variant) {
    case kSimt: return launch_simt<T, D>(p, st);
    case kSplit: return launch_split<T, D>(p, part, n_split, st);
    case kTc:
      if constexpr (sizeof(T) == 2 && (D == 64 || D == 128))
        return launch_tc<D>(p, st);
      return cudaErrorInvalidValue;
    case kSplitTc:
      if constexpr (sizeof(T) == 2 && (D == 64 || D == 128))
        return launch_split_tc<D>(p, part, n_split, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dim(int d, int variant, const Params& p, float* part,
                         int n_split, cudaStream_t st) {
  switch (d) {
    case 16: return dispatch_variant<T, 16>(variant, p, part, n_split, st);
    case 32: return dispatch_variant<T, 32>(variant, p, part, n_split, st);
    case 64: return dispatch_variant<T, 64>(variant, p, part, n_split, st);
    case 128: return dispatch_variant<T, 128>(variant, p, part, n_split, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* flash_attn_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}

// variant 0 = simt, 1 = tc (bfloat16, D 64 or 128), 2 = split (S*HG <= 8),
// 3 = split_tc (bfloat16, D 64 or 128, S*HG <= 64); for 2 and 3 `scratch`
// holds B*KV*n_split*S*HG*(D+2) floats; dtype 0 = float32,
// 1 = bfloat16; strides (in elements) in the order q (b, s, kv, g),
// k (b, t, kv), v (b, t, kv), out (b, s, kv, g), q_pos (b, s),
// k_pos (b, t).  Returns 0 or the cudaError_t of the launch.
extern "C" int flash_attn_launch(int variant, int dtype, int head_dim, int B,
                                 int S, int T, int KV, int HG, const void* q,
                                 const void* k, const void* v, void* o,
                                 const int32_t* q_pos, const int32_t* k_pos,
                                 const long long* strides, int causal,
                                 int window, float scale, float* scratch,
                                 int n_split, void* stream) {
  Params p{q, k, v, o, q_pos, k_pos, B, S, T, KV, HG,
           strides[0], strides[1], strides[2], strides[3],
           strides[4], strides[5], strides[6],
           strides[7], strides[8], strides[9],
           strides[10], strides[11], strides[12], strides[13],
           strides[14], strides[15], strides[16], strides[17],
           causal, window, scale};
  if (B == 0 || S == 0 || KV == 0 || HG == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      dtype == 0 ? dispatch_dim<float>(head_dim, variant, p, scratch,
                                       n_split, st)
      : dtype == 1 ? dispatch_dim<__nv_bfloat16>(head_dim, variant, p,
                                                 scratch, n_split, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
