// flash_attention for Hopper (sm_90a): FA-2 forward with online softmax,
// grouped-query heads, causal and sliding-window masks, and per-key
// positions (padding keys at a negative position, ring-buffer caches).
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
// Layout.  The kernel takes element strides, so it reads the model's own
// layouts in place: q and out [B, S, KV, HG, D] (HG query heads share one
// KV head), k and v [B, T, KV, D] (one layer of the KV cache), positions
// q_pos [B, S] and k_pos [B, T].  A null q_pos (k_pos) means position s
// (t); with a null k_pos a causal block stops at its last visible key tile
// and a windowed block starts at its first.
//
// Grid: one block of 128 threads per (query-row tile, KV head, batch).  A
// tile's rows are the flattened (query position, head in group) pairs, so
// each K/V tile is read once for the whole group (the TPU kernel re-reads
// it per head).  A loop over 64-key tiles replaces the sequential `ki`
// grid axis; cp.async double-buffers the K/V tiles in shared memory (in
// the input type), the query tile sits in shared memory as f32.  Per key
// tile: scores (each thread an RPT x KPT register tile), then one warp per
// row updates m and l and turns the scores into probabilities in shared
// memory, then each thread updates its RPT x D/TC slice of the
// accumulator.  Three shapes of tile, chosen by the rows S*HG a block
// column has: 64 rows (prefill), 8 rows, and 2 rows for D >= 64 (decode:
// S = 1, so the rows are the group's heads).
//
// Bound on this card.  Prefill (S = T, causal) is bound by operations:
// 4*D flops per visible (query head, key) pair, 17.2 GFLOP at S = T = 2048,
// H = 16, D = 128, 0.017 ms at the bf16 tensor-core rate.  This kernel
// runs on the CUDA cores in f32 (no mma/wgmma yet), so it is far above
// that bound; the tensor cores are later work.  Decode (S = 1) is bound by
// bytes: every visible K/V row is read once (134 MB at B = 8, T = 4096,
// KV = 8, D = 128 bf16, 0.040 ms at 3.35 TB/s).  B*KV blocks (64 for
// qwen3-0.6b at B = 8) leave half of the 132 SMs idle; splitting T
// across blocks (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 128;

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
flash_fwd(const Params p) {
  using L = Tile<T, D, TR, TC, RPT, KPT>;
  constexpr int BR = L::BR, BK = L::BK, KCH = L::KCH, LDK = L::LDK,
                LDQ = L::LDQ, LDP = L::LDP, DPT = L::DPT, VEC = L::VEC;
  extern __shared__ __align__(16) unsigned char smem[];
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
    const int s = min(row0 + r, n_rows - 1) / p.HG;
    qp_s[r] = p.q_pos ? p.q_pos[b * p.qpb + s * p.qps] : s;
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = 0, hi = p.T;
    if (p.k_pos == nullptr) {         // key t sits at position t
      int qmin = INT_MAX, qmax = INT_MIN;
      for (int r = 0; r < BR && row0 + r < n_rows; ++r) {
        qmin = min(qmin, qp_s[r]);
        qmax = max(qmax, qp_s[r]);
      }
      if (p.causal) hi = min(hi, qmax + 1);
      if (p.window) lo = max(lo, qmin - p.window + 1);
    }
    range_s[0] = lo;
    range_s[1] = max(lo, hi);
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
      const int kp = p.k_pos ? (t < hi ? p.k_pos[b * p.kpb + t * p.kpt] : -1)
                             : t;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = tr + TR * i, qp = qp_s[r];
        const bool ok = t < hi && kp >= 0 && (!p.causal || kp <= qp) &&
                        (!p.window || kp > qp - p.window);
        p_s[r * LDP + key] = ok ? sc[i][j] * p.scale : -INFINITY;
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

template <typename T, int D, int TR, int TC, int RPT, int KPT>
cudaError_t launch(const Params& p, cudaStream_t st) {
  using L = Tile<T, D, TR, TC, RPT, KPT>;
  auto kern = flash_fwd<T, D, TR, TC, RPT, KPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S * p.HG + L::BR - 1) / L::BR, p.KV, p.B);
  kern<<<grid, kThreads, L::SMEM, st>>>(p);
  return cudaGetLastError();
}

// Tile shape by the rows S*HG of a block column: 64 rows x 64 keys, 8 x 64,
// or (decode with D >= 64) 2 x 64.
template <typename T, int D>
cudaError_t dispatch_rows(const Params& p, cudaStream_t st) {
  const int rows = p.S * p.HG;
  if constexpr (D >= 64) {
    if (rows <= 2) return launch<T, D, 2, 64, 1, 1>(p, st);
  }
  if (rows <= 8) return launch<T, D, 8, 16, 1, 4>(p, st);
  return launch<T, D, 16, 8, 4, 8>(p, st);
}

template <typename T>
cudaError_t dispatch_dim(int d, const Params& p, cudaStream_t st) {
  switch (d) {
    case 16: return dispatch_rows<T, 16>(p, st);
    case 32: return dispatch_rows<T, 32>(p, st);
    case 64: return dispatch_rows<T, 64>(p, st);
    case 128: return dispatch_rows<T, 128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* flash_attn_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}

// dtype 0 = float32, 1 = bfloat16; strides (in elements) in the order
// q (b, s, kv, g), k (b, t, kv), v (b, t, kv), out (b, s, kv, g),
// q_pos (b, s), k_pos (b, t).  Returns 0 or the cudaError_t of the launch.
extern "C" int flash_attn_launch(int dtype, int head_dim, int B, int S, int T,
                                 int KV, int HG, const void* q, const void* k,
                                 const void* v, void* o, const int32_t* q_pos,
                                 const int32_t* k_pos,
                                 const long long* strides, int causal,
                                 int window, float scale, void* stream) {
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
      dtype == 0 ? dispatch_dim<float>(head_dim, p, st)
      : dtype == 1 ? dispatch_dim<__nv_bfloat16>(head_dim, p, st)
                   : cudaErrorInvalidValue;
  return (int)err;
}
