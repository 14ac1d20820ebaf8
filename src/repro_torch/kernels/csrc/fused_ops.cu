// The small fused ops of the decode step and the prefill, for sm_90a:
// RMSNorm, alone or with the residual add before it, SwiGLU on the fused
// gate-up row, and RoPE with the cache write, for one decode token and
// for a whole prefill.
//
// No Pallas kernel of the JAX package stands behind these: there XLA fuses
//   src/repro/models/layers.py:26      rmsnorm, with the residual adds of
//   src/repro/models/model.py:284      the layer body
//   src/repro/models/mlp.py:37         mlp_forward (silu(g) * u)
//   src/repro/models/layers.py:51      apply_rope, with
//   src/repro/models/attention.py:297  kv_cache_write (decode) and
//   src/repro/models/model.py:722      _write_prefill_kv (prefill)
// inside the jitted megastep and prefill. Eagerly, each op above is a
// handful of PyTorch launches of a few microseconds apiece; one decode
// step ran some 80 of them a layer. Each kernel here is one launch.
//
// Bound: bytes. Each kernel reads its inputs once and writes its outputs
// once with a few operations an element, far below the line where the
// arithmetic would bound it. Design against that bound and the launch
// count: one pass, 16-byte loads and stores where the width allows (8
// elements a thread), reductions by warp shuffles, and no intermediate in
// device memory: the residual sum h is written once and normalized from
// registers (add + norm move 4 rows of d, where the separate add and norm
// moved 5); the prefill RoPE forms each cos/sin once for the G + 1 heads
// that use it and writes q, k, v and the cache rows in one pass.
//
// Numerics follow the plain PyTorch versions in kernels/fused_ops.py, op
// for op, with every product and sum rounded on its own (the _rn
// intrinsics keep nvcc from contracting them into FMAs): RMSNorm and
// SwiGLU compute in f32 and round once to the output's type, and the
// residual sum rounds once to x's type; RoPE rounds the rotated row to
// bf16, and the quantized caches quantize that bf16 row as
// quant.quantize_rows does (scale = amax * (1 / qmax), a zero scale taken
// as 1, payload = clamp(rint(x / scale)) with an f32 division, scales
// stored as bf16). Only the sum of squares of RMSNorm is taken in another
// order than PyTorch's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // RMSNorm and SwiGLU
constexpr int kResident = 4;       // RMSNorm: runs a thread keeps in registers
constexpr int kRopeThreads = 128;  // RoPE + cache write (decode and prefill)
constexpr int kVec = 8;            // elements a thread loads at once

enum CacheFormat { kBf16 = 0, kQ8 = 1, kQ4 = 2 };

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// N elements at p (N == 1, or N == kVec with p 16-byte aligned) as f32
template <int N>
__device__ __forceinline__ void load(const bf16* p, float* f) {
  if constexpr (N == kVec) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
    f[0] = __bfloat162float(p[0]);
  }
}

template <int N>
__device__ __forceinline__ void load(const float* p, float* f) {
  if constexpr (N == kVec) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    f[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void store(bf16* p, const float* f) {
  if constexpr (N == kVec) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    p[0] = __float2bfloat16(f[0]);
  }
}

template <int N>
__device__ __forceinline__ void store(float* p, const float* f) {
  if constexpr (N == kVec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  } else {
    p[0] = f[0];
  }
}

// the sum of v over the CTA, returned to every thread
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f32 v as a store to T rounds it (round to nearest even)
template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
template <>
__device__ __forceinline__ float rounded<float>(float v) {
  return v;
}

// One CTA a row of d: out = TX(x * rsqrt(mean(x^2) + eps) * w), in f32.
// ADD: the row is first h = TX(x + delta), the f32 sum rounded once as
// PyTorch's add rounds it; h is written beside out. A thread takes the
// runs of N elements at (threadIdx.x + c * kThreads) * N, c = 0, 1, ...
// (N == kVec: 16-byte loads, d % 8 == 0, rows aligned), and sums their
// squares in that order, whatever RESIDENT is. RESIDENT (d <= kResident *
// kThreads * N): the row stays in registers between the sum and the
// scaling, so it is read once; else the scaling pass reads it again (h,
// under ADD, from where this thread wrote it).
template <typename TX, typename TW, int N, bool RESIDENT, bool ADD>
__device__ __forceinline__ void rmsnorm_row(const TX* __restrict__ x, const TX* __restrict__ delta,
                                            const TW* __restrict__ w, TX* h,
                                            TX* __restrict__ out, int d, float eps) {
  const size_t row = (size_t)blockIdx.x * d;
  constexpr int C = RESIDENT ? kResident : 1;
  float f[C][N];
  float ss = 0.f;
  auto take = [&](int i, float(&v)[N]) {  // the run at i of the row (of h under ADD)
    load<N>(x + row + i, v);
    if constexpr (ADD) {
      float e[N];
      load<N>(delta + row + i, e);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = rounded<TX>(__fadd_rn(v[j], e[j]));
      store<N>(h + row + i, v);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
  };
  auto scale = [&](int i, float(&v)[N], float r) {
    float g[N];
    load<N>(w + i, g);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = __fmul_rn(__fmul_rn(v[j], r), g[j]);
    store<N>(out + row + i, v);
  };
  if constexpr (RESIDENT) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = (threadIdx.x + c * kThreads) * N;
      if (i < d) take(i, f[c]);
    }
  } else {
    for (int i = threadIdx.x * N; i < d; i += kThreads * N) take(i, f[0]);
  }
  const float var = __fdiv_rn(block_sum(ss), (float)d);
  const float r = rsqrtf(__fadd_rn(var, eps));
  if constexpr (RESIDENT) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = (threadIdx.x + c * kThreads) * N;
      if (i < d) scale(i, f[c], r);
    }
  } else {
    for (int i = threadIdx.x * N; i < d; i += kThreads * N) {
      load<N>((ADD ? h : x) + row + i, f[0]);
      scale(i, f[0], r);
    }
  }
}

template <typename TX, typename TW, int N, bool RESIDENT>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                   int d, float eps) {
  rmsnorm_row<TX, TW, N, RESIDENT, false>(x, nullptr, w, nullptr, out, d, eps);
}

template <typename TX, typename TW, int N, bool RESIDENT>
__global__ void __launch_bounds__(kThreads)
    add_rmsnorm_kernel(const TX* __restrict__ x, const TX* __restrict__ delta,
                       const TW* __restrict__ w, TX* h, TX* __restrict__ out, int d, float eps) {
  rmsnorm_row<TX, TW, N, RESIDENT, true>(x, delta, w, h, out, d, eps);
}

// out[m, j] = silu(gu[m, j]) * gu[m, F + j] in f32, rounded once; the two
// halves are read in place. CTA (row m, run of kThreads * N columns).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    swiglu_kernel(const T* __restrict__ gu, T* __restrict__ out, int F) {
  const int j = (blockIdx.y * kThreads + threadIdx.x) * N;
  if (j >= F) return;
  const T* g = gu + (size_t)blockIdx.x * 2 * F + j;
  float a[N], b[N];
  load<N>(g, a);
  load<N>(g + F, b);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float s = __fdiv_rn(a[i], __fadd_rn(1.f, expf(-a[i])));
    a[i] = __fmul_rn(s, b[i]);
  }
  store<N>(out + (size_t)blockIdx.x * F + j, a);
}

// RoPE of one token's fused-QKV row, and its K/V write into the cache.
// CTA (kv head h, slot b): ropes the G query heads of h (out to q_out) and
// K head h at position lens[b] (half-split rotation, cos/sin of pos *
// freq, freq = 1 / theta^(2i * (1/D))), and writes K and V into ring slot
// lens[b] % S of (b, h) when advance[b] (always when advance is null);
// other rows' cache is not touched. The quantized formats stage the bf16
// K and V rows in shared memory, take one scale per group of g = D / ng
// features, and write the int8 payload (q4_0: nibble pairs, low nibble =
// even feature).
template <int FMT>
__global__ void __launch_bounds__(kRopeThreads)
    rope_cache_write_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ q_out,
                            void* __restrict__ k_cache, void* __restrict__ v_cache,
                            bf16* __restrict__ k_scale, bf16* __restrict__ v_scale,
                            const int* __restrict__ lens,
                            const unsigned char* __restrict__ advance, int G, int S, int D,
                            int ng, float theta) {
  extern __shared__ float rows[];  // quantized formats: K row, V row (D each), 2 * ng scales
  const int h = blockIdx.x, b = blockIdx.y, Hkv = gridDim.x;
  const int half = D / 2, Hq = Hkv * G;
  const bf16* src = qkv + (size_t)b * (Hq + 2 * Hkv) * D;
  const int pos = lens[b];
  const bool adv = advance == nullptr || advance[b] != 0;
  const size_t cache_row = ((size_t)b * Hkv + h) * S + pos % S;
  const float inv_d = __fdiv_rn(1.f, (float)D);
  for (int idx = threadIdx.x; idx < (G + 1) * half; idx += kRopeThreads) {
    const int hh = idx / half, i = idx - hh * half;
    const float freq = __fdiv_rn(1.f, powf(theta, __fmul_rn((float)(2 * i), inv_d)));
    const float ang = __fmul_rn((float)pos, freq);
    const float c = cosf(ang), s = sinf(ang);
    const bf16* xs = src + (hh < G ? (h * G + hh) * D : (Hq + h) * D);
    const float x1 = to_f(xs[i]), x2 = to_f(xs[i + half]);
    const bf16 o1 = __float2bfloat16(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    const bf16 o2 = __float2bfloat16(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
    if (hh < G) {
      bf16* qo = q_out + ((size_t)b * Hq + h * G + hh) * D;
      qo[i] = o1;
      qo[i + half] = o2;
    } else if (FMT == kBf16) {
      if (adv) {
        bf16* ko = static_cast<bf16*>(k_cache) + cache_row * D;
        ko[i] = o1;
        ko[i + half] = o2;
      }
    } else {
      rows[i] = to_f(o1);
      rows[i + half] = to_f(o2);
    }
  }
  const bf16* vs = src + (Hq + Hkv + h) * D;
  if (FMT == kBf16) {
    if (adv)
      for (int i = threadIdx.x; i < D; i += kRopeThreads)
        static_cast<bf16*>(v_cache)[cache_row * D + i] = vs[i];
    return;
  }
  if (!adv) return;  // uniform over the CTA: no thread reaches a barrier
  for (int i = threadIdx.x; i < D; i += kRopeThreads) rows[D + i] = to_f(vs[i]);
  __syncthreads();
  // groups 0 .. ng-1 of K, then ng .. 2ng-1 of V: rows[j * g ...]
  const int g = D / ng;
  const float qmax = FMT == kQ8 ? 127.f : 7.f;
  float* scales = rows + 2 * D;
  for (int j = threadIdx.x; j < 2 * ng; j += kRopeThreads) {
    float amax = 0.f;
    for (int t = 0; t < g; ++t) amax = fmaxf(amax, fabsf(rows[j * g + t]));
    float sc = __fmul_rn(amax, __fdiv_rn(1.f, qmax));
    if (sc == 0.f) sc = 1.f;
    scales[j] = sc;
    (j < ng ? k_scale : v_scale)[cache_row * ng + j % ng] = __float2bfloat16(sc);
  }
  __syncthreads();
  auto quant = [&](int i) {  // element i of the staged K|V rows
    const float q = rintf(__fdiv_rn(rows[i], scales[i / g]));
    return (int)fminf(fmaxf(q, -qmax), qmax);
  };
  if (FMT == kQ8) {
    for (int i = threadIdx.x; i < 2 * D; i += kRopeThreads) {
      int8_t* dst = static_cast<int8_t*>(i < D ? k_cache : v_cache);
      dst[cache_row * D + i % D] = (int8_t)quant(i);
    }
  } else {
    for (int p = threadIdx.x; p < D; p += kRopeThreads) {  // D / 2 pairs of K, then of V
      const int e = 2 * p;
      const int packed = (quant(e) & 0xF) | ((quant(e + 1) & 0xF) << 4);
      int8_t* dst = static_cast<int8_t*>(e < D ? k_cache : v_cache);
      dst[cache_row * half + (e % D) / 2] = (int8_t)packed;
    }
  }
}

// RoPE of a prefill's fused-QKV rows at positions 0..S-1, and their K/V
// written into cache positions [0, S) of every row (padding rows too).
// CTA (run of P positions, kv head h, batch row b). A thread takes one
// (position s, run of VEC frequencies from i0): it forms cos/sin of s *
// freq once, as the decode kernel does, and rotates with them the G query
// heads of h (to q_out) and K head h (to k_out and the cache), then
// copies the same elements of V head h (to v_out and the cache). With VEC
// == kVec the run and its partner at i0 + D/2 are one 16-byte load and
// store each, so four threads store a 64-element head row as 128
// contiguous bytes. The quantized formats stage the CTA's bf16 K and V
// rows in shared memory and quantize them as the decode kernel does.
template <int FMT, int VEC>
__global__ void __launch_bounds__(kRopeThreads)
    rope_cache_write_prefill_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ q_out,
                                    bf16* __restrict__ k_out, bf16* __restrict__ v_out,
                                    void* __restrict__ k_cache, void* __restrict__ v_cache,
                                    bf16* __restrict__ k_scale, bf16* __restrict__ v_scale,
                                    int S, int S_cache, int G, int D, int ng, int P,
                                    float theta) {
  extern __shared__ float rows[];  // quantized formats: P K rows, P V rows (D each), their scales
  const int h = blockIdx.y, b = blockIdx.z, Hkv = gridDim.y;
  const int half = D / 2, runs = half / VEC, Hq = Hkv * G;
  const int s0 = blockIdx.x * P, np = min(P, S - s0);
  const size_t cache0 = ((size_t)b * Hkv + h) * S_cache + s0;  // cache row of position s0
  const size_t out0 = ((size_t)b * Hkv + h) * S + s0;          // k_out / v_out row of s0
  const float inv_d = __fdiv_rn(1.f, (float)D);
  for (int idx = threadIdx.x; idx < np * runs; idx += kRopeThreads) {
    const int p = idx / runs, i0 = (idx - p * runs) * VEC, s = s0 + p;
    // the K (kv 0) or V (kv 1) elements of this run into the cache
    auto keep = [&](int kv, const float(&a)[VEC], const float(&z)[VEC]) {
      if constexpr (FMT == kBf16) {
        bf16* row = static_cast<bf16*>(kv ? v_cache : k_cache) + (cache0 + p) * D;
        store<VEC>(row + i0, a);
        store<VEC>(row + i0 + half, z);
      } else {
        float* row = rows + (kv * P + p) * D;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          row[i0 + j] = a[j];
          row[i0 + half + j] = z[j];
        }
      }
    };
    float c[VEC], sn[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float freq = __fdiv_rn(1.f, powf(theta, __fmul_rn((float)(2 * (i0 + j)), inv_d)));
      const float ang = __fmul_rn((float)s, freq);
      c[j] = cosf(ang);
      sn[j] = sinf(ang);
    }
    const bf16* src = qkv + ((size_t)b * S + s) * (Hq + 2 * Hkv) * D;
    float x1[VEC], x2[VEC];
    for (int hh = 0; hh <= G; ++hh) {  // the G query heads, then K
      const bf16* xs = src + (size_t)(hh < G ? h * G + hh : Hq + h) * D;
      load<VEC>(xs + i0, x1);
      load<VEC>(xs + i0 + half, x2);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float o1 = __fsub_rn(__fmul_rn(x1[j], c[j]), __fmul_rn(x2[j], sn[j]));
        const float o2 = __fadd_rn(__fmul_rn(x1[j], sn[j]), __fmul_rn(x2[j], c[j]));
        x1[j] = rounded<bf16>(o1);
        x2[j] = rounded<bf16>(o2);
      }
      bf16* dst = hh < G ? q_out + (((size_t)b * Hq + h * G + hh) * S + s) * D
                         : k_out + (out0 + p) * D;
      store<VEC>(dst + i0, x1);
      store<VEC>(dst + i0 + half, x2);
    }
    keep(0, x1, x2);
    const bf16* vs = src + (size_t)(Hq + Hkv + h) * D;
    load<VEC>(vs + i0, x1);
    load<VEC>(vs + i0 + half, x2);
    store<VEC>(v_out + (out0 + p) * D + i0, x1);
    store<VEC>(v_out + (out0 + p) * D + i0 + half, x2);
    keep(1, x1, x2);
  }
  if constexpr (FMT != kBf16) {
    __syncthreads();
    // one scale a (K | V, position, group of g = D / ng features). Thread
    // j's group starts j * g floats in (for whole runs of P positions), so
    // each thread starts its walk at another offset (t0 = j % g): the
    // threads of a warp then read distinct banks, where a common start
    // would put them all in one; the max does not depend on the order.
    const int g = D / ng;
    const float qmax = FMT == kQ8 ? 127.f : 7.f;
    float* scales = rows + 2 * P * D;
    for (int j = threadIdx.x; j < 2 * np * ng; j += kRopeThreads) {
      const int kv = j / (np * ng), p = (j / ng) % np, grp = j % ng;
      const float* xr = rows + (kv * P + p) * D + grp * g;
      float amax = 0.f;
      for (int t = 0, u = j % g; t < g; ++t, u = u + 1 == g ? 0 : u + 1)
        amax = fmaxf(amax, fabsf(xr[u]));
      float sc = __fmul_rn(amax, __fdiv_rn(1.f, qmax));
      if (sc == 0.f) sc = 1.f;
      scales[(kv * P + p) * ng + grp] = sc;
      (kv ? v_scale : k_scale)[(cache0 + p) * ng + grp] = __float2bfloat16(sc);
    }
    __syncthreads();
    auto quant = [&](int kv, int p, int i) {  // element i of staged row (kv, p)
      const int r = kv * P + p;
      const float q = rintf(__fdiv_rn(rows[r * D + i], scales[r * ng + i / g]));
      return (int)fminf(fmaxf(q, -qmax), qmax);
    };
    if constexpr (FMT == kQ8) {
      for (int e = threadIdx.x; e < 2 * np * D; e += kRopeThreads) {
        const int kv = e / (np * D), p = (e / D) % np, i = e % D;
        static_cast<int8_t*>(kv ? v_cache : k_cache)[(cache0 + p) * D + i] =
            (int8_t)quant(kv, p, i);
      }
    } else {
      for (int e = threadIdx.x; e < np * D; e += kRopeThreads) {  // np * D/2 pairs of K, then V
        const int kv = e / (np * half), p = (e / half) % np, i = 2 * (e % half);
        const int packed = (quant(kv, p, i) & 0xF) | ((quant(kv, p, i + 1) & 0xF) << 4);
        static_cast<int8_t*>(kv ? v_cache : k_cache)[(cache0 + p) * half + i / 2] = (int8_t)packed;
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TX, typename TW, int N, bool RESIDENT>
void enqueue_rmsnorm(const TX* x, const TX* delta, const TW* w, TX* h, TX* out, int M, int d,
                     float eps, cudaStream_t st) {
  if (delta)
    add_rmsnorm_kernel<TX, TW, N, RESIDENT><<<M, kThreads, 0, st>>>(x, delta, w, h, out, d, eps);
  else
    rmsnorm_kernel<TX, TW, N, RESIDENT><<<M, kThreads, 0, st>>>(x, w, out, d, eps);
}

// delta and h null: rmsnorm; else add_rmsnorm
template <typename TX, typename TW>
cudaError_t launch_rmsnorm(const void* x, const void* delta, const void* w, void* h, void* out,
                           int M, int d, float eps, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  const TX* dp = static_cast<const TX*>(delta);
  const TW* wp = static_cast<const TW*>(w);
  TX* hp = static_cast<TX*>(h);
  TX* op = static_cast<TX*>(out);
  const bool vec = d % kVec == 0 && aligned16(x) && aligned16(w) && aligned16(out) &&
                   (!delta || (aligned16(delta) && aligned16(h)));
  if (vec) {
    if (d <= kResident * kThreads * kVec)
      enqueue_rmsnorm<TX, TW, kVec, true>(xp, dp, wp, hp, op, M, d, eps, st);
    else
      enqueue_rmsnorm<TX, TW, kVec, false>(xp, dp, wp, hp, op, M, d, eps, st);
  } else if (d <= kResident * kThreads) {
    enqueue_rmsnorm<TX, TW, 1, true>(xp, dp, wp, hp, op, M, d, eps, st);
  } else {
    enqueue_rmsnorm<TX, TW, 1, false>(xp, dp, wp, hp, op, M, d, eps, st);
  }
  return cudaGetLastError();
}

cudaError_t dispatch_rmsnorm(int x_f32, int w_f32, const void* x, const void* delta,
                             const void* w, void* h, void* out, int M, int d, float eps,
                             void* stream) {
  if (M <= 0 || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return w_f32 ? launch_rmsnorm<float, float>(x, delta, w, h, out, M, d, eps, st)
                 : launch_rmsnorm<float, bf16>(x, delta, w, h, out, M, d, eps, st);
  return w_f32 ? launch_rmsnorm<bf16, float>(x, delta, w, h, out, M, d, eps, st)
               : launch_rmsnorm<bf16, bf16>(x, delta, w, h, out, M, d, eps, st);
}

template <typename T>
cudaError_t launch_swiglu(const void* gu, void* out, int M, int F, cudaStream_t st) {
  const T* gp = static_cast<const T*>(gu);
  T* op = static_cast<T*>(out);
  if (F % kVec == 0 && aligned16(gu) && aligned16(out)) {
    const dim3 grid(M, (F / kVec + kThreads - 1) / kThreads);
    swiglu_kernel<T, kVec><<<grid, kThreads, 0, st>>>(gp, op, F);
  } else {
    const dim3 grid(M, (F + kThreads - 1) / kThreads);
    swiglu_kernel<T, 1><<<grid, kThreads, 0, st>>>(gp, op, F);
  }
  return cudaGetLastError();
}

}  // namespace

// x (M, d) bf16 or f32 (x_f32), w (d,) bf16 or f32 (w_f32), out (M, d) in
// x's type. Returns the launch's cudaError_t (0 on success).
extern "C" int rmsnorm(int x_f32, int w_f32, const void* x, const void* w, void* out, int M,
                       int d, float eps, void* stream) {
  return dispatch_rmsnorm(x_f32, w_f32, x, nullptr, w, nullptr, out, M, d, eps, stream);
}

// x, delta, h, out (M, d) bf16 or f32 (x_f32), w (d,) bf16 or f32 (w_f32):
// h = x + delta, out = rmsnorm(h, w). Returns the launch's cudaError_t.
extern "C" int add_rmsnorm(int x_f32, int w_f32, const void* x, const void* delta,
                           const void* w, void* h, void* out, int M, int d, float eps,
                           void* stream) {
  if (!delta || !h) return cudaErrorInvalidValue;
  return dispatch_rmsnorm(x_f32, w_f32, x, delta, w, h, out, M, d, eps, stream);
}

// gu (M, 2F) and out (M, F), both bf16 or both f32 (f32). Returns the
// launch's cudaError_t.
extern "C" int swiglu(int f32, const void* gu, void* out, int M, int F, void* stream) {
  if (M <= 0 || F <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? launch_swiglu<float>(gu, out, M, F, st) : launch_swiglu<bf16>(gu, out, M, F, st);
}

// fmt: 0 = bf16 cache, 1 = q8_0, 2 = q4_0. qkv (B, (Hkv*G + 2*Hkv) * D)
// bf16; q_out (B, Hkv*G, D) bf16; k, v (B, Hkv, S, D) bf16, or int8
// payload (B, Hkv, S, D) [q8_0] / (B, Hkv, S, D/2) [q4_0] with k_scale,
// v_scale (B, Hkv, S, ng) bf16 (null for bf16); lens (B,) int32 >= 0;
// advance (B,) bool or null (every row). Returns the launch's
// cudaError_t.
extern "C" int rope_cache_write(int fmt, const void* qkv, void* q_out, void* k, void* v,
                                void* k_scale, void* v_scale, const void* lens,
                                const void* advance, int B, int Hkv, int G, int S, int D,
                                int ng, float theta, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || S <= 0 || D <= 0 || D % 2) return cudaErrorInvalidValue;
  if (fmt != kBf16 && (ng <= 0 || D % ng)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(Hkv, B);
  const size_t smem = fmt == kBf16 ? 0 : (size_t)(2 * D + 2 * ng) * sizeof(float);
  const bf16* src = static_cast<const bf16*>(qkv);
  bf16* qo = static_cast<bf16*>(q_out);
  bf16* ks = static_cast<bf16*>(k_scale);
  bf16* vs = static_cast<bf16*>(v_scale);
  const int* ln = static_cast<const int*>(lens);
  const unsigned char* adv = static_cast<const unsigned char*>(advance);
  switch (fmt) {
    case kBf16:
      rope_cache_write_kernel<kBf16><<<grid, kRopeThreads, smem, st>>>(src, qo, k, v, ks, vs, ln, adv, G, S, D, ng, theta);
      break;
    case kQ8:
      rope_cache_write_kernel<kQ8><<<grid, kRopeThreads, smem, st>>>(src, qo, k, v, ks, vs, ln, adv, G, S, D, ng, theta);
      break;
    case kQ4:
      rope_cache_write_kernel<kQ4><<<grid, kRopeThreads, smem, st>>>(src, qo, k, v, ks, vs, ln, adv, G, S, D, ng, theta);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}


template <int FMT, int VEC>
void enqueue_rope_prefill(dim3 grid, size_t smem, cudaStream_t st, const void* qkv, void* q_out,
                          void* k_out, void* v_out, void* k, void* v, void* k_scale,
                          void* v_scale, int S, int S_cache, int G, int D, int ng, int P,
                          float theta) {
  rope_cache_write_prefill_kernel<FMT, VEC><<<grid, kRopeThreads, smem, st>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(q_out), static_cast<bf16*>(k_out),
      static_cast<bf16*>(v_out), k, v, static_cast<bf16*>(k_scale),
      static_cast<bf16*>(v_scale), S, S_cache, G, D, ng, P, theta);
}

// fmt as rope_cache_write's. qkv (B, S, (Hkv*G + 2*Hkv) * D) bf16; q_out
// (B, Hkv*G, S, D), k_out and v_out (B, Hkv, S, D) bf16; k, v, k_scale,
// v_scale one layer's cache as rope_cache_write's with S_cache >= S
// positions, of which [0, S) are written. Returns the launch's cudaError_t.
extern "C" int rope_cache_write_prefill(int fmt, const void* qkv, void* q_out, void* k_out,
                                        void* v_out, void* k, void* v, void* k_scale,
                                        void* v_scale, int B, int Hkv, int G, int S,
                                        int S_cache, int D, int ng, float theta, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || S <= 0 || S > S_cache || D <= 0 || D % 2)
    return cudaErrorInvalidValue;
  if (fmt != kBf16 && (ng <= 0 || D % ng)) return cudaErrorInvalidValue;
  if (B > 65535 || Hkv > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (D / 2) % kVec == 0 && aligned16(qkv) && aligned16(q_out) &&
                   aligned16(k_out) && aligned16(v_out) &&
                   (fmt != kBf16 || (aligned16(k) && aligned16(v)));
  const int runs = D / 2 / (vec ? kVec : 1);
  const int P = runs >= kRopeThreads ? 1 : kRopeThreads / runs;  // positions a CTA
  const dim3 grid((S + P - 1) / P, Hkv, B);
  const size_t smem = fmt == kBf16 ? 0 : (size_t)(2 * P * D + 2 * P * ng) * sizeof(float);
  switch (fmt * 2 + vec) {
    case kBf16 * 2 + 1:
      enqueue_rope_prefill<kBf16, kVec>(grid, smem, st, qkv, q_out, k_out, v_out, k, v, k_scale, v_scale, S, S_cache, G, D, ng, P, theta);
      break;
    case kBf16 * 2:
      enqueue_rope_prefill<kBf16, 1>(grid, smem, st, qkv, q_out, k_out, v_out, k, v, k_scale, v_scale, S, S_cache, G, D, ng, P, theta);
      break;
    case kQ8 * 2 + 1:
      enqueue_rope_prefill<kQ8, kVec>(grid, smem, st, qkv, q_out, k_out, v_out, k, v, k_scale, v_scale, S, S_cache, G, D, ng, P, theta);
      break;
    case kQ8 * 2:
      enqueue_rope_prefill<kQ8, 1>(grid, smem, st, qkv, q_out, k_out, v_out, k, v, k_scale, v_scale, S, S_cache, G, D, ng, P, theta);
      break;
    case kQ4 * 2 + 1:
      enqueue_rope_prefill<kQ4, kVec>(grid, smem, st, qkv, q_out, k_out, v_out, k, v, k_scale, v_scale, S, S_cache, G, D, ng, P, theta);
      break;
    case kQ4 * 2:
      enqueue_rope_prefill<kQ4, 1>(grid, smem, st, qkv, q_out, k_out, v_out, k, v, k_scale, v_scale, S, S_cache, G, D, ng, P, theta);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
