// The small fused ops of the decode step and the prefill, for sm_90a:
// RMSNorm, alone or with the residual add before it, SwiGLU and GeGLU on
// the fused gate-up row, and RoPE with the cache write, for one decode
// token and for a whole prefill.
//
// No Pallas kernel of the JAX package stands behind these: there XLA fuses
//   src/repro/models/layers.py:26      rmsnorm, with the residual adds of
//   src/repro/models/model.py:284      the layer body
//   src/repro/models/mlp.py:37         mlp_forward (silu(g) * u, or
//   src/repro/models/layers.py:108     gelu(g) * u with the logistic gelu)
//   src/repro/models/layers.py:51      apply_rope, with
//   src/repro/models/attention.py:297  kv_cache_write (decode) and
//   src/repro/models/model.py:722      _write_prefill_kv (prefill)
// inside the jitted megastep and prefill, and the RoPE kernels also take
//   src/repro/models/layers.py:101     linear's bias add (the fused QKV
//                                      projection's, qwen2)
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
// that use it and writes q, k, v and the cache rows in one pass, and the
// decode RoPE forms them once a slot for all its heads.
//
// Numerics follow the plain PyTorch versions in kernels/fused_ops.py, op
// for op, with every product and sum rounded on its own (the _rn
// intrinsics keep nvcc from contracting them into FMAs): RMSNorm and
// SwiGLU compute in f32 and round once to the output's type (GeGLU
// rounds gelu(g) to it first, then the product, as the JAX mlp_forward
// does: its gelu returns the input's type), and the
// residual sum rounds once to x's type; RoPE rounds the rotated row to
// bf16, and the quantized caches quantize that bf16 row as
// quant.quantize_rows does (scale = amax * (1 / qmax), a zero scale taken
// as 1, payload = clamp(rint(x / scale)) with an f32 division, scales
// stored as bf16). Only the sum of squares of RMSNorm is taken in another
// order than PyTorch's.
#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"  // round_bf16, gelu_f32 (shared with quant_matmul.cu, rglru.cu)

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // RMSNorm and SwiGLU
constexpr int kResident = 4;       // RMSNorm: runs a thread keeps in registers
constexpr int kRopeThreads = 128;  // the prefill's RoPE + cache write
constexpr int kDecodeRopeThreads = 1024;  // the decode RoPE + cache write: at most, a CTA
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

__device__ __forceinline__ float round_to(float v, const bf16*) { return round_bf16(v); }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

// out[m, j] = gelu(gu[m, j]) * gu[m, F + j]: gelu in f32 rounded to T,
// then the product rounded to T (two roundings, the JAX rounding points).
// CTA (row m, run of kThreads * N columns), as swiglu_kernel.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    geglu_kernel(const T* __restrict__ gu, T* __restrict__ out, int F) {
  const int j = (blockIdx.y * kThreads + threadIdx.x) * N;
  if (j >= F) return;
  const T* g = gu + (size_t)blockIdx.x * 2 * F + j;
  float a[N], b[N];
  load<N>(g, a);
  load<N>(g + F, b);
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = __fmul_rn(round_to(gelu_f32(a[i]), g), b[i]);
  store<N>(out + (size_t)blockIdx.x * F + j, a);
}

// RoPE of one token's fused-QKV row, and its K/V write into the cache.
// With a bias (non-null, one bf16 value a fused-QKV column) each element
// read is first x + bias rounded to bf16, as the bf16 add after the
// projection rounds it; then as without.
// CTA (slot b, chunk of 1024 threads; one chunk up to 1024 runs): a thread
// takes one run of kVec elements of a head row and its partner run D/2
// further on, as one 16-byte load each, over the row's heads in their
// order (the Hq query heads, then the Hkv K heads, then the Hkv V heads).
// The slot's cos and sin at position lens[b] (half-split rotation, cos /
// sin of pos * freq, freq = 1 / theta^(2i * (1/D))) are formed once a CTA,
// a thread each, into shared memory; the frequency needs no position, so
// it is formed while lens[b] and the row are in flight. Query and K runs
// are rotated and rounded to bf16; q goes to q_out, and K and V into ring
// slot lens[b] % S of (b, kv head) when advance[b] (always when advance is
// null); other rows' cache is not touched. A paged cache (table non-null:
// K/V and scale pools (n_blocks, Hkv, P, .), S = max_pages * P) takes ring
// slot pos = lens[b] % S to row pos % P of the pool block table[b][pos /
// P]; a frozen row writes nothing there either. The quantized formats take
// one scale a group of g = D / ng features: a group spans g / kVec
// adjacent lanes of one half of the head row (g dividing D / 2), or the
// head's runs in both halves (ng == 1), so its amax is taken by warp
// shuffles over those lanes, with no shared-memory pass; the payload is
// written as 8 bytes (q8_0) or 4 (q4_0: nibble pairs, low nibble = even
// feature) a run. Shapes: D a multiple of 16 with D / 16 a power of two
// up to 32, so a head's runs never straddle a warp (the launcher checks).
template <int FMT>
__global__ void __launch_bounds__(kDecodeRopeThreads)
    rope_cache_write_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                            bf16* __restrict__ q_out,
                            void* __restrict__ k_cache, void* __restrict__ v_cache,
                            bf16* __restrict__ k_scale, bf16* __restrict__ v_scale,
                            const int* __restrict__ lens,
                            const unsigned char* __restrict__ advance,
                            const int* __restrict__ table, int max_pages, int P, int Hkv,
                            int G, int S, int D, int ng, float theta) {
  extern __shared__ float cs[];  // cos (D / 2), then sin (D / 2), of the slot's position
  const int b = blockIdx.x, tid = threadIdx.x;
  const int half = D / 2, runs = half / kVec, Hq = Hkv * G;
  // the slot's scalars first: all but the row's loads wait on them
  const int pos = lens[b];
  const bool adv = advance == nullptr || advance[b] != 0;
  const int slot = pos % S;
  const int blk = table == nullptr ? 0 : table[(size_t)b * max_pages + slot / P];
  // this thread's run: kVec elements at i0 of head `head`, and its partner
  const int idx = blockIdx.y * blockDim.x + tid;
  const bool on = idx < (Hq + 2 * Hkv) * runs;
  const int head = idx / runs, i0 = (idx - head * runs) * kVec;
  float x1[kVec], x2[kVec];
  if (on) {
    const bf16* src = qkv + ((size_t)b * (Hq + 2 * Hkv) + head) * D;
    load<kVec>(src + i0, x1);
    load<kVec>(src + i0 + half, x2);
    if (bias != nullptr) {
      float b1[kVec], b2[kVec];
      load<kVec>(bias + (size_t)head * D + i0, b1);
      load<kVec>(bias + (size_t)head * D + i0 + half, b2);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        x1[j] = rounded<bf16>(__fadd_rn(x1[j], b1[j]));
        x2[j] = rounded<bf16>(__fadd_rn(x2[j], b2[j]));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) x1[j] = x2[j] = 0.f;
  }
  if (tid < D) {
    const int i = tid < half ? tid : tid - half;
    const float freq =
        __fdiv_rn(1.f, powf(theta, __fmul_rn((float)(2 * i), __fdiv_rn(1.f, (float)D))));
    const float ang = __fmul_rn((float)pos, freq);
    cs[tid] = tid < half ? cosf(ang) : sinf(ang);
  }
  __syncthreads();
  if (on && head < Hq + Hkv) {  // a query or K run: rotated, rounded to bf16
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float c = cs[i0 + j], s = cs[half + i0 + j];
      const float o1 = __fsub_rn(__fmul_rn(x1[j], c), __fmul_rn(x2[j], s));
      const float o2 = __fadd_rn(__fmul_rn(x1[j], s), __fmul_rn(x2[j], c));
      x1[j] = rounded<bf16>(o1);
      x2[j] = rounded<bf16>(o2);
    }
  }
  if (on && head < Hq) {
    bf16* qo = q_out + ((size_t)b * Hq + head) * D;
    store<kVec>(qo + i0, x1);
    store<kVec>(qo + i0 + half, x2);
  }
  if (!adv) return;  // uniform over the CTA, past its one barrier
  const bool is_v = head >= Hq + Hkv;
  const bool kv = on && head >= Hq;
  const int h = head - Hq - (is_v ? Hkv : 0);
  const size_t row = table == nullptr ? ((size_t)b * Hkv + h) * S + slot
                                      : ((size_t)blk * Hkv + h) * P + slot % P;
  if constexpr (FMT == kBf16) {
    if (kv) {
      bf16* dst = static_cast<bf16*>(is_v ? v_cache : k_cache) + row * D;
      store<kVec>(dst + i0, x1);
      store<kVec>(dst + i0 + half, x2);
    }
  } else {
    const int g = D / ng;
    const float qmax = FMT == kQ8 ? 127.f : 7.f;
    float a1 = 0.f, a2 = 0.f;  // the amax of the run's group and of its partner's
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      a1 = fmaxf(a1, fabsf(x1[j]));
      a2 = fmaxf(a2, fabsf(x2[j]));
    }
    if (g == D) a1 = a2 = fmaxf(a1, a2);
    const int lanes = g == D ? runs : g / kVec;  // uniform: every lane shuffles
    for (int o = 1; o < lanes; o <<= 1) {
      a1 = fmaxf(a1, __shfl_xor_sync(0xffffffffu, a1, o));
      a2 = fmaxf(a2, __shfl_xor_sync(0xffffffffu, a2, o));
    }
    float s1 = __fmul_rn(a1, __fdiv_rn(1.f, qmax));
    float s2 = __fmul_rn(a2, __fdiv_rn(1.f, qmax));
    if (s1 == 0.f) s1 = 1.f;
    if (s2 == 0.f) s2 = 1.f;
    if (!kv) return;
    bf16* scales = (is_v ? v_scale : k_scale) + row * ng;
    if (i0 % g == 0) {
      scales[i0 / g] = __float2bfloat16(s1);
      if (g != D) scales[(i0 + half) / g] = __float2bfloat16(s2);
    }
    int q1[kVec], q2[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      q1[j] = (int)fminf(fmaxf(rintf(__fdiv_rn(x1[j], s1)), -qmax), qmax);
      q2[j] = (int)fminf(fmaxf(rintf(__fdiv_rn(x2[j], s2)), -qmax), qmax);
    }
    if constexpr (FMT == kQ8) {
      int8_t* dst = static_cast<int8_t*>(is_v ? v_cache : k_cache) + row * D;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        w[j / 4] |= (uint32_t)(q1[j] & 0xFF) << (8 * (j % 4));
        w[2 + j / 4] |= (uint32_t)(q2[j] & 0xFF) << (8 * (j % 4));
      }
      *reinterpret_cast<uint2*>(dst + i0) = make_uint2(w[0], w[1]);
      *reinterpret_cast<uint2*>(dst + i0 + half) = make_uint2(w[2], w[3]);
    } else {
      int8_t* dst = static_cast<int8_t*>(is_v ? v_cache : k_cache) + row * half;
      uint32_t w1 = 0u, w2 = 0u;
#pragma unroll
      for (int j = 0; j < kVec / 2; ++j) {
        w1 |= (uint32_t)((q1[2 * j] & 0xF) | ((q1[2 * j + 1] & 0xF) << 4)) << (8 * j);
        w2 |= (uint32_t)((q2[2 * j] & 0xF) | ((q2[2 * j + 1] & 0xF) << 4)) << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(dst + i0 / 2) = w1;
      *reinterpret_cast<uint32_t*>(dst + (i0 + half) / 2) = w2;
    }
  }
}

// RoPE of a prefill's fused-QKV rows at positions 0..S-1, and their K/V
// written into cache positions [0, S) of every row (padding rows too).
// A prefill longer than the cache (S > S_cache, the ring branch of the JAX
// _write_prefill_kv) keeps its last S_cache positions, position s at ring
// slot s % S_cache; q, k and v out hold all S positions either way (the
// prefill attention reads them, not the cache), and RoPE stays at the
// absolute positions. A bias (non-null) is added first, rounded to bf16,
// as in the decode kernel.
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
    rope_cache_write_prefill_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                                    bf16* __restrict__ q_out,
                                    bf16* __restrict__ k_out, bf16* __restrict__ v_out,
                                    void* __restrict__ k_cache, void* __restrict__ v_cache,
                                    bf16* __restrict__ k_scale, bf16* __restrict__ v_scale,
                                    int S, int S_cache, int G, int D, int ng, int P,
                                    float theta) {
  extern __shared__ float rows[];  // quantized formats: P K rows, P V rows (D each), their scales
  const int h = blockIdx.y, b = blockIdx.z, Hkv = gridDim.y;
  const int half = D / 2, runs = half / VEC, Hq = Hkv * G;
  const int s0 = blockIdx.x * P, np = min(P, S - s0);
  const size_t slice = ((size_t)b * Hkv + h) * S_cache;  // cache row 0 of (b, h)
  const int first = S > S_cache ? S - S_cache : 0;       // the first position kept
  // cache row of position s0 + p >= first: its ring slot (s0 + p itself
  // when the prefill fits the cache)
  auto cache_row = [&](int p) { return slice + (size_t)((s0 + p) % S_cache); };
  const size_t out0 = ((size_t)b * Hkv + h) * S + s0;          // k_out / v_out row of s0
  const float inv_d = __fdiv_rn(1.f, (float)D);
  for (int idx = threadIdx.x; idx < np * runs; idx += kRopeThreads) {
    const int p = idx / runs, i0 = (idx - p * runs) * VEC, s = s0 + p;
    // the K (kv 0) or V (kv 1) elements of this run into the cache
    auto keep = [&](int kv, const float(&a)[VEC], const float(&z)[VEC]) {
      if constexpr (FMT == kBf16) {
        if (s < first) return;
        bf16* row = static_cast<bf16*>(kv ? v_cache : k_cache) + cache_row(p) * D;
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
    // the run and its partner of the head whose first column is col
    auto take = [&](int col) {
      load<VEC>(src + col + i0, x1);
      load<VEC>(src + col + i0 + half, x2);
      if (bias != nullptr) {
        float b1[VEC], b2[VEC];
        load<VEC>(bias + col + i0, b1);
        load<VEC>(bias + col + i0 + half, b2);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          x1[j] = rounded<bf16>(__fadd_rn(x1[j], b1[j]));
          x2[j] = rounded<bf16>(__fadd_rn(x2[j], b2[j]));
        }
      }
    };
    for (int hh = 0; hh <= G; ++hh) {  // the G query heads, then K
      take((hh < G ? h * G + hh : Hq + h) * D);
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
    take((Hq + Hkv + h) * D);
    store<VEC>(v_out + (out0 + p) * D + i0, x1);
    store<VEC>(v_out + (out0 + p) * D + i0 + half, x2);
    keep(1, x1, x2);
  }
  if constexpr (FMT != kBf16) {
    if (s0 + np <= first) return;  // no position of this CTA is kept: uniform, before any barrier
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
      if (s0 + p < first) continue;
      const float* xr = rows + (kv * P + p) * D + grp * g;
      float amax = 0.f;
      for (int t = 0, u = j % g; t < g; ++t, u = u + 1 == g ? 0 : u + 1)
        amax = fmaxf(amax, fabsf(xr[u]));
      float sc = __fmul_rn(amax, __fdiv_rn(1.f, qmax));
      if (sc == 0.f) sc = 1.f;
      scales[(kv * P + p) * ng + grp] = sc;
      (kv ? v_scale : k_scale)[cache_row(p) * ng + grp] = __float2bfloat16(sc);
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
        if (s0 + p < first) continue;
        static_cast<int8_t*>(kv ? v_cache : k_cache)[cache_row(p) * D + i] =
            (int8_t)quant(kv, p, i);
      }
    } else {
      for (int e = threadIdx.x; e < np * D; e += kRopeThreads) {  // np * D/2 pairs of K, then V
        const int kv = e / (np * half), p = (e / half) % np, i = 2 * (e % half);
        if (s0 + p < first) continue;
        const int packed = (quant(kv, p, i) & 0xF) | ((quant(kv, p, i + 1) & 0xF) << 4);
        static_cast<int8_t*>(kv ? v_cache : k_cache)[cache_row(p) * half + i / 2] = (int8_t)packed;
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

// SwiGLU (GELU false) or GeGLU (GELU true) of gu (M, 2F) into out (M, F)
template <typename T, bool GELU>
cudaError_t launch_glu(const void* gu, void* out, int M, int F, cudaStream_t st) {
  const T* gp = static_cast<const T*>(gu);
  T* op = static_cast<T*>(out);
  if (F % kVec == 0 && aligned16(gu) && aligned16(out)) {
    const dim3 grid(M, (F / kVec + kThreads - 1) / kThreads);
    if (GELU)
      geglu_kernel<T, kVec><<<grid, kThreads, 0, st>>>(gp, op, F);
    else
      swiglu_kernel<T, kVec><<<grid, kThreads, 0, st>>>(gp, op, F);
  } else {
    const dim3 grid(M, (F + kThreads - 1) / kThreads);
    if (GELU)
      geglu_kernel<T, 1><<<grid, kThreads, 0, st>>>(gp, op, F);
    else
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
  return f32 ? launch_glu<float, false>(gu, out, M, F, st)
             : launch_glu<bf16, false>(gu, out, M, F, st);
}

// gu (M, 2F) and out (M, F), both bf16 or both f32 (f32): out = gelu(g) *
// u with the JAX rounding points. Returns the launch's cudaError_t.
extern "C" int geglu(int f32, const void* gu, void* out, int M, int F, void* stream) {
  if (M <= 0 || F <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? launch_glu<float, true>(gu, out, M, F, st)
             : launch_glu<bf16, true>(gu, out, M, F, st);
}

// fmt: 0 = bf16 cache, 1 = q8_0, 2 = q4_0. qkv (B, (Hkv*G + 2*Hkv) * D)
// bf16; q_out (B, Hkv*G, D) bf16; k, v (B, Hkv, S, D) bf16, or int8
// payload (B, Hkv, S, D) [q8_0] / (B, Hkv, S, D/2) [q4_0] with k_scale,
// v_scale (B, Hkv, S, ng) bf16 (null for bf16); lens (B,) int32 >= 0;
// advance (B,) bool or null (every row); bias (width,) bf16 or null (no
// bias), the fused-QKV projection's. A paged cache passes its block
// table (B, max_pages) int32, its leaves as pools (n_blocks, Hkv, P, .)
// and S = max_pages * P; table null means a dense cache. D must be a
// multiple of 16 with D / 16 a power of two up to 32, a quantized group
// g = D / ng a multiple of 8 dividing D / 2 (or ng 1), and qkv, bias,
// q_out, k and v 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int rope_cache_write(int fmt, const void* qkv, const void* bias, void* q_out,
                                void* k, void* v,
                                void* k_scale, void* v_scale, const void* lens,
                                const void* advance, const void* table, int max_pages,
                                int P, int B, int Hkv, int G, int S, int D, int ng,
                                float theta, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || S <= 0 || D <= 0) return cudaErrorInvalidValue;
  const int runs = D / 2 / kVec;
  if (D % (2 * kVec) || runs > 32 || (runs & (runs - 1))) return cudaErrorInvalidValue;
  if (table != nullptr && (P <= 0 || max_pages <= 0 || S != max_pages * P))
    return cudaErrorInvalidValue;
  if (fmt != kBf16 &&
      (ng <= 0 || D % ng || (ng != 1 && ((D / ng) % kVec || (D / 2) % (D / ng)))))
    return cudaErrorInvalidValue;
  if (!aligned16(qkv) || (bias && !aligned16(bias)) || !aligned16(q_out) || !aligned16(k) ||
      !aligned16(v))
    return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int items = (Hkv * G + 2 * Hkv) * runs;
  const int threads = std::min(kDecodeRopeThreads, std::max(items, D) + 31) / 32 * 32;
  const dim3 grid(B, (items + threads - 1) / threads);
  const size_t smem = (size_t)D * sizeof(float);
  const bf16* src = static_cast<const bf16*>(qkv);
  const bf16* bs = static_cast<const bf16*>(bias);
  bf16* qo = static_cast<bf16*>(q_out);
  bf16* ks = static_cast<bf16*>(k_scale);
  bf16* vs = static_cast<bf16*>(v_scale);
  const int* ln = static_cast<const int*>(lens);
  const unsigned char* adv = static_cast<const unsigned char*>(advance);
  switch (fmt) {
    case kBf16:
      rope_cache_write_kernel<kBf16><<<grid, threads, smem, st>>>(src, bs, qo, k, v, ks, vs, ln, adv, tb, max_pages, P, Hkv, G, S, D, ng, theta);
      break;
    case kQ8:
      rope_cache_write_kernel<kQ8><<<grid, threads, smem, st>>>(src, bs, qo, k, v, ks, vs, ln, adv, tb, max_pages, P, Hkv, G, S, D, ng, theta);
      break;
    case kQ4:
      rope_cache_write_kernel<kQ4><<<grid, threads, smem, st>>>(src, bs, qo, k, v, ks, vs, ln, adv, tb, max_pages, P, Hkv, G, S, D, ng, theta);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}


template <int FMT, int VEC>
void enqueue_rope_prefill(dim3 grid, size_t smem, cudaStream_t st, const void* qkv,
                          const void* bias, void* q_out,
                          void* k_out, void* v_out, void* k, void* v, void* k_scale,
                          void* v_scale, int S, int S_cache, int G, int D, int ng, int P,
                          float theta) {
  rope_cache_write_prefill_kernel<FMT, VEC><<<grid, kRopeThreads, smem, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias), static_cast<bf16*>(q_out),
      static_cast<bf16*>(k_out),
      static_cast<bf16*>(v_out), k, v, static_cast<bf16*>(k_scale),
      static_cast<bf16*>(v_scale), S, S_cache, G, D, ng, P, theta);
}

// fmt as rope_cache_write's. qkv (B, S, (Hkv*G + 2*Hkv) * D) bf16; bias
// as rope_cache_write's; q_out (B, Hkv*G, S, D), k_out and v_out (B, Hkv,
// S, D) bf16; k, v, k_scale, v_scale one layer's cache as
// rope_cache_write's with S_cache positions, of which [0, S) are written
// when S <= S_cache, else the last S_cache positions at their ring slots
// s % S_cache. Returns the launch's cudaError_t.
extern "C" int rope_cache_write_prefill(int fmt, const void* qkv, const void* bias, void* q_out,
                                        void* k_out,
                                        void* v_out, void* k, void* v, void* k_scale,
                                        void* v_scale, int B, int Hkv, int G, int S,
                                        int S_cache, int D, int ng, float theta, void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0 || S <= 0 || S_cache <= 0 || D <= 0 || D % 2)
    return cudaErrorInvalidValue;
  if (fmt != kBf16 && (ng <= 0 || D % ng)) return cudaErrorInvalidValue;
  if (B > 65535 || Hkv > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (D / 2) % kVec == 0 && aligned16(qkv) && aligned16(q_out) &&
                   aligned16(k_out) && aligned16(v_out) && (!bias || aligned16(bias)) &&
                   (fmt != kBf16 || (aligned16(k) && aligned16(v)));
  const int runs = D / 2 / (vec ? kVec : 1);
  const int P = runs >= kRopeThreads ? 1 : kRopeThreads / runs;  // positions a CTA
  const dim3 grid((S + P - 1) / P, Hkv, B);
  const size_t smem = fmt == kBf16 ? 0 : (size_t)(2 * P * D + 2 * P * ng) * sizeof(float);
  switch (fmt * 2 + vec) {
    case kBf16 * 2 + 1:
      enqueue_rope_prefill<kBf16, kVec>(grid, smem, st, qkv, bias, q_out, k_out, v_out, k, v, k_scale, v_scale, S, S_cache, G, D, ng, P, theta);
      break;
    case kBf16 * 2:
      enqueue_rope_prefill<kBf16, 1>(grid, smem, st, qkv, bias, q_out, k_out, v_out, k, v, k_scale, v_scale, S, S_cache, G, D, ng, P, theta);
      break;
    case kQ8 * 2 + 1:
      enqueue_rope_prefill<kQ8, kVec>(grid, smem, st, qkv, bias, q_out, k_out, v_out, k, v, k_scale, v_scale, S, S_cache, G, D, ng, P, theta);
      break;
    case kQ8 * 2:
      enqueue_rope_prefill<kQ8, 1>(grid, smem, st, qkv, bias, q_out, k_out, v_out, k, v, k_scale, v_scale, S, S_cache, G, D, ng, P, theta);
      break;
    case kQ4 * 2 + 1:
      enqueue_rope_prefill<kQ4, kVec>(grid, smem, st, qkv, bias, q_out, k_out, v_out, k, v, k_scale, v_scale, S, S_cache, G, D, ng, P, theta);
      break;
    case kQ4 * 2:
      enqueue_rope_prefill<kQ4, 1>(grid, smem, st, qkv, bias, q_out, k_out, v_out, k, v, k_scale, v_scale, S, S_cache, G, D, ng, P, theta);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
