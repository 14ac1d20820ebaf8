// The small fused ops of the decode step and the prefill, for sm_90a:
// RMSNorm, SwiGLU on the fused gate-up row, and RoPE with the decode
// cache write.
//
// No Pallas kernel of the JAX package stands behind these: there XLA fuses
//   src/repro/models/layers.py:26      rmsnorm
//   src/repro/models/mlp.py:37         mlp_forward (silu(g) * u)
//   src/repro/models/layers.py:51      apply_rope, with
//   src/repro/models/attention.py:297  kv_cache_write
// inside the jitted megastep and prefill. Eagerly, each op above is a
// handful of PyTorch launches of a few microseconds apiece; one decode
// step ran some 80 of them a layer. Each kernel here is one launch.
//
// Bound: bytes. Each kernel reads its inputs once and writes its outputs
// once with a few operations an element, far below the line where the
// arithmetic would bound it. Design against that bound and the launch
// count: one pass, 16-byte loads and stores where the width allows (8
// elements a thread), reductions by warp shuffles.
//
// Numerics follow the plain PyTorch versions in kernels/fused_ops.py, op
// for op, with every product and sum rounded on its own (the _rn
// intrinsics keep nvcc from contracting them into FMAs): RMSNorm and
// SwiGLU compute in f32 and round once to the output's type; RoPE rounds
// the rotated row to bf16, and the quantized caches quantize that bf16
// row as quant.quantize_rows does (scale = amax * (1 / qmax), a zero scale
// taken as 1, payload = clamp(rint(x / scale)) with an f32 division,
// scales stored as bf16). Only the sum of squares of RMSNorm is taken in
// another order than PyTorch's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // RMSNorm and SwiGLU
constexpr int kRopeThreads = 128;  // RoPE + cache write: one (slot, kv head) a CTA
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

// One CTA a row: out = bf16/f32(x * rsqrt(mean(x^2) + eps) * w), in f32.
// With N == kVec a thread holds 8 elements a pass (d % 8 == 0, rows
// 16-byte aligned); the second pass reads the row again from L1/L2.
template <typename TX, typename TW, int N>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                   int d, float eps) {
  const TX* xr = x + (size_t)blockIdx.x * d;
  TX* orow = out + (size_t)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x * N; i < d; i += kThreads * N) {
    float f[N];
    load<N>(xr + i, f);
#pragma unroll
    for (int j = 0; j < N; ++j) ss = __fadd_rn(ss, __fmul_rn(f[j], f[j]));
  }
  const float var = __fdiv_rn(block_sum(ss), (float)d);
  const float r = rsqrtf(__fadd_rn(var, eps));
  for (int i = threadIdx.x * N; i < d; i += kThreads * N) {
    float f[N], g[N];
    load<N>(xr + i, f);
    load<N>(w + i, g);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = __fmul_rn(__fmul_rn(f[j], r), g[j]);
    store<N>(orow + i, f);
  }
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TX, typename TW>
cudaError_t launch_rmsnorm(const void* x, const void* w, void* out, int M, int d, float eps,
                           cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  if (d % kVec == 0 && aligned16(x) && aligned16(w) && aligned16(out))
    rmsnorm_kernel<TX, TW, kVec><<<M, kThreads, 0, st>>>(xp, wp, op, d, eps);
  else
    rmsnorm_kernel<TX, TW, 1><<<M, kThreads, 0, st>>>(xp, wp, op, d, eps);
  return cudaGetLastError();
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
  if (M <= 0 || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_f32)
    return w_f32 ? launch_rmsnorm<float, float>(x, w, out, M, d, eps, st)
                 : launch_rmsnorm<float, bf16>(x, w, out, M, d, eps, st);
  return w_f32 ? launch_rmsnorm<bf16, float>(x, w, out, M, d, eps, st)
               : launch_rmsnorm<bf16, bf16>(x, w, out, M, d, eps, st);
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
