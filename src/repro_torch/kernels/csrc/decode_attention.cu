// Single-token GQA decode attention over a KV cache, for sm_90a.
//
// Replaces the JAX package's Pallas kernels
//   src/repro/kernels/decode_attention.py        decode_attention (_decode_kernel)
//   src/repro/kernels/decode_attention_quant.py  decode_attention_quant (_decode_quant_kernel)
// with one kernel templated on the K/V loader: bf16 rows, q8_0 rows, or
// q4_0 rows (int8 payload + bf16 groupwise scales, dequantized on load).
//
// Bound: the cache bytes read (K and V rows [lo, kv_len) of each
// (batch, kv head), plus scales for the quantized loaders) over the
// card's memory rate; the work per byte is a few FMAs, far below the
// tensor-core line. Design against that bound: one CTA per (b, kv_head)
// holds the G grouped query rows, so each K/V row is read from device
// memory once for all G queries; rows are staged through shared memory
// in 64-position tiles with 16-byte coalesced loads (quantized rows are
// dequantized on the way in, so device reads stay at the quantized
// width); the online-softmax state (m, l, acc) stays in f32 registers and
// shared memory. Rows outside [lo, kv_len) are never read, so any S,
// kv_len = 0 and a sliding window need no padding.
//
// Numerics follow the Pallas kernels: q * scale is rounded to bf16,
// dequantized K/V values are rounded to bf16 (bf16(float(q) * scale)),
// scores and the PV product accumulate in f32, p is rounded to bf16
// before the PV product while l sums the unrounded p, and l == 0 (an
// empty row) is read as 1 so the output is 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kTile = 64;          // cache positions per shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr int kNotInstantiated = -1;  // no kernel for this (D, G)

enum Loader { kLoadBf16 = 0, kLoadQ8 = 1, kLoadQ4 = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Stage rows [t0, t0 + n) of one (b, kv_head) cache slice into a bf16
// shared tile with padded rows of ROW elements; rows >= n are zeroed.
// src points at the slice's row 0; scales at its scale row 0.
template <int LOADER, int D, int ROW>
__device__ __forceinline__ void load_tile(bf16* dst, const void* src,
                                          const bf16* scales, int ng,
                                          int t0, int n, int tid) {
  if (LOADER == kLoadBf16) {
    constexpr int kVec = D / 8;    // 8 bf16 per 16-byte vector
    const uint4* s = reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(src) + (size_t)t0 * D);
    for (int i = tid; i < kTile * kVec; i += kThreads) {
      const int j = i / kVec, c = i % kVec;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (j < n) u = s[(size_t)j * kVec + c];
      reinterpret_cast<uint4*>(dst + j * ROW)[c] = u;
    }
  } else {
    // q8_0: 16 features per 16-byte vector; q4_0: 32 (two per byte)
    constexpr int kPerVec = LOADER == kLoadQ8 ? 16 : 32;
    constexpr int kVec = D / kPerVec;
    constexpr int kRowBytes = LOADER == kLoadQ8 ? D : D / 2;
    const int g = D / ng;                       // features per scale
    const uint8_t* s = static_cast<const uint8_t*>(src) + (size_t)t0 * kRowBytes;
    for (int i = tid; i < kTile * kVec; i += kThreads) {
      const int j = i / kVec, c = i % kVec;
      alignas(16) bf16 vals[kPerVec];
      if (j < n) {
        const uint4 u = reinterpret_cast<const uint4*>(s + (size_t)j * kRowBytes)[c];
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&u);
        const bf16* sc = scales + (size_t)(t0 + j) * ng;
        const int f0 = c * kPerVec;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          if (LOADER == kLoadQ8) {
            const int f = f0 + e;
            const float q = (float)(int8_t)bytes[e];
            vals[e] = __float2bfloat16(q * __bfloat162float(sc[f / g]));
          } else {
            // low nibble = even feature, high nibble = odd; sign-extend
            const int lo = ((int)((uint32_t)bytes[e] << 28)) >> 28;
            const int hi = ((int)((uint32_t)bytes[e] << 24)) >> 28;
            const int f = f0 + 2 * e;
            vals[2 * e] = __float2bfloat16((float)lo * __bfloat162float(sc[f / g]));
            vals[2 * e + 1] =
                __float2bfloat16((float)hi * __bfloat162float(sc[(f + 1) / g]));
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < kPerVec; ++e) vals[e] = __float2bfloat16(0.f);
      }
      uint4* d = reinterpret_cast<uint4*>(dst + j * ROW + c * kPerVec);
#pragma unroll
      for (int e = 0; e < kPerVec / 8; ++e) d[e] = reinterpret_cast<const uint4*>(vals)[e];
    }
  }
}

template <int LOADER, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const bf16* __restrict__ q, const void* __restrict__ k,
                        const void* __restrict__ v, const bf16* __restrict__ k_scale,
                        const bf16* __restrict__ v_scale,
                        const int* __restrict__ kv_len, bf16* __restrict__ out,
                        int Hkv, int S, int ng, int window, float scale) {
  // padded rows: 16-byte aligned, and 16-byte reads of neighbouring rows
  // land on distinct banks
  constexpr int kRow = D + 8;
  constexpr int kRowBytes = LOADER == kLoadBf16 ? 2 * D : (LOADER == kLoadQ8 ? D : D / 2);
  constexpr int kAcc = (G * D + kThreads - 1) / kThreads;
  __shared__ __align__(16) bf16 ks[kTile * kRow];
  __shared__ __align__(16) bf16 vs[kTile * kRow];
  __shared__ float qs[G * D];
  __shared__ float ps[G * kTile];
  __shared__ float m_s[G], l_s[G], alpha_s[G];

  const int bh = blockIdx.x;                     // b * Hkv + kv_head
  const int b = bh / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // the G query heads of kv head h are heads h*G .. h*G+G-1
  const bf16* qb = q + (size_t)bh * G * D;
  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = round_bf16(__bfloat162float(qb[i]) * scale);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int len = max(0, min(kv_len[b], S));
  const int lo = window > 0 ? max(0, len - window) : 0;

  const uint8_t* kb = static_cast<const uint8_t*>(k) + (size_t)bh * S * kRowBytes;
  const uint8_t* vb = static_cast<const uint8_t*>(v) + (size_t)bh * S * kRowBytes;
  const bf16* ksb = LOADER == kLoadBf16 ? nullptr : k_scale + (size_t)bh * S * ng;
  const bf16* vsb = LOADER == kLoadBf16 ? nullptr : v_scale + (size_t)bh * S * ng;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = lo; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);
    load_tile<LOADER, D, kRow>(ks, kb, ksb, ng, t0, n, tid);
    load_tile<LOADER, D, kRow>(vs, vb, vsb, ng, t0, n, tid);
    __syncthreads();

    // scores s[g][j] = q_g . k_j (f32), masked past the tile's n rows
    for (int idx = tid; idx < G * kTile; idx += kThreads) {
      const int g = idx / kTile, j = idx % kTile;
      float s = kNegInf;
      if (j < n) {
        const uint4* kr = reinterpret_cast<const uint4*>(ks + j * kRow);
        const float* qg = qs + g * D;
        s = 0.f;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const uint4 u = kr[c];
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            s += qg[c * 8 + 2 * e] * f.x;
            s += qg[c * 8 + 2 * e + 1] * f.y;
          }
        }
      }
      ps[idx] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = kNegInf;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, ps[g * kTile + j]);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = j < n ? expf(ps[g * kTile + j] - m_new) : 0.f;
        sum += p;
        ps[g * kTile + j] = round_bf16(p);
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * alpha + sum_j bf16(p[g][j]) * v[j][d]
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        const float* pg = ps + g * kTile;
        float a = 0.f;
        for (int j = 0; j < n; ++j) a += pg[j] * __bfloat162float(vs[j * kRow + d]);
        acc[i] = acc[i] * alpha_s[g] + a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < G * D) {
      const int g = idx / D, d = idx % D;
      float l = l_s[g];
      if (l == 0.f) l = 1.f;
      out[((size_t)bh * G + g) * D + d] = __float2bfloat16(acc[i] / l);
    }
  }
}

template <int LOADER, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const int* kv_len, void* out, int B, int Hkv,
                   int S, int ng, int window, float scale, cudaStream_t stream) {
  decode_attention_kernel<LOADER, D, G><<<B * Hkv, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), k, v, static_cast<const bf16*>(ks),
      static_cast<const bf16*>(vs), kv_len, static_cast<bf16*>(out), Hkv, S, ng,
      window, scale);
  return cudaGetLastError();
}

// The (head_dim, query heads per kv head) pairs of the configs the port
// serves: llama3.2-1b (64, 4), deepseek-7b (128, 1) and their reduced
// smoke versions (32, 2). A config with another pair adds it here.
template <int LOADER>
int dispatch(int D, int G, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const int* kv_len, void* out, int B,
             int Hkv, int S, int ng, int window, float scale, cudaStream_t st) {
  if (D == 64 && G == 4)
    return launch<LOADER, 64, 4>(q, k, v, ks, vs, kv_len, out, B, Hkv, S, ng, window, scale, st);
  if (D == 128 && G == 1)
    return launch<LOADER, 128, 1>(q, k, v, ks, vs, kv_len, out, B, Hkv, S, ng, window, scale, st);
  if (D == 32 && G == 2)
    return launch<LOADER, 32, 2>(q, k, v, ks, vs, kv_len, out, B, Hkv, S, ng, window, scale, st);
  return kNotInstantiated;
}

}  // namespace

// loader: 0 = bf16 cache, 1 = q8_0, 2 = q4_0. q (B, Hkv*G, D) bf16; k, v
// (B, Hkv, S, D) bf16 or int8 payload (B, Hkv, S, D) [q8_0] /
// (B, Hkv, S, D/2) [q4_0]; k_scale, v_scale (B, Hkv, S, ng) bf16 (null for
// bf16); kv_len (B,) int32; out (B, Hkv*G, D) bf16. Returns the launch's
// cudaError_t (0 on success), or -1 when no kernel is instantiated for
// (D, G).
extern "C" int decode_attention(int loader, const void* q, const void* k,
                                const void* v, const void* k_scale,
                                const void* v_scale, const void* kv_len, void* out,
                                int B, int Hkv, int G, int S, int D, int ng,
                                int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  switch (loader) {
    case kLoadBf16: return dispatch<kLoadBf16>(D, G, q, k, v, k_scale, v_scale, lens, out, B, Hkv, S, ng, window, scale, st);
    case kLoadQ8: return dispatch<kLoadQ8>(D, G, q, k, v, k_scale, v_scale, lens, out, B, Hkv, S, ng, window, scale, st);
    case kLoadQ4: return dispatch<kLoadQ4>(D, G, q, k, v, k_scale, v_scale, lens, out, B, Hkv, S, ng, window, scale, st);
  }
  return cudaErrorInvalidValue;
}
