// Single-token GQA decode attention over a KV cache, split along the
// cache (flash decoding), for sm_90a.
//
// Replaces the JAX package's Pallas kernels
//   src/repro/kernels/decode_attention.py:82        decode_attention (_decode_kernel; pallas_call :105)
//   src/repro/kernels/decode_attention_quant.py:119 decode_attention_quant (_decode_quant_kernel; :151)
// with one kernel templated on the K/V loader: bf16 rows, q8_0 rows, or
// q4_0 rows (int8 payload + bf16 groupwise scales, dequantized in shared
// memory).
//
// Bound: the cache bytes read (K and V rows [lo, kv_len) of each
// (batch, kv head), plus scales for the quantized loaders) over the
// card's memory rate; the work per byte is a few FMAs, far below the
// tensor-core line. Design against that bound: a grid of (B * Hkv,
// splits) CTAs, so a few slots with a short cache still spread over the
// SMs. Split s covers the absolute cache positions [s * split, (s + 1) *
// split) (split: a multiple of the 64-position tile, given by the
// caller); its CTA holds the G grouped query rows of one kv head, so
// each K/V row is read from device memory once for all G queries. K/V
// tiles of 64 positions stream through a two-stage shared-memory ring by
// cp.async, 16 bytes a thread (quantized payload and scales stay at
// their width in device memory and are dequantized from shared memory
// into a bf16 tile); the online-softmax state (m, l, acc) of the split
// stays in f32 registers and shared memory, and is written, unnormalized,
// to f32 scratch. The last CTA of each (b, kv head) to finish, found by
// an atomic ticket, merges the visible splits in split order and writes
// the output; a slot whose visible run lies in one split is normalized
// by that split's CTA, with no scratch and no ticket. CTAs of splits that
// hold no visible position return at once; split 0's CTA writes 0 for a
// slot that sees no position. Rows outside [lo, kv_len) are never read,
// so any S, kv_len = 0 and a sliding window need no padding.
//
// The split boundaries, the splits merged and their order depend on cache
// positions alone, never on B, S, other rows' kv_len or the SM count:
// a slot's output has the same bits whether it decodes alone or among
// other slots, in a cache of any length.
//
// Paged caches (the serving engine's block pool): K/V and scale leaves
// are pools (n_blocks, Hkv, P, .), and row b of a block table (B,
// max_pages) names the pool block of each page of P positions, so
// position pos of (b, kv head h) is row (table[b][pos / P] * Hkv + h) *
// P + pos % P. The loaders read through the table themselves: each
// tile's rows are copied row by row (16-byte vectors) from the blocks the
// table names, and the scales page run by page run, since they are
// contiguous only inside a page. Nothing is gathered into a dense view
// first (that would read and write the visible cache once more in every
// layer). Splits, tiles and merge order are those of the dense kernel
// over S = max_pages * P, so a paged slot has the bits of the dense
// kernel over the gathered view.
//
// Numerics follow the Pallas kernels: q * scale is rounded to bf16,
// dequantized K/V values are rounded to bf16 (bf16(float(q) * scale)),
// scores and the PV product accumulate in f32, p is rounded to bf16
// before the PV product while l sums the unrounded p, and a slot with no
// visible position gets 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTile = 64;          // cache positions per shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr int kNotInstantiated = -1;  // no kernel for this (D, G)

enum Loader { kLoadBf16 = 0, kLoadQ8 = 1, kLoadQ4 = 2 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes < 16 fills the rest with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr int round16(int b) { return (b + 15) / 16 * 16; }

// Shared memory of one CTA (bytes): q, scores, softmax state, bf16 K/V
// tiles (the two cp.async stages for bf16; one dequantized tile pair for
// the quantized loaders, beside two stages of raw payload and scales).
template <int LOADER, int D, int G>
struct Layout {
  static constexpr int kRow = D + 8;              // padded bf16 tile row
  static constexpr int kRowBytes = LOADER == kLoadBf16 ? 2 * D : (LOADER == kLoadQ8 ? D : D / 2);
  static constexpr int kQ = 0;
  static constexpr int kP = kQ + G * D * 4;
  static constexpr int kStat = kP + G * kTile * 4;
  static constexpr int kTiles = kStat + round16(3 * G * 4);
  static constexpr int kTileBytes = kTile * kRow * 2;
  static constexpr int kTileBufs = LOADER == kLoadBf16 ? 2 : 1;
  static constexpr int kRaw = kTiles + kTileBufs * 2 * kTileBytes;
  static constexpr int kPayload = kTile * kRowBytes;
  // one raw (K or V) buffer: payload, then the tile's scales copied from
  // the 16-byte boundary at or before them
  __host__ __device__ static int raw_bytes(int ng) {
    return kPayload + round16(kTile * ng * 2 + 16);
  }
  __host__ __device__ static int total(int ng) {
    return LOADER == kLoadBf16 ? kRaw : kRaw + 2 * 2 * raw_bytes(ng);
  }
};

// Start the cp.async copies of cache rows [t0, t0 + n) of one (b, kv
// head) slice: src/scales point at the slice's row 0; sc_total: bytes of
// the whole scale tensor (copies past it are cut short).
template <int LOADER, int D, int G>
__device__ __forceinline__ void copy_tile(uint8_t* dst, const uint8_t* src,
                                          const bf16* scales, size_t sc_row0,
                                          size_t sc_total, int ng, int t0, int n,
                                          int tid) {
  using L = Layout<LOADER, D, G>;
  if (LOADER == kLoadBf16) {
    constexpr int kVec = D / 8;
    const uint8_t* s = src + (size_t)t0 * L::kRowBytes;
    for (int i = tid; i < n * kVec; i += kThreads) {
      const int j = i / kVec, c = i % kVec;
      cp_async16(dst + j * L::kRow * 2 + 16 * c, s + (size_t)j * L::kRowBytes + 16 * c, 16);
    }
  } else {
    const uint8_t* s = src + (size_t)t0 * L::kRowBytes;
    for (int i = tid; i < n * L::kRowBytes / 16; i += kThreads)
      cp_async16(dst + 16 * i, s + 16 * i, 16);
    const size_t b0 = 2 * (sc_row0 + (size_t)t0) * ng;     // first scale byte
    const size_t a0 = b0 & ~(size_t)15;
    const int nvec = (int)((b0 - a0 + 2 * (size_t)n * ng + 15) / 16);
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(scales);
    for (int i = tid; i < nvec; i += kThreads) {
      const size_t at = a0 + 16 * (size_t)i;
      const int valid = at >= sc_total ? 0 : (int)(sc_total - at < 16 ? sc_total - at : 16);
      cp_async16(dst + L::kPayload + 16 * i, valid ? sb + at : sb, valid);
    }
  }
}

// Pool row of position pos of kv head h, through the slot's block-table
// row tbl (max_pages entries of P positions).
__device__ __forceinline__ size_t paged_row(const int* tbl, int Hkv, int h, int P, int pos) {
  return ((size_t)__ldg(tbl + pos / P) * Hkv + h) * P + pos % P;
}

// copy_tile for a paged cache: rows [t0, t0 + n) of kv head h, each from
// the pool block its page maps to; src and scales point at the pools.
// The quantized scales (2 * ng bytes a row) are contiguous only inside a
// page: the caller guarantees that every page run of a tile starts on a
// 16-byte boundary (t0 a multiple of 64 and gcd(64, P) * 2 * ng a
// multiple of 16), so no 16-byte vector straddles two pages and the tile's
// scales land at raw + kPayload + j * 2 * ng, as the dense copy with an
// aligned start puts them.
template <int LOADER, int D, int G>
__device__ __forceinline__ void copy_tile_paged(uint8_t* dst, const uint8_t* src,
                                                const bf16* scales, const int* tbl,
                                                int Hkv, int h, int P, int ng, int t0,
                                                int n, int tid) {
  using L = Layout<LOADER, D, G>;
  constexpr int kVec = L::kRowBytes / 16;            // 16-byte vectors a row
  constexpr int kDstRow = LOADER == kLoadBf16 ? L::kRow * 2 : L::kRowBytes;
  for (int i = tid; i < n * kVec; i += kThreads) {
    const int j = i / kVec, c = i % kVec;
    const size_t r = paged_row(tbl, Hkv, h, P, t0 + j);
    cp_async16(dst + j * kDstRow + 16 * c, src + r * L::kRowBytes + 16 * c, 16);
  }
  if (LOADER != kLoadBf16) {
    const int sbytes = 2 * ng;
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(scales);
    for (int i = tid; i < (n * sbytes + 15) / 16; i += kThreads) {
      const int j = 16 * i / sbytes;                 // first row of the vector
      const size_t r = paged_row(tbl, Hkv, h, P, t0 + j);
      cp_async16(dst + L::kPayload + 16 * i, sb + r * sbytes + (16 * i - j * sbytes), 16);
    }
  }
}

// Dequantize raw rows [0, n) of one stage into a bf16 tile of padded rows.
template <int LOADER, int D, int G>
__device__ __forceinline__ void dequant_tile(bf16* dst, const uint8_t* raw,
                                             size_t sc_byte0, int ng, int n, int tid) {
  using L = Layout<LOADER, D, G>;
  constexpr int kPerVec = LOADER == kLoadQ8 ? 16 : 32;   // features per 16 bytes
  constexpr int kVec = D / kPerVec;
  const bf16* sc = reinterpret_cast<const bf16*>(raw + L::kPayload + (sc_byte0 & 15));
  const int g = D / ng;                                  // features per scale
  for (int i = tid; i < n * kVec; i += kThreads) {
    const int j = i / kVec, c = i % kVec;
    const uint4 u = reinterpret_cast<const uint4*>(raw + j * L::kRowBytes)[c];
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&u);
    const bf16* scj = sc + j * ng;
    const int f0 = c * kPerVec;
    // the vector's features share one scale when groups hold whole vectors
    const bool one_scale = g % kPerVec == 0;
    const float s0 = __bfloat162float(scj[f0 / g]);
    alignas(16) bf16 vals[kPerVec];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (LOADER == kLoadQ8) {
        const int f = f0 + e;
        const float sf = one_scale ? s0 : __bfloat162float(scj[f / g]);
        vals[e] = __float2bfloat16((float)(int8_t)bytes[e] * sf);
      } else {
        // low nibble = even feature, high nibble = odd; sign-extend
        const int lo = ((int)((uint32_t)bytes[e] << 28)) >> 28;
        const int hi = ((int)((uint32_t)bytes[e] << 24)) >> 28;
        const int f = f0 + 2 * e;
        const float slo = one_scale ? s0 : __bfloat162float(scj[f / g]);
        const float shi = one_scale ? s0 : __bfloat162float(scj[(f + 1) / g]);
        vals[2 * e] = __float2bfloat16((float)lo * slo);
        vals[2 * e + 1] = __float2bfloat16((float)hi * shi);
      }
    }
    uint4* d = reinterpret_cast<uint4*>(dst + j * L::kRow + f0);
#pragma unroll
    for (int e = 0; e < kPerVec / 8; ++e) d[e] = reinterpret_cast<const uint4*>(vals)[e];
  }
}

// grid: (B * Hkv, splits). CTA (bh, s) attends over positions
// [max(lo, s * split), min(kv_len, (s + 1) * split)). Where the slot's
// visible run spans splits s0..s1 (s0 < s1), it writes its unnormalized
// acc (G * D), then m (G) and l (G), to part, and takes a ticket; the
// CTA that takes the last ticket merges splits s0..s1 in order, writes
// out (B * Hkv, G, D) and sets the ticket count back to 0 for the next
// launch.
template <int LOADER, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_split_kernel(const bf16* __restrict__ q, const void* __restrict__ k,
                              const void* __restrict__ v, const bf16* __restrict__ k_scale,
                              const bf16* __restrict__ v_scale,
                              const int* __restrict__ kv_len, bf16* __restrict__ out,
                              float* __restrict__ part, unsigned* __restrict__ tickets,
                              const int* __restrict__ table, int max_pages, int P,
                              int Hkv, int S, int ng, int window, int split,
                              float scale) {
  using L = Layout<LOADER, D, G>;
  constexpr int kRow = L::kRow;
  constexpr int kAcc = (G * D + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  float* ps = reinterpret_cast<float*>(smem + L::kP);
  float* m_s = reinterpret_cast<float*>(smem + L::kStat);
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;

  const int bh = blockIdx.x;                     // b * Hkv + kv_head
  const int b = bh / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int len = max(0, min(kv_len[b], S));
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int sp = blockIdx.y;
  bf16* ob = out + (size_t)bh * G * D;
  if (len <= lo) {                               // the slot sees nothing
    if (sp == 0)
      for (int i = tid; i < G * D; i += kThreads) ob[i] = __float2bfloat16(0.f);
    return;
  }
  const int s0 = lo / split, s1 = (len - 1) / split;   // visible splits
  if (sp < s0 || sp > s1) return;
  const int t_lo = max(lo, sp * split);
  const int t_hi = min(len, sp * split + split);

  // paged: the pools and the slot's table row; dense: the (b, h) slice
  const int* tbl = table == nullptr ? nullptr : table + (size_t)b * max_pages;
  const int h = bh - b * Hkv;
  const size_t slice = tbl == nullptr ? (size_t)bh * S : 0;
  const uint8_t* kb = static_cast<const uint8_t*>(k) + slice * L::kRowBytes;
  const uint8_t* vb = static_cast<const uint8_t*>(v) + slice * L::kRowBytes;
  const size_t sc_row0 = slice;
  const size_t sc_total = (size_t)gridDim.x * S * ng * 2;
  uint8_t* tiles = smem + L::kTiles;
  uint8_t* raw = smem + L::kRaw;
  auto fetch = [&](int i) {                      // tile i into stage i & 1
    const int t0 = t_lo + i * kTile, n = min(kTile, t_hi - t0);
    if (LOADER == kLoadBf16) {
      uint8_t* st = tiles + (i & 1) * 2 * L::kTileBytes;
      if (tbl != nullptr) {
        copy_tile_paged<LOADER, D, G>(st, kb, nullptr, tbl, Hkv, h, P, 0, t0, n, tid);
        copy_tile_paged<LOADER, D, G>(st + L::kTileBytes, vb, nullptr, tbl, Hkv, h, P, 0,
                                      t0, n, tid);
      } else {
        copy_tile<LOADER, D, G>(st, kb, nullptr, 0, 0, 0, t0, n, tid);
        copy_tile<LOADER, D, G>(st + L::kTileBytes, vb, nullptr, 0, 0, 0, t0, n, tid);
      }
    } else {
      uint8_t* st = raw + (i & 1) * 2 * L::raw_bytes(ng);
      if (tbl != nullptr) {
        copy_tile_paged<LOADER, D, G>(st, kb, k_scale, tbl, Hkv, h, P, ng, t0, n, tid);
        copy_tile_paged<LOADER, D, G>(st + L::raw_bytes(ng), vb, v_scale, tbl, Hkv, h, P,
                                      ng, t0, n, tid);
      } else {
        copy_tile<LOADER, D, G>(st, kb, k_scale, sc_row0, sc_total, ng, t0, n, tid);
        copy_tile<LOADER, D, G>(st + L::raw_bytes(ng), vb, v_scale, sc_row0, sc_total,
                                 ng, t0, n, tid);
      }
    }
    cp_async_commit();
  };
  fetch(0);

  // the G query heads of kv head h are heads h*G .. h*G+G-1
  const bf16* qb = q + (size_t)bh * G * D;
  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = round_bf16(__bfloat162float(qb[i]) * scale);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const int ntiles = (t_hi - t_lo + kTile - 1) / kTile;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = t_lo + it * kTile, n = min(kTile, t_hi - t0);
    if (it + 1 < ntiles) {
      fetch(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bf16* ks;
    const bf16* vs;
    if (LOADER == kLoadBf16) {
      ks = reinterpret_cast<const bf16*>(tiles + (it & 1) * 2 * L::kTileBytes);
      vs = ks + kTile * kRow;
    } else {
      bf16* kd = reinterpret_cast<bf16*>(tiles);
      bf16* vd = kd + kTile * kRow;
      const uint8_t* st = raw + (it & 1) * 2 * L::raw_bytes(ng);
      // the paged copy puts the tile's first scale at the stage's start
      const size_t b0 = tbl == nullptr ? 2 * (sc_row0 + (size_t)t0) * ng : 0;
      dequant_tile<LOADER, D, G>(kd, st, b0, ng, n, tid);
      dequant_tile<LOADER, D, G>(vd, st + L::raw_bytes(ng), b0, ng, n, tid);
      __syncthreads();
      ks = kd;
      vs = vd;
    }

    // scores s[g][j] = q_g . k_j (f32), masked past the tile's n rows
    for (int idx = tid; idx < G * kTile; idx += kThreads) {
      const int g = idx / kTile, j = idx % kTile;
      float s = kNegInf;
      if (j < n) {
        const uint4* kr = reinterpret_cast<const uint4*>(ks + j * kRow);
        const float* qg = qs + g * D;
        // four partial sums (features e mod 4), added pairwise at the end
        float p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const uint4 u = kr[c];
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            p4[(2 * e) % 4] += qg[c * 8 + 2 * e] * f.x;
            p4[(2 * e + 1) % 4] += qg[c * 8 + 2 * e + 1] * f.y;
          }
        }
        s = (p4[0] + p4[1]) + (p4[2] + p4[3]);
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
        // four partial sums (positions j mod 4); rows past n have p = 0
        // but may hold stale values, so the tail is summed alone
        float a4[4] = {0.f, 0.f, 0.f, 0.f};
        const int n4 = n & ~3;
        for (int j = 0; j < n4; j += 4) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a4[e] += pg[j + e] * __bfloat162float(vs[(j + e) * kRow + d]);
        }
        if constexpr (D > 128) {
          // (the tail's index into a4 static: indexed by j - n4, ptxas
          // kept a4 in local memory at (256, 10); the same sums)
#pragma unroll
          for (int e = 0; e < 3; ++e)
            if (n4 + e < n)
              a4[e] += pg[n4 + e] * __bfloat162float(vs[(n4 + e) * kRow + d]);
        } else {
          for (int j = n4; j < n; ++j) a4[j - n4] += pg[j] * __bfloat162float(vs[j * kRow + d]);
        }
        acc[i] = acc[i] * alpha_s[g] + ((a4[0] + a4[1]) + (a4[2] + a4[3]));
      }
    }
    __syncthreads();            // this stage, ps and the state are reused next tile
  }

  if (s0 == s1) {                                // one visible split: done here
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G * D) ob[idx] = __float2bfloat16(acc[i] / l_s[idx / D]);
    }
    return;
  }
  float* pb = part + (size_t)bh * gridDim.y * G * (D + 2);
  float* po = pb + (size_t)sp * G * (D + 2);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < G * D) po[idx] = acc[i];
  }
  if (tid < G) {
    po[G * D + tid] = m_s[tid];
    po[G * D + G + tid] = l_s[tid];
  }
  // publish the partials, then take a ticket; the last of the s1 - s0 + 1
  // visible splits to arrive merges them
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (tid == 0) {
    last = atomicAdd(tickets + bh, 1u) == (unsigned)(s1 - s0);
    if (last) tickets[bh] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float m = kNegInf, l = 0.f, a = 0.f;
    for (int s = s0; s <= s1; ++s) {
      const float* pp = pb + (size_t)s * G * (D + 2);
      const float ms = __ldcg(pp + G * D + g), ls = __ldcg(pp + G * D + G + g);
      const float as = __ldcg(pp + idx);
      const float m_new = fmaxf(m, ms);
      const float c_old = expf(m - m_new), c_new = expf(ms - m_new);
      l = l * c_old + ls * c_new;
      a = a * c_old + as * c_new;
      m = m_new;
    }
    ob[idx] = __float2bfloat16(a / l);
  }
}

template <int LOADER, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const int* kv_len, void* out, float* part,
                   unsigned* tickets, const int* table, int max_pages, int P, int B,
                   int Hkv, int S, int ng, int window, int split, float scale,
                   cudaStream_t stream) {
  using L = Layout<LOADER, D, G>;
  auto kernel = decode_attention_split_kernel<LOADER, D, G>;
  const int smem = L::total(ng);
  static int smem_set = 48 * 1024;     // once per instantiation and size (one device)
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const int splits = (S + split - 1) / split;
  kernel<<<dim3(B * Hkv, splits), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), k, v, static_cast<const bf16*>(ks),
      static_cast<const bf16*>(vs), kv_len, static_cast<bf16*>(out), part, tickets, table,
      max_pages, P, Hkv, S, ng, window, split, scale);
  return cudaGetLastError();
}

// The (head_dim, query heads per kv head) pairs of the configs the port
// serves: llama3.2-1b (64, 4), qwen2-0.5b (64, 7), qwen2-1.5b (128, 6),
// llama3.2-3b (128, 3), llama3.1-8b, mistral-7b and mistral-nemo-12b
// (128, 4), deepseek-7b (128, 1), deepseek-67b and qwen1.5-110b (128, 8;
// kimi-k2's attention too), recurrentgemma-2b's local attention (256, 10;
// one kv head, so the splits along the cache are what spreads a few slots
// over the SMs), and the reduced smoke versions (32, 2). A config with
// another pair adds it here. Nothing in the kernel asks G to be a power of
// two: the loops over the G * D query elements and the G
// query rows stride by the CTA's threads and warps and test their bounds,
// and the shared memory's carve rounds the 3 * G softmax state to 16
// bytes.
template <int LOADER>
int dispatch(int D, int G, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const int* kv_len, void* out, float* part,
             unsigned* tk, const int* tb, int mp, int P, int B, int Hkv, int S, int ng,
             int window, int split, float scale, cudaStream_t st) {
  if (D == 64 && G == 4)
    return launch<LOADER, 64, 4>(q, k, v, ks, vs, kv_len, out, part, tk, tb, mp, P, B, Hkv, S, ng, window, split, scale, st);
  if (D == 128 && G == 1)
    return launch<LOADER, 128, 1>(q, k, v, ks, vs, kv_len, out, part, tk, tb, mp, P, B, Hkv, S, ng, window, split, scale, st);
  if (D == 32 && G == 2)
    return launch<LOADER, 32, 2>(q, k, v, ks, vs, kv_len, out, part, tk, tb, mp, P, B, Hkv, S, ng, window, split, scale, st);
  if (D == 64 && G == 7)
    return launch<LOADER, 64, 7>(q, k, v, ks, vs, kv_len, out, part, tk, tb, mp, P, B, Hkv, S, ng, window, split, scale, st);
  if (D == 128 && G == 6)
    return launch<LOADER, 128, 6>(q, k, v, ks, vs, kv_len, out, part, tk, tb, mp, P, B, Hkv, S, ng, window, split, scale, st);
  if (D == 128 && G == 3)
    return launch<LOADER, 128, 3>(q, k, v, ks, vs, kv_len, out, part, tk, tb, mp, P, B, Hkv, S, ng, window, split, scale, st);
  if (D == 128 && G == 4)
    return launch<LOADER, 128, 4>(q, k, v, ks, vs, kv_len, out, part, tk, tb, mp, P, B, Hkv, S, ng, window, split, scale, st);
  if (D == 128 && G == 8)
    return launch<LOADER, 128, 8>(q, k, v, ks, vs, kv_len, out, part, tk, tb, mp, P, B, Hkv, S, ng, window, split, scale, st);
  if (D == 256 && G == 10)
    return launch<LOADER, 256, 10>(q, k, v, ks, vs, kv_len, out, part, tk, tb, mp, P, B, Hkv, S, ng, window, split, scale, st);
  return kNotInstantiated;
}

}  // namespace

// loader: 0 = bf16 cache, 1 = q8_0, 2 = q4_0. q (B, Hkv*G, D) bf16; k, v
// (B, Hkv, S, D) bf16 or int8 payload (B, Hkv, S, D) [q8_0] /
// (B, Hkv, S, D/2) [q4_0]; k_scale, v_scale (B, Hkv, S, ng) bf16 (null for
// bf16); kv_len (B,) int32; out (B, Hkv*G, D) bf16; part: f32 scratch of
// part_elems >= B * Hkv * ceil(S / split) * G * (D + 2); tickets: int32
// counts of ticket_elems >= B * Hkv, all 0 before the launch and left 0
// after it (launches that share them must not overlap); split: cache
// positions per split, a positive multiple of 64. A paged cache passes
// its block table (B, max_pages) int32 as table, with k, v (n_blocks,
// Hkv, P, .) and the scales (n_blocks, Hkv, P, ng) as pools, S =
// max_pages * P, window 0, and under q8_0 / q4_0 gcd(64, P) * 2 * ng a
// multiple of 16; table null means a dense cache. Returns the first
// failing launch's cudaError_t (0 on success), or -1 when no kernel is
// instantiated for (D, G).
extern "C" int decode_attention(int loader, const void* q, const void* k,
                                const void* v, const void* k_scale,
                                const void* v_scale, const void* kv_len, void* out,
                                void* part, long long part_elems, void* tickets,
                                int ticket_elems, const void* table, int max_pages,
                                int P, int B, int Hkv, int G, int S, int D, int ng,
                                int window, int split, float scale, void* stream) {
  if (split <= 0 || split % kTile) return cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(table);
  if (tb != nullptr) {
    if (window != 0 || P <= 0 || max_pages <= 0 || S != max_pages * P)
      return cudaErrorInvalidValue;
    int gcd = P & -P;                              // gcd(64, P): P's lowest set bit,
    if (gcd > kTile) gcd = kTile;                  // capped at 64
    if (loader != kLoadBf16 && gcd * 2 * ng % 16) return cudaErrorInvalidValue;
  }
  const long long need = (long long)B * Hkv * ((S + split - 1) / split) * G * (D + 2);
  if (part_elems < need || ticket_elems < B * Hkv) return cudaErrorInvalidValue;
  unsigned* tk = static_cast<unsigned*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  float* p = static_cast<float*>(part);
  switch (loader) {
    case kLoadBf16: return dispatch<kLoadBf16>(D, G, q, k, v, k_scale, v_scale, lens, out, p, tk, tb, max_pages, P, B, Hkv, S, ng, window, split, scale, st);
    case kLoadQ8: return dispatch<kLoadQ8>(D, G, q, k, v, k_scale, v_scale, lens, out, p, tk, tb, max_pages, P, B, Hkv, S, ng, window, split, scale, st);
    case kLoadQ4: return dispatch<kLoadQ4>(D, G, q, k, v, k_scale, v_scale, lens, out, p, tk, tb, max_pages, P, B, Hkv, S, ng, window, split, scale, st);
  }
  return cudaErrorInvalidValue;
}
