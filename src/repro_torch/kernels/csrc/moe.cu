// Mixture-of-experts FFN kernels for sm_90a: the router's top-k and
// dispatch, the grouped expert GEMMs and the combine.
//
// No Pallas kernel of the JAX package stands behind them: its
// src/repro/models/moe.py:63 moe_forward computes the MoE FFN with
// jnp.einsum outside any kernel. Each expert GEMM there is one batched
// einsum over all E experts, each padded to the capacity C (moe.py:107-
// 116), so every step streams every expert's weights. These kernels
// compute the same function but skip what is never gathered back: experts
// that no token was routed to, and rows past each expert's count.
//
// moe_router_kernel (moe.py:74): the router's f32 logits (T, E) of x (T,
// D) bf16 and w (D, E) bf16, each product exact in f32 and summed in f32
// in one fixed order: CTA (token, 8 experts), thread i summing d = i +
// 128 j by fma in j order, then the warps' xor trees and the 4 warps in
// order. A token's logits do not depend on T: the library's f32 product
// sums a row differently at M 1 and M 4 on the H100, which would make a
// request's routing, and so its stream, depend on its batch-mates.
// Bound: the bytes of x and w (w stays in L2 across tokens).
//
// moe_route_kernel (moe.py:73-97): one CTA. Each warp takes tokens in
// turn: the f32 softmax of the router logits (T, E), the top K chosen on
// the logits (softmax is monotone; equal values go to the lower expert
// id, as jax.lax.top_k orders them), the chosen probabilities divided by
// max(their sum, 1e-9). Then warp 0 walks the T*K (token, k) pairs in
// flat order, 32 at a time, and gives each its rank among the pairs of
// its expert (__match_any_sync within the 32, a running count a expert
// before them): the slot that the stable argsort and searchsorted of
// moe.py:88-97 give. A kept pair (slot < C) writes its token into the
// (E, C) gather map; counts[e] = min(pairs of e, C). Bound: launch
// latency at decode (a few hundred logits), the serial walk at prefill
// (T*K/32 steps).
//
// moe_gemm_kernel (moe.py:107-116): out[g, c] for the rows c < counts[g]
// of each group g (an expert, or the shared experts as one group of T
// rows), CTAs of other rows and of empty groups exit at once. GLU: the
// gate-up product of the rows of a gathered through the map (or rows g*C
// + c without one) with w (G, K, 2F), h = bf16(silu(g) * u) of the f32
// sums; else y = bf16(rows @ w (G, K, N)). Bound: at decode (a few rows
// an expert) the bytes of the routed experts' weights; at prefill (a few
// hundred rows an expert) the tensor cores. Design: the product is taken
// transposed, out^T = w^T rows^T, so the weights are the A operand of
// mma.sync.m16n8k16 (bf16 in, f32 accumulate; ldmatrix.trans from the
// (k, n) tile in shared memory) and the rows the B operand, 8 at a time.
// A CTA owns 64 output columns (GLU: the gate block and the up block of
// the same columns, so the SwiGLU is a register epilogue) of MT rows (8
// at decode, 128 at prefill: 4 warps, or 4 x 2), and streams its weight
// columns through a 4-stage cp.async ring of 32-k tiles, once for all
// its rows. Each output element is summed by the same mma instructions
// in the same k order at the same position of its m16 tile, whatever MT,
// the count or the other rows: a row's bits do not depend on them.
//
// moe_combine_kernel (moe.py:119-125, 136-139): out[t] = bf16(sum over k
// in order of gate[t, k] * f32(y[e_tk, slot_tk])), a dropped pair adding
// 0, each product and sum rounded once (no fma contraction), then + the
// shared experts' output in bf16 (rounded once). Bound: bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRouteThreads = 512;
constexpr int kMaxK = 8;            // experts a token (kimi-k2's top-8)
constexpr int kMaxPerLane = 32;     // E <= 1024: one bit a logit in a lane's mask
constexpr int kBK = 32;             // k rows a stage
constexpr int kStages = 4;
constexpr int kBN = 64;             // output columns a CTA
constexpr int kCombineThreads = 128;
constexpr int kRouterThreads = 128;
constexpr int kRouterExperts = 8;   // logits a router CTA computes

// ---------------------------------------------------------------- route --
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kRouterThreads)
    moe_router_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      float* __restrict__ logits, int D, int E) {
  __shared__ float part[kRouterThreads / 32][kRouterExperts];
  const int groups = E / kRouterExperts;
  const int t = blockIdx.x / groups, e0 = (blockIdx.x % groups) * kRouterExperts;
  float acc[kRouterExperts] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int d = threadIdx.x; d < D; d += kRouterThreads) {
    const float xv = __bfloat162float(x[(size_t)t * D + d]);
    const uint4 raw = *reinterpret_cast<const uint4*>(w + (size_t)d * E + e0);
    const bf16* wv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < kRouterExperts; ++i)
      acc[i] = __fmaf_rn(xv, __bfloat162float(wv[i]), acc[i]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRouterExperts; ++i) {
    acc[i] = warp_sum(acc[i]);
    if (lane == 0) part[warp][i] = acc[i];
  }
  __syncthreads();
  if (threadIdx.x < kRouterExperts) {
    float v = part[0][threadIdx.x];
    for (int k = 1; k < kRouterThreads / 32; ++k) v = __fadd_rn(v, part[k][threadIdx.x]);
    logits[(size_t)t * E + e0 + threadIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kRouteThreads)
    moe_route_kernel(const float* __restrict__ logits, int T, int E, int K, int C,
                     float* __restrict__ gates, int* __restrict__ experts,
                     int* __restrict__ slots, int* __restrict__ counts,
                     int* __restrict__ src, unsigned long long* __restrict__ reads) {
  extern __shared__ int cnt[];  // pairs routed to each expert so far
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int e = threadIdx.x; e < E; e += blockDim.x) cnt[e] = 0;

  for (int t = warp; t < T; t += warps) {
    const float* row = logits + (size_t)t * E;
    float m = -INFINITY;
    for (int e = lane; e < E; e += 32) m = fmaxf(m, row[e]);
    m = warp_max(m);
    float s = 0.f;
    for (int e = lane; e < E; e += 32) s += expf(row[e] - m);
    s = warp_sum(s);
    uint32_t taken = 0;  // bit j: logit lane + 32 j chosen
    float g[kMaxK];
    int idx[kMaxK];
    float gsum = 0.f;
    for (int k = 0; k < K; ++k) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int j = 0, e = lane; e < E; ++j, e += 32) {
        const float v = row[e];
        if (!((taken >> j) & 1u) && (v > bv || (v == bv && e < bi))) {
          bv = v;
          bi = e;
        }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (bi >= E) bi = 0;  // only NaN logits left: keep the index in range
      if ((bi & 31) == lane) taken |= 1u << (bi >> 5);
      idx[k] = bi;
      g[k] = __fdiv_rn(expf(row[bi] - m), s);
      gsum = __fadd_rn(gsum, g[k]);
    }
    const float den = fmaxf(gsum, 1e-9f);
    if (lane == 0)
      for (int k = 0; k < K; ++k) {
        experts[t * K + k] = idx[k];
        gates[t * K + k] = __fdiv_rn(g[k], den);
      }
  }
  __syncthreads();  // the experts written above are visible to the block

  if (warp == 0) {
    const int P = T * K;
    for (int base = 0; base < P; base += 32) {
      const int i = base + lane;
      const int e = i < P ? experts[i] : -1 - lane;  // idle lanes match no one
      const unsigned peers = __match_any_sync(0xffffffffu, e);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const int start = i < P ? cnt[e] : 0;
      __syncwarp();
      if (i < P) {
        const int slot = start + rank;
        slots[i] = slot;
        if (slot < C) src[e * C + slot] = i / K;
        if (rank == __popc(peers) - 1) cnt[e] = start + __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) counts[e] = min(cnt[e], C);
  if (reads != nullptr && threadIdx.x == 0) {
    unsigned long long used = 0;
    for (int e = 0; e < E; ++e) used += cnt[e] > 0;
    atomicAdd(reads, used);        // experts whose weights a GEMM streams
    atomicAdd(reads + 1, 1ull);    // MoE layer passes
  }
}

// ----------------------------------------------------------------- gemm --
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col); gid = lane / 4,
// tig = lane % 4: a = {(gid, 2tig..+1), (gid + 8, 2tig..+1), (gid, 2tig +
// 8..+9), (gid + 8, 2tig + 8..+9)}, b = {(k 2tig..+1, n gid), (k 2tig +
// 8..+9, n gid)}, c = {(gid, 2tig), (gid, 2tig + 1), (gid + 8, 2tig), (gid
// + 8, 2tig + 1)}.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The CTA's shape for MT rows: warps 4 along the columns (16 output
// columns each) by MT / 64 along the rows (or one at MT 8). A stage holds
// the weight tile (kBK rows of WC columns: the gate block then the up
// block under GLU) and the rows' tile (MT rows of kBK k), each row padded
// by 16 bytes so that ldmatrix's eight row addresses fall in distinct
// banks.
template <int MT, bool GLU>
struct Gemm {
  static constexpr int kWarpsM = MT >= 64 ? MT / 64 : 1;
  static constexpr int kThreads = 32 * 4 * kWarpsM;
  static constexpr int kN8 = MT / kWarpsM / 8;   // n8 tiles of rows a warp
  static constexpr int kMI = GLU ? 2 : 1;        // m16 tiles a warp: gate (and up)
  static constexpr int kWC = kBN * kMI;          // weight columns a stage
  static constexpr int kWPitch = kWC * 2 + 16;   // bytes
  static constexpr int kXPitch = kBK * 2 + 16;
  static constexpr int kStage = kBK * kWPitch + MT * kXPitch;
  static constexpr int kSmem = kStages * kStage;
};

template <int MT, bool GLU>
__device__ __forceinline__ void load_stage(uint8_t* st, const bf16* __restrict__ a,
                                           const int* __restrict__ map,
                                           const bf16* __restrict__ w, int g, int C, int cnt,
                                           int K, int N, int k0, int n0, int m0) {
  using G = Gemm<MT, GLU>;
  const int wn = GLU ? 2 * N : N;                // a weight row's columns
  const bf16* wg = w + (size_t)g * K * wn;
  constexpr int kChunksW = kBK * G::kWC / 8;
  constexpr int kPerRow = G::kWC / 8;
  for (int c = threadIdx.x; c < kChunksW; c += G::kThreads) {
    const int r = c / kPerRow, q = c % kPerRow;
    const int col = n0 + (q % 8) * 8;            // 8 chunks of 8 columns a block
    const bool ok = k0 + r < K && col < N;
    const int gcol = (GLU && q >= 8) ? N + col : col;
    const bf16* p = ok ? wg + (size_t)(k0 + r) * wn + gcol : w;
    cp_async16(st + r * G::kWPitch + q * 16, p, ok ? 16 : 0);
  }
  uint8_t* xs = st + kBK * G::kWPitch;
  for (int c = threadIdx.x; c < MT * 4; c += G::kThreads) {
    const int i = c >> 2, q = c & 3;
    const int row = m0 + i;
    const bool ok = row < cnt && k0 + q * 8 < K;
    const bf16* p = a;
    if (ok) {
      const int ar = map != nullptr ? map[g * C + row] : g * C + row;
      p = a + (size_t)ar * K + k0 + q * 8;
    }
    cp_async16(xs + i * G::kXPitch + q * 16, p, ok ? 16 : 0);
  }
}

// out (G, C, N) bf16, rows c < counts[g] (all C rows without counts).
// GLU: N = F, w (G, K, 2F), out = silu(gate) * up; else w (G, K, N).
template <int MT, bool GLU>
__global__ void __launch_bounds__(Gemm<MT, GLU>::kThreads)
    moe_gemm_kernel(const bf16* __restrict__ a, const int* __restrict__ map,
                    const bf16* __restrict__ w, const int* __restrict__ counts,
                    bf16* __restrict__ out, int C, int K, int N) {
  using G = Gemm<MT, GLU>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int g = blockIdx.z;
  const int cnt = counts != nullptr ? counts[g] : C;
  const int m0 = blockIdx.x * MT, n0 = blockIdx.y * kBN;
  if (m0 >= cnt) return;  // an empty expert, or rows past its count
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warp_n = warp & 3, warp_m = warp >> 2;
  const int nk = (K + kBK - 1) / kBK;

  float acc[G::kMI][G::kN8][4];
#pragma unroll
  for (int mi = 0; mi < G::kMI; ++mi)
#pragma unroll
    for (int j = 0; j < G::kN8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<MT, GLU>(smem + s * G::kStage, a, map, w, g, C, cnt, K, N, s * kBK, n0, m0);
    cp_async_commit();
  }
  // this lane's ldmatrix row addresses: A (trans) k row and column offset,
  // B row and k chunk
  const int a_k = (lane & 7) + ((lane >> 4) << 3), a_c = ((lane >> 3) & 1) * 8;
  const int b_r = lane & 7, b_q = (lane >> 3) & 1;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < nk)
      load_stage<MT, GLU>(smem + (nxt % kStages) * G::kStage, a, map, w, g, C, cnt, K, N,
                          nxt * kBK, n0, m0);
    cp_async_commit();
    const uint8_t* ws = smem + (kt % kStages) * G::kStage;
    const uint8_t* xs = ws + kBK * G::kWPitch;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t af[G::kMI][4];
#pragma unroll
      for (int mi = 0; mi < G::kMI; ++mi)
        ldmatrix_x4_trans(af[mi], ws + (kk * 16 + a_k) * G::kWPitch +
                                      (mi * kBN + warp_n * 16 + a_c) * 2);
#pragma unroll
      for (int j = 0; j < G::kN8; ++j) {
        uint32_t b0, b1;
        const int r = (warp_m * G::kN8 + j) * 8 + b_r;
        ldmatrix_x2(b0, b1, xs + r * G::kXPitch + (kk * 2 + b_q) * 16);
#pragma unroll
        for (int mi = 0; mi < G::kMI; ++mi) mma_bf16(acc[mi][j], af[mi], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < G::kN8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + (warp_m * G::kN8 + j) * 8 + 2 * tig + (i & 1);
      const int col = n0 + warp_n * 16 + gid + (i >> 1) * 8;
      if (row >= cnt || col >= N) continue;
      float v = acc[0][j][i];
      if (GLU) {
        const float s = __fdiv_rn(v, __fadd_rn(1.f, expf(-v)));
        v = __fmul_rn(s, acc[G::kMI - 1][j][i]);
      }
      out[((size_t)g * C + row) * N + col] = __float2bfloat16_rn(v);
    }
}

template <int MT, bool GLU>
cudaError_t launch_gemm(const bf16* a, const int* map, const bf16* w, const int* counts,
                        bf16* out, int G_, int C, int K, int N, cudaStream_t stream) {
  using G = Gemm<MT, GLU>;
  auto kernel = moe_gemm_kernel<MT, GLU>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const dim3 grid((C + MT - 1) / MT, (N + kBN - 1) / kBN, G_);
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(a, map, w, counts, out, C, K, N);
  return cudaGetLastError();
}

// -------------------------------------------------------------- combine --
__global__ void __launch_bounds__(kCombineThreads)
    moe_combine_kernel(const bf16* __restrict__ y, const float* __restrict__ gates,
                       const int* __restrict__ experts, const int* __restrict__ slots,
                       const bf16* __restrict__ shared, bf16* __restrict__ out, int K, int C,
                       int D) {
  const int t = blockIdx.x;
  for (int c0 = threadIdx.x * 8; c0 < D; c0 += kCombineThreads * 8) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < K; ++k) {
      const int e = experts[t * K + k], s = slots[t * K + k];
      const float gk = gates[t * K + k];
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (s < C) {
        const uint4 raw = *reinterpret_cast<const uint4*>(y + ((size_t)e * C + s) * D + c0);
        const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float term = __fmul_rn(v[i], gk);
        acc[i] = k == 0 ? term : __fadd_rn(acc[i], term);
      }
    }
    uint4 res;
    bf16* o = reinterpret_cast<bf16*>(&res);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __float2bfloat16_rn(acc[i]);
    if (shared != nullptr) {
      const uint4 raw = *reinterpret_cast<const uint4*>(shared + (size_t)t * D + c0);
      const bf16* sh = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o[i] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(o[i]), __bfloat162float(sh[i])));
    }
    *reinterpret_cast<uint4*>(out + (size_t)t * D + c0) = res;
  }
}

}  // namespace

// Two launches: the router's logits, then the routing.
extern "C" int moe_route(const void* x, const void* w, void* logits, int T, int D, int E,
                         int K, int C, void* gates, void* experts, void* slots, void* counts,
                         void* src, void* reads, void* stream) {
  if (K < 1 || K > kMaxK || E < K || E > 32 * kMaxPerLane || E % kRouterExperts)
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  moe_router_kernel<<<T * (E / kRouterExperts), kRouterThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<float*>(logits), D,
      E);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  moe_route_kernel<<<1, kRouteThreads, E * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), T, E, K, C, static_cast<float*>(gates),
      static_cast<int*>(experts), static_cast<int*>(slots), static_cast<int*>(counts),
      static_cast<int*>(src), static_cast<unsigned long long*>(reads));
  return cudaGetLastError();
}

// glu: N = F (w (G, K, 2F)); else w (G, K, N). MT 8 where C <= 32 (decode:
// one or a few row tiles), else 128.
extern "C" int moe_gemm(int glu, const void* a, const void* map, const void* w,
                        const void* counts, void* out, int G, int C, int K, int N,
                        void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto a_ = static_cast<const bf16*>(a);
  const auto map_ = static_cast<const int*>(map);
  const auto w_ = static_cast<const bf16*>(w);
  const auto c_ = static_cast<const int*>(counts);
  const auto o_ = static_cast<bf16*>(out);
  if (C <= 32)
    return glu ? launch_gemm<8, true>(a_, map_, w_, c_, o_, G, C, K, N, s)
               : launch_gemm<8, false>(a_, map_, w_, c_, o_, G, C, K, N, s);
  return glu ? launch_gemm<128, true>(a_, map_, w_, c_, o_, G, C, K, N, s)
             : launch_gemm<128, false>(a_, map_, w_, c_, o_, G, C, K, N, s);
}

extern "C" int moe_combine(const void* y, const void* gates, const void* experts,
                           const void* slots, const void* shared, void* out, int T, int K,
                           int C, int D, void* stream) {
  if (T == 0) return cudaSuccess;
  moe_combine_kernel<<<T, kCombineThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const float*>(gates),
      static_cast<const int*>(experts), static_cast<const int*>(slots),
      static_cast<const bf16*>(shared), static_cast<bf16*>(out), K, C, D);
  return cudaGetLastError();
}
