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
// rows); rows past a count and groups of count 0 are never written. GLU:
// the gate-up product of the rows of a gathered through the map (or rows
// g*C + c without one) with w (G, K, 2F), h = bf16(silu(g) * u) of the f32
// sums; else y = bf16(rows @ w (G, K, N)). Bound: at decode (a few rows
// an expert) the bytes of the routed experts' weights; at prefill (a few
// hundred rows an expert, about 256 flops a weight byte against the
// card's 295) the bytes and the tensor cores nearly alike.
//
// Design (Hopper: TMA, mbarriers, wgmma). The product is taken transposed
// (swap AB): out^T = w^T rows^T, so a 64-column block of the weights is
// the A operand of wgmma.mma_async.m64nRk16 (bf16 in, f32 accumulate),
// read from shared memory MN-major (the descriptor's transpose bit), and
// the rows are the B operand, K-major, R of them (the row tile, the
// instruction's N). A work item is 128 weight columns (GLU: the gate and
// the up block of the same 64 output columns) of one row tile of one
// group over a range of K. A CTA is 384 threads: a producer warpgroup and
// two consumer warpgroups, consumer 0 on the first 64 columns and
// consumer 1 on the other 64, over all R rows.
// - The producer fills a ring of 64-k stages on full/empty mbarriers:
//   both weight boxes by TMA from one 3-D map over w (G, K, N'), 128-byte
//   swizzle, zero past K; rows without a map by TMA too (a 3-D map over
//   (G, C, K), zero past C and K). Rows gathered through the map: at the
//   16-row tile (decode) by TMA as well, one copy a row (a 64 k x 1 row
//   box of a 2-D map over the rows), issued by the producer threads side
//   by side: the 128-byte swizzle follows the shared-memory address, so
//   each row lands where a whole tile's box would put it. At the 128-row
//   tile, 128 copies a stage held the producer back (as did cp.async
//   with a fence.proxy.async before wgmma read the rows: the gate-up GEMM
//   ran several times slower than the down GEMM's TMA-fed rows at
//   phi3.5-moe's 4 x 512 bucket), so moe_gemm_gather_kernel first copies
//   the rows into (G, C, K), once a call, and the GEMM reads them as
//   boxes. Every byte of a stage arrives through the async proxy that
//   wgmma reads, so no proxy fence is needed.
// - The grid is persistent: CTAs take the work items round robin, and the
//   producer runs on into the next item while the consumers store the
//   last one. The items are those of the row tiles that hold rows: the
//   groups with rows and the prefix sums of their items are listed in
//   shared memory at start, so an empty expert or tile costs nothing and
//   the CTAs that share a weight block stay side by side.
// - Row tile: R = 16 where C <= 16 (decode; two CTAs an SM), else R =
//   128 (prefill; one CTA an SM); 5 stages each. At phi3.5-moe's 4 x 512
//   bucket C is 320: an expert's 256 rows or so take two or three tiles,
//   whose items are adjacent, so the CTAs that read one weight block run
//   together and the later reads come from the L2. A tile with at most
//   64 live rows (an expert's third) loads and runs wgmma on its first 64
//   rows only, at N 64 (the width does not enter a row's sums). A 128-row
//   tile keeps the walk route's running sums in registers (64 + 64
//   floats a thread); a 160-row tile, two at C 320, spilled at the 168
//   registers a thread of one 384-thread CTA an SM. Tried and not kept:
//   CTA pairs in a cluster on neighbouring column blocks, each loading
//   half the rows tile for both by TMA multicast (one ring for two CTAs
//   made each wait out the other's epilogue; no faster); the consumers
//   splitting the rows instead of the columns (no SwiGLU exchange, but
//   ptxas serialized their wgmma and spilled); the weight boxes asked of
//   the L2 eight or sixteen stages ahead of the ring (slower); the
//   epilogue run after the next item's first k steps were issued, to
//   overlap them (slower).
// - K is cut into chunks of k_per_chunk rows (a multiple of 64), planned
//   from (K, N', SM count) alone by kernels/moe.py::moe_gemm_plan, never
//   from the counts, C, the active experts or R. With one row tile a
//   group (C <= R) and more than one chunk, each chunk is a work item of
//   its own, so that a call with two active experts still streams enough
//   weight blocks at once: it writes its f32 sums to partial (chunks, G,
//   C, N'), and moe_gemm_sum_kernel adds them in chunk order. Otherwise
//   an item walks every chunk, each summed in its own accumulators
//   (wgmma's scale-d 0 at a chunk's first k16 step) and added in order to
//   a running sum. Both routes compute s = 0; s += chunk[c] for c in
//   order, as quant_matmul.cu does.
// - Epilogue: consumer 1 hands its up sums to consumer 0 for the even
//   rows and consumer 0 its gate sums to consumer 1 for the odd rows
//   (shared memory), and each computes h = silu(g) * u of the f32 sums,
//   rounded once; the output tile is staged in shared memory, transposed,
//   and stored 16 bytes a thread, whole rows.
// Invariant: each output element is summed by the same wgmma k16 steps
// in the same k order, at the same row of its m64 block, and added over
// the same chunks in the same order, whatever the count, C, R, the route
// or the other rows: a row's bits do not depend on them (wgmma's N, the
// row count, does not enter an element's sum).
//
// moe_combine_kernel (moe.py:119-125, 136-139): out[t] = bf16(sum over k
// in order of gate[t, k] * f32(y[e_tk, slot_tk])), a dropped pair adding
// 0, each product and sum rounded once (no fma contraction), then + the
// shared experts' output in bf16 (rounded once). Bound: bytes.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <cstring>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRouteThreads = 512;
constexpr int kMaxK = 8;            // experts a token (kimi-k2's top-8)
constexpr int kMaxPerLane = 32;     // E <= 1024: one bit a logit in a lane's mask
constexpr int kGemmThreads = 384;   // two consumer warpgroups and a producer warpgroup
constexpr int kMaxGroups = 1024;    // groups a GEMM call (E <= 1024)
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
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// a 3-D TMA tile copy global -> shared, completing on bar
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}
// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout (1: 128B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from touching wgmma operands across the async window
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// named barrier 1 over the 256 consumer threads, 2 over the producer's 128
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// d (m64 x N f32, registers) (+)= a (m64 x k16 bf16, shared memory,
// MN-major: the transpose bit) * b (k16 x N bf16, shared memory, K-major).
// Warp w of the warpgroup holds rows 16w..16w+15 (the weight columns);
// with gid = lane / 4, tig = lane % 4, d[4j + e] = (gid + 8 * (e >> 1),
// 8j + 2tig + (e & 1)).
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

// silu(g) * u in f32, rounded once to bf16 by the caller
__device__ __forceinline__ float silu_mul(float g, float u) {
  const float s = __fdiv_rn(g, __fadd_rn(1.f, expf(-g)));
  return __fmul_rn(s, u);
}

struct GemmMaps {
  CUtensorMap w;   // (G, K, N') bf16, boxes of 64 columns x 64 k
  CUtensorMap x;   // rows without a map, (G, C, K) bf16, boxes of 64 k x R rows
  CUtensorMap xs;  // the same, boxes of 64 k x 64 rows (R 128: a short tile's)
  CUtensorMap r;   // rows through the map, (rows, K) bf16, boxes of 64 k x 1 row
};

// Shared memory for row tile R: the ring (each stage two 8 KB weight
// boxes, then R rows of 128 bytes, all 1024-byte aligned for the 128-byte
// swizzle), the epilogue's exchange / staging tile, the groups' counts and
// the list of groups with rows, the producer's gathered row indices, the
// barriers.
template <int R>
struct GemmGeo {
  static constexpr int kStages = 5;
  static constexpr int kCtasPerSm = R <= 16 ? 2 : 1;
  static constexpr int kBox = 64 * 128;
  static constexpr int kW = 2 * kBox;
  static constexpr int kX = R * 128;
  static constexpr int kStage = kW + kX;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kPitchGlu = 64 * 2 + 16;    // a staged row of h (bytes)
  static constexpr int kPitch = 128 * 2 + 16;      // a staged row of y
  static constexpr int kOut = R * kPitch;          // >= the exchange's R * 256
  static constexpr int kList = (3 * kMaxGroups + 2) * 4;
  static constexpr int kSrc = R * 4;
  static constexpr int kBars = 2 * kStages * 8;
  static constexpr int kSmem = kRing + kOut + kList + kSrc + kBars + 1024;
  static_assert(kStage % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  static_assert((kOut + kList + kSrc) % 8 == 0, "the barriers are 8-byte aligned");
};

// One work item: 128 weight columns (boxes at c0 and c1; output columns
// n0..) of rows m0.. (live of them) of group g over k in [kb, ke).
struct GemmItem {
  int g, m0, live, n0, c0, c1, kb, ke, kc;
};

// Item i: group list[a] for the last a with start[a] <= i (start: the
// prefix sums of the listed groups' items, n + 1 of them); within it,
// the row tile fastest (the tiles of one weight block side by side),
// then the column block, then the chunk.
template <int R, bool GLU>
__device__ __forceinline__ GemmItem gemm_item(int i, const int* list, const int* cnts,
                                              const int* start, int n, int K, int N, int kper,
                                              int blocks, int ctas_k) {
  GemmItem it;
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= i) lo = mid;
    else hi = mid - 1;
  }
  it.g = list[lo];
  const int cnt = cnts[it.g], tiles = (cnt + R - 1) / R;
  int r = i - start[lo];
  const int tile = r % tiles;
  r /= tiles;
  const int nb = r % blocks;
  it.kc = r / blocks;
  it.m0 = tile * R;
  it.live = min(R, cnt - it.m0);
  it.n0 = nb * (GLU ? 64 : 128);
  it.c0 = it.n0;
  it.c1 = GLU ? N + it.n0 : it.n0 + 64;
  it.kb = ctas_k > 1 ? it.kc * kper : 0;
  it.ke = ctas_k > 1 ? min(K, it.kb + kper) : K;
  return it;
}

// out (G, C, N) bf16 over the rows c < counts[g] (all C without counts);
// GLU: w (G, K, 2N), out = silu(gate) * up; else w (G, K, N). With
// partial (split route) the item's f32 sums go to partial (chunks, G, C,
// N') instead, and moe_gemm_sum_kernel writes out.
template <int R, bool GLU>
__global__ void __launch_bounds__(kGemmThreads, GemmGeo<R>::kCtasPerSm)
    moe_gemm_kernel(const __grid_constant__ GemmMaps p, const bf16* __restrict__ a,
                    const int* __restrict__ map, const int* __restrict__ counts,
                    bf16* __restrict__ out, float* __restrict__ partial, int G, int C, int K,
                    int N, int kper, int chunks) {
  using T = GemmGeo<R>;
  constexpr int S = T::kStages;
  constexpr int NA = R / 2;                       // accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* osm = ring + T::kRing;                 // exchange, then the staged tile
  int* cnts = reinterpret_cast<int*>(osm + T::kOut);
  int* list = cnts + kMaxGroups;
  int* start = list + kMaxGroups;                 // kMaxGroups + 1 (+ 1 for the barriers' alignment)
  int* srcs = start + kMaxGroups + 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(srcs + R);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  const bool gather = map != nullptr;
  const int Nw = GLU ? 2 * N : N;
  const int blocks = (Nw + 127) / 128;
  const int ctas_k = partial != nullptr ? chunks : 1;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);                     // the producer's expect_tx
      mbar_init(&empty[s], 2);                    // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < G; e += kGemmThreads) cnts[e] = counts != nullptr ? counts[e] : C;
  __syncthreads();
  if (tid < 32) {                                 // the groups with rows, in order,
    int n = 0, total = 0;                         // and the prefix sums of their items
    for (int base = 0; base < G; base += 32) {
      const int e = base + tid;
      const bool v = e < G && cnts[e] > 0;
      const unsigned m = __ballot_sync(0xffffffffu, v);
      const int pos = n + __popc(m & ((1u << tid) - 1u));
      int own = v ? (cnts[e] + R - 1) / R * blocks * ctas_k : 0, inc = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, inc, o);
        if (tid >= o) inc += up;
      }
      if (v) {
        list[pos] = e;
        start[pos] = total + inc - own;
      }
      n += __popc(m);
      total += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (tid == 0) {
      start[n] = total;
      srcs[0] = n;                                // handed over through srcs[0]
    }
  }
  __syncthreads();
  const int groups = srcs[0], items = start[groups];
  __syncthreads();                                // srcs is the producer's from here on

  if (tid >= 2 * 128) {                           // producer warpgroup
    if (R > 16) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - 256;
    if (!gather && pt != 0) return;
    int it = 0;                                   // ring slot, counted over all items
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const GemmItem I =
          gemm_item<R, GLU>(i, list, cnts, start, groups, K, N, kper, blocks, ctas_k);
      if (gather) {
        producer_sync();                          // the last item's copies are all issued
        for (int r = pt; r < I.live; r += 128) srcs[r] = map[I.g * C + I.m0 + r];
        producer_sync();
      }
      for (int k0 = I.kb; k0 < I.ke; k0 += 64, ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(&empty[s], (it / S - 1) & 1);
        uint8_t* st = ring + s * T::kStage;
        if (pt == 0) {
          // a short tile (at most 64 live rows, run at N 64) loads 64 rows
          const bool short_tile = R > 64 && I.live <= 64;
          mbar_expect_tx(&full[s], T::kW + (gather      ? I.live * 128
                                            : short_tile ? 64 * 128
                                                         : T::kX));
          tma_3d(st, &p.w, I.c0, k0, I.g, &full[s]);
          tma_3d(st + T::kBox, &p.w, I.c1, k0, I.g, &full[s]);
          if (!gather)
            tma_3d(st + T::kW, short_tile ? &p.xs : &p.x, k0, I.m0, I.g, &full[s]);
        }
        // a gathered row a copy, at its place in the tile: the 128-byte
        // swizzle follows the shared-memory address, so each row lands
        // where the tile's box would put it
        if (gather)
          for (int r = pt; r < I.live; r += 128)
            tma_3d(st + T::kW + r * 128, &p.r, k0, srcs[r], 0, &full[s]);
      }
    }
    return;
  }

  if (R > 16) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // consumers: warpgroup wg runs the weight box wg (gate / up, or columns
  // 0-63 / 64-127) over all R rows
  const int wg = tid >> 7, wt = tid & 127;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int mrow = (wt >> 5) * 16 + gid;          // this thread's first weight column (+ 8)
  float acc[NA], run[NA];
#pragma unroll
  for (int v = 0; v < NA; ++v) acc[v] = 0.f;
  int it = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const GemmItem I =
        gemm_item<R, GLU>(i, list, cnts, start, groups, K, N, kper, blocks, ctas_k);
#pragma unroll
    for (int v = 0; v < NA; ++v) run[v] = 0.f;
    int pend = -1;                                // the slot whose group may still run
    for (int k0 = I.kb; k0 < I.ke; k0 += 64, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const uint32_t wbase = smem_addr(ring + s * T::kStage + wg * T::kBox);
      const uint32_t xbase = smem_addr(ring + s * T::kStage + T::kW);
      const int fresh = k0 % kper == 0 ? 0 : 1;   // a chunk's first step starts from 0
      wgmma_fence();
      if constexpr (R > 64) {
        if (I.live <= 64) {                       // a short tile: its first 64 rows
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            WgmmaSS<64>::mma(acc, make_desc(wbase + kk * 16 * 128, T::kBox, 8 * 128, 1),
                             make_desc(xbase + kk * 32, 16, 8 * 128, 1), kk > 0 ? 1 : fresh);
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            WgmmaSS<R>::mma(acc, make_desc(wbase + kk * 16 * 128, T::kBox, 8 * 128, 1),
                            make_desc(xbase + kk * 32, 16, 8 * 128, 1), kk > 0 ? 1 : fresh);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaSS<R>::mma(acc, make_desc(wbase + kk * 16 * 128, T::kBox, 8 * 128, 1),
                          make_desc(xbase + kk * 32, 16, 8 * 128, 1), kk > 0 ? 1 : fresh);
      }
      wgmma_commit();
      const bool end = (k0 + 64) % kper == 0 || k0 + 64 >= I.ke;
      if (end) {
        wgmma_wait<0>();
        fence_regs<NA>(acc);
        if (wt == 0) {
          if (pend >= 0) mbar_arrive(&empty[pend]);
          mbar_arrive(&empty[s]);
        }
        pend = -1;
#pragma unroll
        for (int v = 0; v < NA; ++v) run[v] = __fadd_rn(run[v], acc[v]);
      } else {
        wgmma_wait<1>();
        if (wt == 0 && pend >= 0) mbar_arrive(&empty[pend]);
        pend = s;
      }
    }

    const int cw = wg ? I.c1 : I.c0;              // this warpgroup's first weight column
    if (ctas_k > 1) {
      // split route: the chunk's sums, f32, straight from the fragments
      // (8 consecutive columns of a row a quad: whole 32-byte sectors)
      float* P = partial + ((size_t)(I.kc * G + I.g) * C + I.m0) * Nw;
#pragma unroll
      for (int v = 0; v < NA; ++v) {
        const int n = (v >> 2) * 8 + 2 * tig + (v & 1), m = mrow + 8 * ((v >> 1) & 1);
        const bool col_ok = GLU ? I.n0 + m < N : cw + m < N;
        if (n < I.live && col_ok) P[(size_t)n * Nw + cw + m] = run[v];
      }
      continue;
    }

    consumer_sync();                              // the last item's stores have read osm
    if (GLU) {
      // even rows (v & 1 == 0) are consumer 0's, odd rows consumer 1's;
      // each hands the other its sums for the other's rows
      float* xg = reinterpret_cast<float*>(osm);  // gate sums of the odd rows
      float* xu = xg + (R / 4) * 128;             // up sums of the even rows
      // the rows of parity P are consumer P's (the branch on wg stays
      // outside the unrolled loops, so no warp issues the other's work)
      auto swiglu = [&](auto parity) {
        constexpr int P = decltype(parity)::value;
#pragma unroll
        for (int v = 1 - P; v < NA; v += 2) (P ? xu : xg)[(v >> 1) * 128 + wt] = run[v];
        consumer_sync();
#pragma unroll
        for (int v = P; v < NA; v += 2) {
          const float other = (P ? xg : xu)[(v >> 1) * 128 + wt];
          run[v] = P ? silu_mul(other, run[v]) : silu_mul(run[v], other);
        }
        consumer_sync();                          // the exchange is read; stage over it
#pragma unroll
        for (int v = P; v < NA; v += 2) {
          const int n = (v >> 2) * 8 + 2 * tig + P, m = mrow + 8 * ((v >> 1) & 1);
          reinterpret_cast<bf16*>(osm + n * T::kPitchGlu)[m] = __float2bfloat16_rn(run[v]);
        }
      };
      if (wg == 0)
        swiglu(std::integral_constant<int, 0>{});
      else
        swiglu(std::integral_constant<int, 1>{});
    } else {
#pragma unroll
      for (int v = 0; v < NA; ++v) {
        const int n = (v >> 2) * 8 + 2 * tig + (v & 1), m = mrow + 8 * ((v >> 1) & 1);
        reinterpret_cast<bf16*>(osm + n * T::kPitch)[wg * 64 + m] = __float2bfloat16_rn(run[v]);
      }
    }
    consumer_sync();
    // whole rows, 16 bytes a thread; columns past N and rows past the
    // count are not written
    constexpr int CH = GLU ? 8 : 16;              // 16-byte chunks a staged row
    constexpr int pitch = GLU ? T::kPitchGlu : T::kPitch;
    bf16* obase = out + ((size_t)I.g * C + I.m0) * N + I.n0;
    for (int idx = tid; idx < I.live * CH; idx += 256) {
      const int r = idx / CH, ch = idx % CH;
      if (I.n0 + ch * 8 < N)
        *reinterpret_cast<uint4*>(obase + (size_t)r * N + ch * 8) =
            *reinterpret_cast<const uint4*>(osm + r * pitch + ch * 16);
    }
  }
}

// rows (G, C, K) <- a[map[g * C + c]] for c < counts[g]: the rows a
// 128-row tile reads, gathered once a call so that the GEMM loads them as
// TMA boxes (one copy a row a stage held its producer back at prefill).
// grid (C, G); a thread 16 bytes at a time.
__global__ void __launch_bounds__(128)
    moe_gemm_gather_kernel(const bf16* __restrict__ a, const int* __restrict__ map,
                           const int* __restrict__ counts, bf16* __restrict__ rows, int C,
                           int K) {
  const int c = blockIdx.x, g = blockIdx.y;
  if (c >= counts[g]) return;
  const uint4* src = reinterpret_cast<const uint4*>(a + (size_t)map[g * C + c] * K);
  uint4* dst = reinterpret_cast<uint4*>(rows + ((size_t)g * C + c) * K);
  for (int j = threadIdx.x; j < K / 8; j += 128) dst[j] = src[j];
}

// out[g, c] from the split route's partials, rows c < counts[g]: each sum
// s = 0; s += partial[chunk] in chunk order, then (GLU) silu(g) * u, one
// rounding. grid (C, G); a thread 8 output columns at a time.
template <bool GLU>
__global__ void __launch_bounds__(128)
    moe_gemm_sum_kernel(const float* __restrict__ partial, const int* __restrict__ counts,
                        bf16* __restrict__ out, int G, int C, int N, int chunks) {
  const int c = blockIdx.x, g = blockIdx.y;
  if (c >= (counts != nullptr ? counts[g] : C)) return;
  const int Nw = GLU ? 2 * N : N;
  const size_t plane = (size_t)G * C * Nw;
  const float* p0 = partial + ((size_t)g * C + c) * Nw;
  for (int j = threadIdx.x * 8; j < N; j += 128 * 8) {
    float s[8], u[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = u[e] = 0.f;
    for (int ch = 0; ch < chunks; ++ch) {
      const float* pc = p0 + ch * plane + j;
      const float4 a0 = *reinterpret_cast<const float4*>(pc);
      const float4 a1 = *reinterpret_cast<const float4*>(pc + 4);
      const float va[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = __fadd_rn(s[e], va[e]);
      if (GLU) {
        const float4 b0 = *reinterpret_cast<const float4*>(pc + N);
        const float4 b1 = *reinterpret_cast<const float4*>(pc + N + 4);
        const float vb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) u[e] = __fadd_rn(u[e], vb[e]);
      }
    }
    uint4 res;
    bf16* o = reinterpret_cast<bf16*>(&res);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16_rn(GLU ? silu_mul(s[e], u[e]) : s[e]);
    *reinterpret_cast<uint4*>(out + ((size_t)g * C + c) * N + j) = res;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* q = nullptr;
    cudaDriverEntryPointQueryResult r;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &q, cudaEnableDefault, &r) ==
            cudaSuccess &&
        r == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(q);
  }
  return fn;
}

// a bf16 (d2, d1, d0) tensor, d0 contiguous, as a 3-D map with boxes of
// b0 x b1 x 1 and the 128-byte swizzle; elements past the edges read as 0
bool make_map(CUtensorMap* map, const void* base, int d0, int d1, int d2, int b0, int b1) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2, (cuuint64_t)d1 * d0 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int R, bool GLU>
cudaError_t launch_gemm(const bf16* a, const int* map, const bf16* w, const int* counts,
                        bf16* out, float* partial, bf16* gathered, int G, int C, int K, int N,
                        int rows, int kper, int ctas, cudaStream_t stream) {
  using T = GemmGeo<R>;
  auto kernel = moe_gemm_kernel<R, GLU>;
  const int Nw = GLU ? 2 * N : N;
  if (gathered != nullptr) {                      // the map's rows, gathered first
    if (map == nullptr || counts == nullptr) return cudaErrorInvalidValue;
    moe_gemm_gather_kernel<<<dim3(C, G), 128, 0, stream>>>(a, map, counts, gathered, C, K);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    a = gathered;
    map = nullptr;
  }
  GemmMaps p;                                     // copied into the launch
  memset(&p, 0, sizeof(p));
  if (!make_map(&p.w, w, Nw, K, G, 64, 64) ||
      (map == nullptr && !make_map(&p.x, a, K, C, G, 64, R)) ||
      (map == nullptr && R > 64 && !make_map(&p.xs, a, K, C, G, 64, 64)) ||
      (map != nullptr && !make_map(&p.r, a, K, rows, 1, 64, 1)))
    return cudaErrorInvalidValue;
  static bool sized = false;                      // once per instantiation (one device)
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const int chunks = (K + kper - 1) / kper;
  kernel<<<ctas, kGemmThreads, T::kSmem, stream>>>(p, a, map, counts, out, partial, G, C, K, N,
                                                   kper, chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || partial == nullptr) return e;
  moe_gemm_sum_kernel<GLU><<<dim3(C, G), 128, 0, stream>>>(partial, counts, out, G, C, N, chunks);
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

// glu: N = F (w (G, K, 2F)); else w (G, K, N); rows: a's rows (rows x
// K). row_tile (16 or 128), k_per_chunk (a multiple of 64) and ctas (the
// persistent grid) come from kernels/moe.py, the one place they are set;
// partial (chunks, G, C, N') f32 selects the split route, null the walk
// route; gathered (G, C, K) bf16, with a map, gathers the rows first.
// Returns the launch's cudaError_t (0 on success), or -1 for a row tile
// with no instance.
extern "C" int moe_gemm(int glu, const void* a, const void* map, const void* w,
                        const void* counts, void* out, void* partial, void* gathered, int G,
                        int C, int K, int N, int rows, int row_tile, int k_per_chunk,
                        int ctas, void* stream) {
  if (G < 1 || G > kMaxGroups || C < 1 || K < 8 || K % 8 || N % 8 || rows < 1 ||
      k_per_chunk < 64 || k_per_chunk % 64 || ctas < 1)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto a_ = static_cast<const bf16*>(a);
  const auto map_ = static_cast<const int*>(map);
  const auto w_ = static_cast<const bf16*>(w);
  const auto c_ = static_cast<const int*>(counts);
  const auto o_ = static_cast<bf16*>(out);
  const auto p_ = static_cast<float*>(partial);
  const auto g_ = static_cast<bf16*>(gathered);
#define GEMM_CASE(R_)                                                                      \
  if (row_tile == R_)                                                                      \
    return glu ? launch_gemm<R_, true>(a_, map_, w_, c_, o_, p_, g_, G, C, K, N, rows,    \
                                       k_per_chunk, ctas, s)                               \
               : launch_gemm<R_, false>(a_, map_, w_, c_, o_, p_, g_, G, C, K, N, rows,   \
                                        k_per_chunk, ctas, s);
  GEMM_CASE(16)
  GEMM_CASE(128)
#undef GEMM_CASE
  return -1;
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
