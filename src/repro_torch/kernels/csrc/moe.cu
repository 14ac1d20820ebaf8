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
// moe_route (moe.py:73-97): the router's f32 logits (T, E) of x (T, D)
// bf16 and w (D, E) bf16, then softmax, top-k, the gates and each pair's
// slot. The logits are summed in one order planned from (D, E) alone, so a
// token's logits, and so its routing, do not depend on T or on its
// batch-mates, bit for bit (the library's f32 product sums a row
// differently at M 1 and M 4 on the H100, which would make a request's
// stream depend on them): 128 lanes, lane i summing by fma the 16-byte
// runs r = i + 128 j of d (d = 8r .. 8r + 7) in order of j and then d;
// the lanes added pairwise by lane bits 4, 3, 2, 1, 0 within each 32
// (a warp's xor tree), then the four warp sums in order. Each product is
// exact in f32; the sums run on the CUDA cores (the tensor cores do not
// sum in this order). The top K are chosen on the logits
// (softmax is monotone; equal values go to the lower expert id, as
// jax.lax.top_k orders them), a warp a token, and a gate is exp(l_k -
// l_max) over the chosen ones' sum (route_token). A pair's slot is its
// rank among the pairs of its expert in flat (t, k) order, the slot that
// the stable argsort and searchsorted of moe.py:88-97 give; a kept pair
// (slot < C) writes its token into the (E, C) gather map; counts[e] =
// min(pairs of e, C).
// - Decode (T <= kClusterT at E <= 32, the megastep's T; T <=
//   kClusterTWide above): one launch where there were two,
//   moe_route_cluster_kernel: clusters of kClusterCtas CTAs, a cluster two
//   blocks of experts (one cluster at phi3.5-moe's E 16, 3 at kimi-k2's E
//   384). A CTA keeps one lane-warp of a block; a producer
//   warp streams its x and w (w viewed (E, runs, 8), so a stage holds
//   [k][lane][experts]) through a ring of TMA stages, all in flight at
//   once; its partial sums go into the cluster leader's shared memory
//   (distributed shared memory), which adds the four in order. One
//   cluster routes from there (no logit round trip through device
//   memory); more write their logits and the last, by a ticket (a
//   stream's own), routes. Bound: launch latency, two cluster barriers
//   and one pass over w (phi3.5-moe: 131 KB on 8 SMs; kimi-k2: 5.5 MB on
//   24). At kimi-k2's T 16 the clusters' fmas (44 M on 24 SMs) outweigh
//   the two extra launches, so it takes the prefill's three.
// - Prefill: three launches. moe_router_tile_kernel, a CTA a tile of 16
//   tokens x 16 experts, stages the tile's x rows and w's (1024 d x 16
//   experts) slice in shared memory by cp.async through a ring of
//   kTileStages; each thread keeps 8 tokens x 16 experts of running sums,
//   so w is read once a tile of tokens, not once a token (the former
//   per-token router read kimi-k2's 5.5 MB of w once a token, 2.8 GB
//   through the L2 at T 512). moe_route_topk_kernel: a warp a token.
//   moe_route_slots_kernel: one CTA of kSlotWarps warps; the pairs in
//   flat order are cut into a segment of 32 x n pairs a warp (n from T K
//   alone), each warp counts its segment's pairs per expert in shared
//   memory, an exclusive scan over the segments gives each (segment,
//   expert) its first slot, and each warp then ranks its pairs as the
//   serial walk did (__match_any_sync, a running count an expert): T K /
//   1024 steps a warp in place of T K / 32 steps of one warp (0.25 ms at
//   phi3.5-moe's T 2048). Bound: the bytes of x and w; at kimi-k2's T 512
//   the 1.4 G f32 fmas on the CUDA cores.
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
// shared experts' output in bf16 (rounded once). Bound: bytes. At decode
// (C <= 16) moe_down's split sums and this combine are one kernel,
// moe_down_combine_kernel (a launch and y's round trip fewer); the
// prefill keeps the two.
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

constexpr int kMaxK = 8;            // experts a token (kimi-k2's top-8)
constexpr int kMaxPerLane = 32;     // E <= 1024: one bit a logit in a lane's mask
constexpr int kGemmThreads = 384;   // two consumer warpgroups and a producer warpgroup
constexpr int kMaxGroups = 1024;    // groups a GEMM call (E <= 1024)
constexpr int kCombineThreads = 128;
constexpr int kLanes = 128;         // the router's lanes: partial sums a logit
constexpr int kStepD = kLanes * 8;  // d a step of all lanes (a run of 8 each)
constexpr int kClusterT = 16;       // the decode route's largest T at E <= 32 (kernels/moe.py::
constexpr int kClusterTWide = 4;    // ROUTE_CLUSTER_T) and at E > 32 (ROUTE_CLUSTER_T_WIDE)
constexpr int kClusterBlocks = 2;   // expert blocks a cluster (of its 4 lane-warps: 8 units)
constexpr int kClusterCtas = 8;     // its cluster (the portable size)
constexpr int kSmemMax = 232448;    // shared memory a CTA may have
constexpr int kMaxStages = 8;       // the decode route's deepest ring
constexpr int kTileT = 16;          // tokens a router tile (two groups of 8)
constexpr int kTileE = 16;          // experts a router tile
constexpr int kTileStages = 3;
constexpr int kTileStage = kTileT * kStepD * 2 + kStepD * kTileE * 2;  // 64 KB
constexpr int kTopkWarps = 8;
constexpr int kSlotWarps = 32;      // the slot kernel's warps
constexpr int kSlotThreads = 32 * kSlotWarps;
constexpr int kWalkBatch = 8;       // pairs a lane loads at once in a walk

// ------------------------------------------------- TMA and mbarriers --
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
// ---------------------------------------------------------------- route --
__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// bf16 element k (0-7) of a 16-byte run, as f32 (k known at compile time)
__device__ __forceinline__ float run_at(const uint4& r, int k) {
  const uint32_t v = k < 2 ? r.x : k < 4 ? r.y : k < 6 ? r.z : r.w;
  return __uint_as_float(k & 1 ? v & 0xffff0000u : v << 16);
}

// acc[t NE + e] = fma(x[t][d], w[d][e], acc[t NE + e]) for the run's
// element k
template <int TT, int NE>
__device__ __forceinline__ void run_fma(float (&acc)[TT * NE], const uint4 (&xr)[TT], int k,
                                        const float (&wv)[NE]) {
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    const float xv = run_at(xr[t], k);
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[t * NE + e] = __fmaf_rn(xv, wv[e], acc[t * NE + e]);
  }
}

// A warp's xor tree over N values a lane, pairing lanes by bit O, O / 2,
// ..., 1: at each level with N > 1 a lane keeps half the values (the
// upper half where its bit O is set) and adds its partner's copy of them,
// so each level sums the same pairs as v += shfl_xor(v, O) would; at
// N == 1 it is that. A lane ends with max(N / 32, 1) sums, of the values
// tree_base<N, O>(lane) + k.
template <int N, int O>
__device__ __forceinline__ void warp_tree(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool up = lane & O;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const float send = up ? v[k] : v[k + N / 2];
        const float keep = up ? v[k + N / 2] : v[k];
        v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
      }
      warp_tree<N / 2, O / 2>(v, lane);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], O));
      warp_tree<1, O / 2>(v, lane);
    }
  }
}
template <int N, int O>
__device__ __forceinline__ int tree_base(int lane) {
  if constexpr (O > 0 && N > 1)
    return (lane & O ? N / 2 : 0) + tree_base<N / 2, O / 2>(lane);
  else
    return 0;
}

// The four warp sums of a 128-lane group, in order: part[w][i] for i < n
// (each group's part holds 4 x n floats); the caller synchronizes.
__device__ __forceinline__ float group_sum(const float* part, int n, int i) {
  return __fadd_rn(__fadd_rn(__fadd_rn(part[i], part[n + i]), part[2 * n + i]), part[3 * n + i]);
}

// One token's routing by one warp from its logits in registers (logit
// lane + 32 j in v[j], j < NJ, NJ 32 >= E; -inf past E): the top K by
// value (ties to the lower id), then gate k = exp(l_k - l_0) / sum_k' of
// them, l_0 the largest logit. That is softmax, the chosen probabilities
// and their division by their sum (JAX's max(sum, 1e-9) never binds: the
// top probability is at least 1 / E) with the softmax's denominator
// cancelled, which moves a gate by a rounding or two. Lane k < K writes
// pair k.
template <int NJ>
__device__ __forceinline__ void route_token(float (&v)[NJ], int E, int K, int lane,
                                            float* gates, int* experts, int* experts_s) {
  float m = 0.f, gsum = 0.f, mine_g = 0.f;
  int mine_e = 0;
  for (int k = 0; k < K; ++k) {
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < NJ; ++j)  // a chosen logit is -inf (or NaN) and never wins
      if (v[j] > bv) {
        bv = v[j];
        bi = lane + 32 * j;
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
    if (bi >= E) bi = 0;  // only -inf or NaN logits left: keep the index in range
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (lane + 32 * j == bi) v[j] = -INFINITY;
    if (k == 0) m = bv;
    const float g = expf(bv - m);
    gsum = __fadd_rn(gsum, g);
    if (lane == k) {
      mine_g = g;
      mine_e = bi;
    }
  }
  if (lane < K) {
    experts[lane] = mine_e;
    gates[lane] = __fdiv_rn(mine_g, gsum);
    if (experts_s != nullptr) experts_s[lane] = mine_e;
  }
}

// counts[e] = min(n[e], C) for every e, and (reads) the experts with a
// pair and one pass added to the read counters: one warp.
__device__ __forceinline__ void warp_counts(const int* n, int E, int C, int* counts,
                                            unsigned long long* reads, int lane) {
  int used = 0;
  for (int e = lane; e < E; e += 32) {
    counts[e] = min(n[e], C);
    used += n[e] > 0;
  }
  used = warp_sum_int(used);
  if (reads != nullptr && lane == 0) {
    atomicAdd(reads, (unsigned long long)used);          // experts whose weights a GEMM streams
    atomicAdd(reads + 1, 1ull);                          // MoE layer passes
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// a pointer to the same shared-memory variable in the cluster's CTA `rank`
template <typename T>
__device__ __forceinline__ T* cluster_peer(T* p, int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// 16 bytes global -> shared by cp.async; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The decode route's tensor maps: x (T, D), boxes of 256 d x T tokens; w
// (D, E) viewed as (E, runs, 8) (element (e, r, k) = w[8r + k][e]: the
// run's stride before the row's, which the encoder takes), boxes of EB
// experts x 32 runs x 8 k, so that a stage holds [k][lane][EB] (the
// 128-byte swizzle at EB 64). Elements past T, D or E read as 0.
// A stage's row (k, lane) of EB experts holds octet o at 16-byte chunk
// swizzled(o, lane), so that lanes l .. l + 7 reading one octet fall in 8
// bank groups.
template <int EB>
__device__ __forceinline__ int swizzled(int o, int lane) {
  return EB == 64 ? o ^ (lane & 7) : o;
}
struct RouteMaps {
  CUtensorMap x, w;
};

// Decode: one launch, T <= kClusterT: clusters of kClusterCtas CTAs,
// cluster c taking the kClusterBlocks blocks of EB experts from c
// kClusterBlocks. A unit is one lane-warp lw (the lanes 32 lw .. 32 lw +
// 31 of the order above) of one block, for all T tokens; unit u = (u % 4,
// u / 4) of a cluster goes to its CTA u % 8, so a CTA keeps one lane-warp.
// Item (unit, j) is the 256 rows of d that the lane-warp's runs of step j
// cover: the tokens' x over them and w's (256 rows x EB experts) block,
// two TMA boxes through a ring of S stages on mbarriers (every item in
// flight where they fit), issued by a producer warp; the consumer warps
// free a stage on its empty barrier. Consumer warp (octet o, token group
// g) sums TT tokens x 8 experts a lane; at a unit's end its xor tree
// gives the lane-warp's partial sums, which go into its cluster leader's
// (rank 0) shared memory (distributed shared memory). The blocks: EB 8 at
// E <= 32 (phi3.5-moe: one cluster), a warp a token; else EB 64 with TT 4
// at T <= kClusterTWide (kimi-k2's E 384: three clusters; at its T 16 a
// variant of EB 32 with TT 16 was slower than the three launches of the
// prefill route, PERF.md). After a cluster barrier
// each leader adds its experts' four partials in order. With one cluster
// a warp of the leader takes a token's logits from there, writes them and
// routes it; with more, each leader writes its experts' logits out, and
// the last to take the ticket (after a fence) reads them all back and
// routes (the ticket counts the leaders modulo their number, so it is 0
// again after every launch). Then its warp 0 gives the pairs their slots
// and writes the
// counts. Shared memory: the ring ([S] stages of x (T x 256 bf16), then w
// at the next 1024 bytes ([8][32][EB] bf16)), the partials (4, T, the
// cluster's experts), the counts (E), the chosen experts (T K), the full
// and empty barriers, a flag.
template <int EB, int TT>
__global__ void __launch_bounds__(EB == 8 ? 512 + 32 : 32 * EB / 8 + 32)
    moe_route_cluster_kernel(const __grid_constant__ RouteMaps maps, int T, int D, int E, int K,
                             int C, int S, float* __restrict__ logits, float* __restrict__ gates,
                             int* __restrict__ experts, int* __restrict__ slots,
                             int* __restrict__ counts, int* __restrict__ src,
                             unsigned long long* __restrict__ reads, int* __restrict__ ticket) {
  constexpr int NO = EB / 8;                             // octets of experts a unit
  extern __shared__ uint8_t route_raw[];
  uint8_t* ring = route_raw + ((1024 - (smem_addr(route_raw) & 1023)) & 1023);
  const int cl = blockIdx.x / kClusterCtas, rank = blockIdx.x % kClusterCtas;
  const int ncl = gridDim.x / kClusterCtas, tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, o = warp % NO, tg = warp / NO;
  const int consumers = nthr / 32 - 1;                   // the last warp is the producer
  const int runs = D / 8, lw = rank % 4, eb0 = cl * kClusterBlocks;
  const int nb = min(kClusterBlocks, (E + EB - 1) / EB - eb0);  // this cluster's blocks
  const int Ec = min(E - eb0 * EB, nb * EB);             // and experts
  const int units = 4 * nb;
  const int mine = rank < units ? (units - rank + kClusterCtas - 1) / kClusterCtas : 0;
  // steps a unit (one, of zeros, where the lane-warp has no run)
  const int J = runs > 32 * lw ? (runs - 32 * lw + kLanes - 1) / kLanes : 1;
  const int items = mine * J, wofs = (T * 512 + 1023) & ~1023, stage = wofs + 512 * EB;
  float* part = reinterpret_cast<float*>(ring + S * stage);  // (4, T, Ec)
  int* cnt = reinterpret_cast<int*>(part + 4 * T * Ec);  // (E)
  int* ex = cnt + E;                                     // (T K)
  uint64_t* full = reinterpret_cast<uint64_t*>(ex + ((T * K + 1) & ~1));
  uint64_t* empty = full + S;
  int* last = reinterpret_cast<int*>(empty + S);         // this CTA routes (the last leader)
  float* lead = cluster_peer(part, 0);
  auto issue = [&](int n) {                              // item n: step n % J of unit n / J
    const int s = n % S, eb = eb0 + (rank + kClusterCtas * (n / J)) / 4;
    const int r0 = 32 * lw + kLanes * (n % J);
    uint8_t* st = ring + s * stage;
    mbar_expect_tx(&full[s], T * 512 + 512 * EB);
    tma_3d(st, &maps.x, 8 * r0, 0, 0, &full[s]);
    tma_3d(st + wofs, &maps.w, eb * EB, r0, 0, &full[s]);
  };
  if (tid == 32 * consumers) {                           // the producer: the barriers, the first
    for (int s = 0; s < S; ++s) {                        // stages' copies at once
      mbar_init(&full[s], 1);                            // the producer's expect_tx
      mbar_init(&empty[s], consumers);                   // a consumer warp's read
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int n = 0; n < S && n < items; ++n) issue(n);
  }
  cluster_arrive_relaxed();                              // this CTA has started
  for (int e = tid; e < E; e += nthr) cnt[e] = 0;        // (the leader's)
  __syncthreads();                                       // the barriers are initialized

  if (warp == consumers) {                               // producer: the rest of the ring
    if (lane == 0)
      for (int n = S; n < items; ++n) {
        mbar_wait(&empty[n % S], (n / S - 1) & 1);
        issue(n);
      }
    __syncwarp();
    cluster_wait();
  } else {
    float acc[TT * 8];
    for (int n = 0; n < items; ++n) {
      const int j = n % J;
      if (j == 0) {
#pragma unroll
        for (int v = 0; v < TT * 8; ++v) acc[v] = 0.f;
      }
      mbar_wait(&full[n % S], (n / S) & 1);
      const uint8_t* st = ring + (n % S) * stage;
      if (32 * lw + kLanes * j + lane < runs) {
        uint4 xr[TT];
#pragma unroll
        for (int tt = 0; tt < TT; ++tt) {
          const int t = tg * TT + tt;
          xr[tt] = t < T ? *reinterpret_cast<const uint4*>(st + t * 512 + lane * 16)
                         : make_uint4(0, 0, 0, 0);
        }
        uint4 wr[8];                                     // the run's 8 rows, loads side by side
#pragma unroll
        for (int k = 0; k < 8; ++k)
          wr[k] = *reinterpret_cast<const uint4*>(st + wofs + (k * 32 + lane) * EB * 2 +
                                                  swizzled<EB>(o, lane) * 16);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float wv[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) wv[e] = run_at(wr[k], e);
          run_fma<TT, 8>(acc, xr, k, wv);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[n % S]);        // this warp has read the stage
      if (j == J - 1) {                                  // the unit's lane-warp partials
        warp_tree<TT * 8, 16>(acc, lane);
        const int base = tree_base<TT * 8, 16>(lane);
        const int ec0 = (rank + kClusterCtas * (n / J)) / 4 * EB;  // the unit's first expert in Ec
        if (n / J == 0) cluster_wait();                  // every CTA has started
#pragma unroll
        for (int v = 0; v < (TT * 8 >= 32 ? TT * 8 / 32 : 1); ++v) {
          const int t = tg * TT + (base + v) / 8, ec = ec0 + 8 * o + (base + v) % 8;
          if (t < T && ec < Ec) lead[(lw * T + t) * Ec + ec] = acc[v];
        }
      }
    }
    if (items == 0) cluster_wait();
  }
  cluster_sync();                                        // the partials are in the leader
  if (rank != 0) return;

  // the leader: its experts' logits, the four partials in order
  const int TE = T * Ec;
  auto logit = [&](int t, int ec) {
    const float* p = part + t * Ec + ec;
    return __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[TE]), p[2 * TE]), p[3 * TE]);
  };
  if (ncl > 1) {                                         // out; the last cluster's leader routes
    for (int i = tid; i < TE; i += nthr)
      logits[(size_t)(i / Ec) * E + eb0 * EB + i % Ec] = logit(i / Ec, i % Ec);
    __syncthreads();
    if (tid == 0) {                                      // the ticket wraps to 0 for the next
      __threadfence();                                   // launch on the stream
      *last = atomicInc(reinterpret_cast<unsigned*>(ticket), ncl - 1) == (unsigned)(ncl - 1);
    }
    __syncthreads();
    if (!*last) return;
    __threadfence();
  }
  // a warp a token: its logits into registers (one cluster: out too),
  // then its routing
  for (int t = warp; t < T; t += nthr / 32) {
    float v[EB == 8 ? 1 : kMaxPerLane];
#pragma unroll
    for (int j = 0; j < (EB == 8 ? 1 : kMaxPerLane); ++j) {
      const int e = lane + 32 * j;
      if (e >= E) {
        v[j] = -INFINITY;
      } else if (ncl > 1) {
        v[j] = __ldcg(logits + (size_t)t * E + e);
      } else {
        v[j] = logit(t, e);
        logits[(size_t)t * E + e] = v[j];
      }
    }
    route_token(v, E, K, lane, gates + t * K, experts + t * K, ex + t * K);
  }
  __syncthreads();                                       // every token's experts are in ex
  if (warp != 0) return;
  // warp 0: each pair's slot (its rank among the earlier pairs of its
  // expert); the last pair of an expert sets its count
  for (int i = lane; i < T * K; i += 32) {
    const int e = ex[i];
    int rank = 0;
    bool last = true;
    for (int q = 0; q < T * K; ++q)
      if (ex[q] == e) {
        rank += q < i;
        last &= q <= i;
      }
    slots[i] = rank;
    if (rank < C) src[e * C + rank] = i / K;
    if (last) cnt[e] = rank + 1;
  }
  __syncwarp();
  warp_counts(cnt, E, C, counts, reads, lane);
}

// Prefill: a CTA the tile of tokens t0 + [0, 16) and experts e0 + [0, 16)
// (grid (ceil(E / 16), ceil(T / 16))). A stage holds the tile's x rows
// over 1024 d ([16][1024] bf16) and w's slice ([1024][16] bf16, each row
// two 16-byte chunks, chunk c of row r at chunk 2r + c xor (r / 8) % 8,
// so the 8 rows 8i + k that lanes i .. i + 7 read at once fall in 8
// bank groups). The CTA's TG x EG groups of 128 lanes split the tile:
// thread (group g, lane i) sums tokens (g % TG) 16 / TG + [0, 16 / TG) by
// experts (g / TG) 16 / EG + [0, 16 / EG) over its runs i + 128 j,
// staged j by j.
template <int TG, int EG>
__global__ void __launch_bounds__(128 * TG * EG, 1)
    moe_router_tile_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                           float* __restrict__ logits, int T, int D, int E) {
  constexpr int NT = 128 * TG * EG, TTt = kTileT / TG, EEt = kTileE / EG, NV = TTt * EEt;
  extern __shared__ uint8_t tile_smem[];
  const int tid = threadIdx.x, grp = tid >> 7, li = tid & 127, lane = tid & 31;
  const int tg = grp % TG, eg = grp / TG;
  const int e0 = blockIdx.x * kTileE, t0 = blockIdx.y * kTileT;
  const int steps = (D + kStepD - 1) / kStepD, runs = D / 8;
  auto xs = [&](int s) { return reinterpret_cast<bf16*>(tile_smem + s * kTileStage); };
  auto ws = [&](int s) { return tile_smem + s * kTileStage + kTileT * kStepD * 2; };
  auto issue = [&](int j) {
    const int s = j % kTileStages, d0 = j * kStepD;
    bf16* xd = xs(s);
    uint8_t* wd = ws(s);
#pragma unroll
    for (int n = 0; n < kTileT * (kStepD / 8) / NT; ++n) {
      const int q = tid + n * NT;
      const int t = q / (kStepD / 8), col = q % (kStepD / 8), d = d0 + 8 * col;
      const bool ok = t0 + t < T && d < D;
      cp_async16(xd + t * kStepD + 8 * col, ok ? x + (size_t)(t0 + t) * D + d : x, ok ? 16 : 0);
    }
#pragma unroll
    for (int n = 0; n < kStepD * 2 / NT; ++n) {
      const int q = tid + n * NT;
      const int r = q >> 1, c = q & 1;
      const bool ok = d0 + r < D && e0 + 8 * c < E;
      cp_async16(wd + ((2 * r + c) ^ ((r >> 3) & 7)) * 16,
                 ok ? w + (size_t)(d0 + r) * E + e0 + 8 * c : w, ok ? 16 : 0);
    }
  };
  float acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.f;
#pragma unroll
  for (int j = 0; j < kTileStages - 1; ++j) {
    if (j < steps) issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < steps; ++j) {
    cp_async_wait<kTileStages - 2>();
    __syncthreads();                                     // stage j is in; stage j - 1 is read
    if (j + kTileStages - 1 < steps) issue(j + kTileStages - 1);
    cp_async_commit();
    const int s = j % kTileStages;
    if (j * kLanes + li < runs) {
      const bf16* xd = xs(s);
      const uint8_t* wd = ws(s);
      uint4 xr[TTt];
#pragma unroll
      for (int t = 0; t < TTt; ++t)
        xr[t] = *reinterpret_cast<const uint4*>(xd + (TTt * tg + t) * kStepD + 8 * li);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = 8 * li + k;
        float wv[EEt];
#pragma unroll
        for (int c = 0; c < EEt / 8; ++c) {
          const uint4 wr = *reinterpret_cast<const uint4*>(
              wd + ((2 * r + (EEt / 8) * eg + c) ^ (li & 7)) * 16);
#pragma unroll
          for (int e = 0; e < 8; ++e) wv[8 * c + e] = run_at(wr, e);
        }
        run_fma<TTt, EEt>(acc, xr, k, wv);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                                       // the ring is free for the sums
  float* part = reinterpret_cast<float*>(tile_smem);     // (groups, 4 warps, NV)
  warp_tree<NV, 16>(acc, lane);
  const int base = tree_base<NV, 16>(lane);
#pragma unroll
  for (int k = 0; k < NV / 32; ++k) part[(grp * 4 + (li >> 5)) * NV + base + k] = acc[k];
  __syncthreads();
  for (int i = tid; i < kTileT * kTileE; i += NT) {
    const int tt = i / kTileE, ee = i % kTileE, t = t0 + tt, e = e0 + ee;
    const int g = (tt / TTt) + TG * (ee / EEt);
    if (t < T && e < E)
      logits[(size_t)t * E + e] =
          group_sum(part + g * 4 * NV, NV, (tt % TTt) * EEt + ee % EEt);
  }
}

// Prefill: a warp a token's routing from its logits row (NJ 32 >= E).
template <int NJ>
__global__ void __launch_bounds__(kTopkWarps * 32)
    moe_route_topk_kernel(const float* __restrict__ logits, int T, int E, int K,
                          float* __restrict__ gates, int* __restrict__ experts) {
  const int t = blockIdx.x * kTopkWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (t >= T) return;
  float v[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    v[j] = lane + 32 * j < E ? logits[(size_t)t * E + lane + 32 * j] : -INFINITY;
  route_token(v, E, K, lane, gates + t * K, experts + t * K, nullptr);
}

// One warp walks the pairs [lo, hi) of experts (flat (t, k) order), 32 at
// a time, loading kWalkBatch x 32 of them at once; for each group of 32,
// op(i, e, peers, rank) with i the lane's pair, e its expert (i < hi),
// peers the lanes of the group with the same expert (__match_any_sync)
// and rank the lane's place among them.
template <typename Op>
__device__ __forceinline__ void walk_pairs(const int* experts, int lo, int hi, int lane, Op op) {
  for (int b = lo; b < hi; b += 32 * kWalkBatch) {
    int ev[kWalkBatch];
#pragma unroll
    for (int u = 0; u < kWalkBatch; ++u) {
      const int i = b + 32 * u + lane;
      ev[u] = i < hi ? experts[i] : -1 - lane;           // idle lanes match no one
    }
#pragma unroll
    for (int u = 0; u < kWalkBatch; ++u) {
      if (b + 32 * u >= hi) break;
      const unsigned peers = __match_any_sync(0xffffffffu, ev[u]);
      op(b + 32 * u + lane, ev[u], peers, __popc(peers & ((1u << lane) - 1u)));
      __syncwarp();
    }
  }
}

// Prefill: the slots of the P = T K pairs, one CTA of kSlotWarps warps.
// Warp w takes the pairs [w seg, (w + 1) seg), seg = 32 ceil(P / (32 W))
// (kernels/moe.py::route_segment); cnt[w][e] counts its pairs of e, then
// the exclusive scan over w makes it the slot of warp w's first pair of
// e, and the warp ranks its pairs from there as the serial walk did (a
// running count an expert). Shared memory: cnt (W, E), the totals (E).
__global__ void __launch_bounds__(kSlotThreads)
    moe_route_slots_kernel(const int* __restrict__ experts, int P, int E, int K, int C,
                           int* __restrict__ slots, int* __restrict__ counts,
                           int* __restrict__ src, unsigned long long* __restrict__ reads) {
  extern __shared__ int cnt[];                           // (W, E), then the totals (E)
  int* total = cnt + kSlotWarps * E;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int seg = 32 * ((P + 32 * kSlotWarps - 1) / (32 * kSlotWarps));
  const int lo = min(P, warp * seg), hi = min(P, lo + seg);
  int* mine = cnt + warp * E;
  for (int i = tid; i < kSlotWarps * E; i += kSlotThreads) cnt[i] = 0;
  __syncthreads();
  walk_pairs(experts, lo, hi, lane, [&](int i, int e, unsigned peers, int rank) {
    if (i < hi && rank == 0) mine[e] += __popc(peers);
  });
  __syncthreads();
  for (int e = tid; e < E; e += kSlotThreads) {
    int run = 0;
    for (int w = 0; w < kSlotWarps; ++w) {
      const int c = cnt[w * E + e];
      cnt[w * E + e] = run;
      run += c;
    }
    total[e] = run;
  }
  __syncthreads();
  walk_pairs(experts, lo, hi, lane, [&](int i, int e, unsigned peers, int rank) {
    const int start = i < hi ? mine[e] : 0;
    __syncwarp();
    if (i < hi) {
      const int slot = start + rank;
      slots[i] = slot;
      if (slot < C) src[e * C + slot] = i / K;
      if (rank == __popc(peers) - 1) mine[e] = start + __popc(peers);
    }
  });
  if (warp == 0) warp_counts(total, E, C, counts, reads, lane);
}

// ----------------------------------------------------------------- gemm --
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
// N') instead, and moe_gemm_sum_kernel writes out (or, for moe_down at
// decode, moe_down_combine_kernel adds them into the combine).
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
    if (partial != nullptr) {
      // split route (or the decode's fused combine, one chunk or more):
      // the chunk's sums, f32, straight from the fragments
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

// a bf16 3-D map over base: dims (d0 contiguous, d1, d2), the byte
// strides of d1 and d2, boxes box; elements past the edges read as 0
bool make_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[3],
              const cuuint64_t (&strides)[2], const cuuint32_t (&box)[3],
              CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a bf16 (d2, d1, d0) tensor, d0 contiguous, as a 3-D map with boxes of
// b0 x b1 x 1 and the 128-byte swizzle
bool make_map(CUtensorMap* map, const void* base, int d0, int d1, int d2, int b0, int b1) {
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2, (cuuint64_t)d1 * d0 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  return make_map(map, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// sum: with partial, moe_gemm_sum_kernel writes out from the partials
// (else they are left for moe_down_combine_kernel)
template <int R, bool GLU>
cudaError_t launch_gemm(const bf16* a, const int* map, const bf16* w, const int* counts,
                        bf16* out, float* partial, bf16* gathered, int G, int C, int K, int N,
                        int rows, int kper, int ctas, cudaStream_t stream, bool sum = true) {
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
  if (e != cudaSuccess || partial == nullptr || !sum) return e;
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


// ------------------------------------------------- down + combine (decode) --
// moe_down's split-route sums and the combine in one pass, at decode
// (C <= the 16-row tile): out[t] = bf16(sum over k in order of gate[t, k]
// * f32(y_tk)) (+ shared, in bf16), where y_tk = bf16(sum over the chunks
// in order of partial[chunk, e_tk, slot_tk]) for a kept pair and 0 for a
// dropped one (slot >= C): the rounding points of moe_gemm_sum_kernel
// <false> followed by moe_combine_kernel, so out has their bits, and y is
// never written. grid (column runs of kDcCols, T); a thread kDcVec
// columns of its token. A warp reads the token's K (expert, slot, gate)
// once (lane k the pair k) and hands them round by shuffles; each thread
// issues up to kDcBatch of its (pair, chunk) loads before the first add.
// Bound: the partials of the token's kept pairs, read once, and out.
constexpr int kDcThreads = 128;
constexpr int kDcVec = 4;                       // columns a thread (one float4 a partial)
constexpr int kDcCols = kDcThreads * kDcVec;    // columns a CTA
constexpr int kDcBatch = 16;                    // loads a thread keeps in flight

__global__ void __launch_bounds__(kDcThreads)
    moe_down_combine_kernel(const float* __restrict__ partial, const float* __restrict__ gates,
                            const int* __restrict__ experts, const int* __restrict__ slots,
                            const bf16* __restrict__ shared, bf16* __restrict__ out, int G,
                            int K, int C, int D, int chunks) {
  const int t = blockIdx.y;
  const int c0 = (blockIdx.x * kDcThreads + threadIdx.x) * kDcVec;
  const int lane = threadIdx.x % 32;
  const bool live = c0 < D;                     // the loads and the store; every lane shuffles
  int e_l = 0, s_l = C;
  float g_l = 0.f;
  if (lane < K) {
    e_l = experts[t * K + lane];
    s_l = slots[t * K + lane];
    g_l = gates[t * K + lane];
  }
  const size_t plane = (size_t)G * C * D;
  const int n = K * chunks;                     // (pair, chunk) loads, pair-major
  float s[kDcVec], acc[kDcVec];
#pragma unroll
  for (int i = 0; i < kDcVec; ++i) s[i] = acc[i] = 0.f;
  for (int f0 = 0; f0 < n; f0 += kDcBatch) {
    float4 buf[kDcBatch];
#pragma unroll
    for (int j = 0; j < kDcBatch; ++j) {
      const int f = f0 + j, k = f / chunks, ch = f - k * chunks;
      const int e = __shfl_sync(0xffffffffu, e_l, k < K ? k : 0);
      const int sl = __shfl_sync(0xffffffffu, s_l, k < K ? k : 0);
      buf[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (f < n && sl < C && live)
        buf[j] = __ldcg(reinterpret_cast<const float4*>(
            partial + ch * plane + ((size_t)e * C + sl) * D + c0));
    }
#pragma unroll
    for (int j = 0; j < kDcBatch; ++j) {
      const int f = f0 + j, k = f / chunks, ch = f - k * chunks;
      const float gk = __shfl_sync(0xffffffffu, g_l, k < K ? k : 0);
      if (f >= n) continue;                     // uniform over the CTA
      const float v[kDcVec] = {buf[j].x, buf[j].y, buf[j].z, buf[j].w};
#pragma unroll
      for (int i = 0; i < kDcVec; ++i) s[i] = __fadd_rn(ch == 0 ? 0.f : s[i], v[i]);
      if (ch == chunks - 1) {                   // y_tk, rounded once; its term
#pragma unroll
        for (int i = 0; i < kDcVec; ++i) {
          const float term = __fmul_rn(__bfloat162float(__float2bfloat16_rn(s[i])), gk);
          acc[i] = k == 0 ? term : __fadd_rn(acc[i], term);
        }
      }
    }
  }
  if (!live) return;
  alignas(8) bf16 o[kDcVec];
#pragma unroll
  for (int i = 0; i < kDcVec; ++i) o[i] = __float2bfloat16_rn(acc[i]);
  if (shared != nullptr) {
    const uint2 raw = *reinterpret_cast<const uint2*>(shared + (size_t)t * D + c0);
    const bf16* sh = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < kDcVec; ++i)
      o[i] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(o[i]), __bfloat162float(sh[i])));
  }
  *reinterpret_cast<uint2*>(out + (size_t)t * D + c0) = *reinterpret_cast<const uint2*>(o);
}

}  // namespace

// the tiled router's split: 2 x 1 groups of 128 lanes (8 tokens x 16
// experts a thread)
constexpr int kTileTG = 2, kTileEG = 1;

// launches (kernels/moe.py::route_launches): 1, one launch of clusters of
// kClusterCtas CTAs (T <= kClusterT at E <= 32, T <= kClusterTWide
// above), or 3, the tiled router, the top-k and the slots. logits (T, E) f32 is written either way. ticket: an
// int32, 0 before the stream's first launch, that no other stream uses;
// more than one cluster needs it. Returns the first launch error.
extern "C" int moe_route(const void* x, const void* w, void* logits, int T, int D, int E,
                         int K, int C, void* gates, void* experts, void* slots, void* counts,
                         void* src, void* reads, void* ticket, int launches, void* stream) {
  if (K < 1 || K > kMaxK || E < K || E > 32 * kMaxPerLane || E % 8 || D < 8 || D % 8 || C < 1 ||
      !(launches == 3 || (launches == 1 && T <= (E <= 32 ? kClusterT : kClusterTWide))))
    return cudaErrorInvalidValue;
  if (T == 0) return cudaSuccess;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto x_ = static_cast<const bf16*>(x);
  const auto w_ = static_cast<const bf16*>(w);
  const auto lg = static_cast<float*>(logits);
  const auto g_ = static_cast<float*>(gates);
  const auto e_ = static_cast<int*>(experts);
  const auto s_ = static_cast<int*>(slots);
  const auto c_ = static_cast<int*>(counts);
  const auto m_ = static_cast<int*>(src);
  const auto r_ = static_cast<unsigned long long*>(reads);
  static bool sized = false;                      // once (one device)
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(moe_route_cluster_kernel<8, 1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(moe_route_cluster_kernel<64, 4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(moe_router_tile_kernel<kTileTG, kTileEG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTileStages * kTileStage);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(moe_route_slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (kSlotWarps + 1) * 32 * kMaxPerLane * 4);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  if (launches == 1) {
    // blocks of 8 experts a token a warp (E <= 32: phi3.5-moe's 16), else
    // of 64 experts 4 tokens a warp (T <= 4); a cluster two blocks (one
    // when E fits in one), so its 8 CTAs
    // take the 4 lane-warps of each; every item of a CTA in flight where
    // the ring holds them, else as many stages as fit
    const bool small = E <= 32;
    const int EB = small ? 8 : 64;
    const int ncl = ((E + EB - 1) / EB + kClusterBlocks - 1) / kClusterBlocks;
    if (ncl > 1 && ticket == nullptr) return cudaErrorInvalidValue;
    RouteMaps maps;
    memset(&maps, 0, sizeof(maps));
    {
      const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, 1};
      const cuuint64_t strides[2] = {2ull * D, 2ull * D * T};
      const cuuint32_t box[3] = {256, (cuuint32_t)T, 1};
      if (!make_map(&maps.x, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
        return cudaErrorInvalidValue;
    }
    {
      const cuuint64_t dims[3] = {(cuuint64_t)E, (cuuint64_t)D / 8, 8};
      const cuuint64_t strides[2] = {16ull * E, 2ull * E};
      const cuuint32_t box[3] = {(cuuint32_t)EB, 32, 8};
      if (!make_map(&maps.w, w_, dims, strides, box,
                    EB == 8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorInvalidValue;
    }
    const int threads = (small ? 32 * T : 4 * EB) + 32;  // and a producer warp
    const int Ec = E < kClusterBlocks * EB ? E : kClusterBlocks * EB;
    const int stage = ((T * 512 + 1023) & ~1023) + 512 * EB;
    const int tail = 1023 + (4 * T * Ec + E + ((T * K + 1) & ~1)) * 4 + 2 * kMaxStages * 8 + 4;
    // steps a unit (the most of any lane-warp) x units a CTA
    const int items = (D / 8 + kLanes - 1) / kLanes * ((4 * kClusterBlocks + 7) / 8);
    const int fit = (kSmemMax - tail) / stage;
    const int S = items < fit ? (items < kMaxStages ? items : kMaxStages) : fit;
    if (S < 1) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kClusterCtas * ncl);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = S * stage + tail;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kClusterCtas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const auto kernel = small ? moe_route_cluster_kernel<8, 1> : moe_route_cluster_kernel<64, 4>;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, maps, T, D, E, K, C, S, lg, g_, e_,
                                             s_, c_, m_, r_, static_cast<int*>(ticket));
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  moe_router_tile_kernel<kTileTG, kTileEG>
      <<<dim3((E + kTileE - 1) / kTileE, (T + kTileT - 1) / kTileT), 128 * kTileTG * kTileEG,
         kTileStages * kTileStage, st>>>(x_, w_, lg, T, D, E);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  (E <= 32 ? moe_route_topk_kernel<1> : moe_route_topk_kernel<kMaxPerLane>)
      <<<(T + kTopkWarps - 1) / kTopkWarps, kTopkWarps * 32, 0, st>>>(lg, T, E, K, g_, e_);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  moe_route_slots_kernel<<<1, kSlotThreads, (kSlotWarps + 1) * E * 4, st>>>(e_, T * K, E, K, C,
                                                                           s_, c_, m_, r_);
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

// moe_down and moe_combine in two launches at decode: the down GEMM of h
// (G, C, F) bf16 and w (G, F, D) over the rows c < counts[g] on the
// 16-row tile (C <= 16), its f32 sums into partial (chunks, G, C, D) by
// chunk (one chunk or more), then moe_down_combine_kernel: out (T, D) bf16
// from the token's K pairs (gates (T, K) f32, experts and slots (T, K)
// int32) and shared (T, D) bf16 or null. k_per_chunk and ctas as
// moe_gemm's. Returns the first failing launch's cudaError_t.
extern "C" int moe_down_combine(const void* h, const void* w, const void* counts,
                                const void* gates, const void* experts, const void* slots,
                                const void* shared, void* out, void* partial, int G, int C,
                                int F, int D, int T, int K, int k_per_chunk, int ctas,
                                void* stream) {
  if (G < 1 || G > kMaxGroups || C < 1 || C > 16 || F < 8 || F % 8 || D % 8 || T < 1 ||
      K < 1 || K > kMaxK || k_per_chunk < 64 || k_per_chunk % 64 || ctas < 1 ||
      partial == nullptr)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = launch_gemm<16, false>(
      static_cast<const bf16*>(h), nullptr, static_cast<const bf16*>(w),
      static_cast<const int*>(counts), nullptr, static_cast<float*>(partial), nullptr, G, C, F,
      D, G * C, k_per_chunk, ctas, s, /*sum=*/false);
  if (e != cudaSuccess) return e;
  const int chunks = (F + k_per_chunk - 1) / k_per_chunk;
  moe_down_combine_kernel<<<dim3((D + kDcCols - 1) / kDcCols, T), kDcThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(gates),
      static_cast<const int*>(experts), static_cast<const int*>(slots),
      static_cast<const bf16*>(shared), static_cast<bf16*>(out), G, K, C, D, chunks);
  return cudaGetLastError();
}
