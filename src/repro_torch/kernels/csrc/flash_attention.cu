// Tiled GQA prefill attention (flash attention) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas kernel
//   src/repro/kernels/flash_attention.py:87  flash_attention (_flash_kernel
//   :30, pallas_call at :111)
// out (B, Hq, Sq, D) = softmax(q k^T * D^-0.5, masked) v, with q (B, Hq,
// Sq, D) and k, v (B, Hkv, Skv, D), all bf16; query head h reads kv head
// h / G (G = Hq / Hkv). Masks: causal (key pos <= query pos), a sliding
// window (key pos > query pos - window when window > 0), keys past Skv;
// query positions are absolute, i + q_offset. A row with no visible key
// gives 0 (l == 0 is read as 1).
//
// Bound at the prefill path's shapes (H100 SXM, 3.35 TB/s, 989 TFLOP/s
// bf16): reading q, k, v once and writing o once, against 4 FLOPs per
// head dim per visible (query, key) pair. B 4, S 512 (llama3.2-1b, G 4):
// 21.0 MB -> 6.3 us against 4.3 GFLOP -> 4.3 us, bytes-bound. B 3,
// S 1024: 31.5 MB -> 9.4 us against 12.9 GFLOP -> 13.0 us,
// operations-bound. chip_smoke.py computes the bound of every timed call
// from its own inputs.
//
// Design. The Pallas kernel walks the KV blocks along a sequential grid
// axis and carries (m, l, acc) in VMEM scratch. CUDA blocks run in
// parallel and in no order, so each work item walks its own KV tiles in a
// loop, with the online-softmax state in registers. A work item is 128
// consecutive queries of one query head (its G - 1 sibling heads' items
// read the same K/V tiles through the L2). A CTA has 384 threads: two consumer warpgroups of 64 rows each and a producer
// warpgroup, which gives its registers to the consumers (setmaxnreg: 24
// against 240 a thread):
// - one producer thread feeds, by TMA, the item's Q tile (two buffers,
//   so the next item's loads while this one runs) and a ring of kStages
//   K/V tiles of BK keys (boxes of the (D, S, B*H) tensors, at most 64
//   columns each, with the 128-byte swizzle, 64-byte at D 32; rows past
//   Sq or Skv are zero filled), each stage with a full and an empty
//   mbarrier;
// - each consumer warpgroup runs both products with wgmma: S = Q K^T as
//   m64nBKk16 with Q in registers (bf16(q * scale), by ldmatrix from the
//   TMA tile) and K K-major in shared memory; P goes from the S
//   accumulators straight into the register A operand of O += P V,
//   m64n(D or 64)k16, with V N-major in shared memory (the descriptor's
//   transpose bit). The online softmax stays in registers, in exp2 form
//   with log2(e) folded into the f32 score scale; masks (one range test a
//   score) are applied only on tiles that cross a mask edge. Each warp
//   stages its 16 output rows in shared memory and stores them 16 bytes a
//   lane, whole rows at a time.
// - the products are software pipelined: the scores of tile i are issued
//   with the PV product of tile i - 1, and the softmax of tile i runs
//   while that product does; the two warpgroups take turns on the tensor
//   cores (named barriers), so one's softmax also overlaps the other's
//   products.
// The grid is persistent: at most one CTA per SM, taking the work items
// round robin in the order the caller gives, heaviest query tiles (most
// KV tiles to walk) first, so the long causal items start first and the
// short ones fill the tail; the items of one query tile are adjacent, so
// items that read the same K/V run together and meet in the L2. The
// tile sizes (kRows queries, BK keys), the order and the grid come from
// kernels/flash_attention.py, the one place they are set; this file
// instantiates those sizes and refuses others.
//
// Head dim 256 (recurrentgemma-2b's local attention) does not fit that
// shape: a Q tile is 64 KB, a K/V stage 64 KB at 64 keys, and Q in
// registers would be 64 more registers a consumer thread beside its 128 of
// O. So at D 256 (QSMEM) the tiles are BK 32 keys (3 stages of 32 KB), Q
// has one buffer and stays in shared memory: each consumer warp scales its
// own 16 rows there in place, bf16(q * scale), and S = Q K^T takes both
// operands from shared memory (wgmma m64n32k16, A and B by descriptor);
// the Q buffer is released after the item's output is stored, and each
// warp stages that output in its own 16 rows of it (the same swizzled
// layout) instead of a separate buffer: 164 KB a CTA in all. The
// producer loads the next item's Q only once the whole CTA has stored the
// current item's output.
//
// Invariant: a row's bits do not depend on Sq, Skv or the batch. KV tiles
// are anchored at key position 0 and have a fixed size per head dim; a
// row's scores and its PV sums depend only on its own query and the keys;
// tiles that an item walks but a row cannot see leave that row's (m, l,
// acc) bit for bit as they were (alpha = 1, p = 0). So a padded bucket's
// real rows equal the prompt prefilled alone.
//
// Numerics follow the model path's chunked_attention: q * scale is
// computed in f32 and rounded to bf16; scores are f32 sums of bf16
// products; masked scores are -1e30 and masked p is 0; p is rounded to
// bf16 for the PV product while l sums the unrounded f32 p; acc / l is
// rounded to bf16 at the end. Two f32 details differ from the plain
// version and move only the last f32 bits: exp as exp2 with log2(e)
// folded into the score scale, and acc / l as acc times 1 / l.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;                 // queries per work item: two m64 warpgroups
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128; // + the producer warpgroup
constexpr int kStages = 3;                 // K/V ring: a warpgroup holds two tiles (PV of
                                           // one, scores of the next) while the third loads
constexpr int kMaxTiles = 1024;            // query tiles one launch can order
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNotInstantiated = -1;       // no kernel for these (D, G, block_q, BK)

// Shared-memory geometry of one K or V tile of BK keys: D / kCols boxes of
// BK rows x kCols columns, each row one swizzle span (128 or 64 bytes).
template <int D, int BK>
struct Geo {
  static constexpr bool kQSmem = D > 128;                     // Q in shared memory (D 256)
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kBoxes = D / kCols;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kLayout = kRowBytes == 128 ? 1 : 2;  // wgmma descriptor: 128B / 64B swizzle
  static constexpr int kBoxBytes = BK * kRowBytes;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;         // K then V
  static constexpr int kQBytes = kRows * D * 2;               // a Q tile, kBoxes column boxes
  static constexpr int kQBufs = kQSmem ? 1 : 2;
  static constexpr int kOutPitch = D * 2 + 16;                // output staging row (padded)
  static constexpr int kOutBytes = kQSmem ? 0 : kRows * kOutPitch;  // QSMEM: in the Q tile
  static constexpr int kSmem = kStages * kStageBytes + kQBufs * kQBytes + kOutBytes +
                               (2 * kStages + 2 * kQBufs) * 8 + 1024;  // + alignment
};

struct Params {
  CUtensorMap q;                 // (D, Sq, B*Hq) bf16, boxes (kCols, kRows, 1)
  CUtensorMap k, v;              // (D, Skv, B*Hkv) bf16, boxes (kCols, BK, 1)
  uint16_t order[kMaxTiles];     // query tiles, heaviest first
};

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
// byte offsets (16-byte units), swizzle layout (1: 128B, 2: 64B).
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
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// named barriers 1 and 2 over the 256 consumer threads: the warpgroups
// take turns to issue their wgmma groups
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo = low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// d (m64 x N f32, in registers) (+)= a (m64 x k16 bf16, registers) * b
// (k16 x N bf16, shared memory by descriptor; TRANS_B 0: K-major, 1:
// N-major). Fragments as in the PTX ISA: warp w of the warpgroup holds
// rows 16w..16w+15; with gid = lane / 4, tig = lane % 4, a = {(gid, 2tig),
// (gid + 8, 2tig), (gid, 2tig + 8), (gid + 8, 2tig + 8)} (two consecutive
// k each) and d[4j + e] = (gid + 8 * (e >> 1), 8j + 2tig + (e & 1)).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float* d, const uint32_t a[4], uint64_t desc,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %21, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc), "n"(TRANS_B));
  }
};

// d (m64 x 32 f32) (+)= a (m64 x k16 bf16) * b (k16 x 32 bf16), both
// K-major in shared memory by descriptor (the QSMEM route's Q K^T)
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t adesc, uint64_t bdesc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operands, TMA writes after them)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <>
struct Wgmma<64> {
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float* d, const uint32_t a[4], uint64_t desc,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %37, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc), "n"(TRANS_B));
  }
};

template <>
struct Wgmma<128> {
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float* d, const uint32_t a[4], uint64_t desc,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %69, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc), "n"(TRANS_B));
  }
};


// One work item: a query tile of one (batch row, query head), and the KV
// tiles [kt0, kt0 + n_kv) that any of its rows can see.
struct Item {
  int bh, kv, q0, qa_lo, qa_hi, kt0, n_kv;
};

// Item w of BH * n_tiles (BH = B * Hq), in launch order: query tile
// order[w / BH] of (batch row, query head) w % BH
template <int G, int BK>
__device__ __forceinline__ Item item_at(const Params& p, int w, int BH, int Sq, int Skv,
                                        int causal, int window, int q_offset) {
  Item it;
  it.bh = w % BH;                               // b * Hq + head
  it.kv = it.bh / G;                            // b * Hkv + kv head
  it.q0 = p.order[w / BH] * kRows;
  it.qa_lo = it.q0 + q_offset;
  it.qa_hi = min(it.q0 + kRows, Sq) - 1 + q_offset;
  const int k_end = causal ? max(0, min(Skv, it.qa_hi + 1)) : Skv;
  const int k_lo = window > 0 ? max(0, it.qa_lo - window + 1) : 0;
  it.kt0 = k_lo / BK;
  it.n_kv = max(0, (k_end + BK - 1) / BK - it.kt0);
  return it;
}

// Persistent: gridDim.x CTAs (at most one per SM) take the BH * n_tiles
// work items round robin in launch order, so each CTA starts with the
// heaviest; the producer runs on into the next item (its Q tile and first
// K/V tiles) while the consumers finish the current one.
template <int D, int G, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ Params p, bf16* __restrict__ out, int Sq, int Skv,
                       int causal, int window, int q_offset, float scale, int BH, int items) {
  using T = Geo<D, BK>;
  constexpr int KSTEPS = D / 16;           // k16 steps of Q K^T
  constexpr int PSTEPS = BK / 16;          // k16 steps of P V
  constexpr int KPB = T::kCols / 16;       // k16 steps per box row
  static_assert(kStages >= 3, "a tile's slot is released only after the next tile has arrived");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qsm = smem + kStages * T::kStageBytes;          // kQBufs Q tiles
  uint8_t* osm = qsm + T::kQBufs * T::kQBytes;             // output staging (not QSMEM)
  uint64_t* full = reinterpret_cast<uint64_t*>(osm + T::kOutBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;
  uint64_t* qempty = qfull + T::kQBufs;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 128);   // one arrival per consumer warpgroup
    }
    for (int s = 0; s < T::kQBufs; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], kConsumers / 32);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                      // producer warpgroup: one thread issues every copy
    // registers go to the consumers (24 + 2 x 240 per thread of each warpgroup fit 64K)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers) {
      int it = 0;                               // K/V ring slot, counted over all items
      for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
        const Item I = item_at<G, BK>(p, w, BH, Sq, Skv, causal, window, q_offset);
        if constexpr (T::kQSmem) {
          // one Q buffer; the box loops stay rolled at D 256 (this thread
          // runs on 24 registers)
          if (n >= 1) mbar_wait(&qempty[0], (n - 1) & 1);
          mbar_expect_tx(&qfull[0], T::kQBytes);
#pragma unroll 1
          for (int bx = 0; bx < T::kBoxes; ++bx)
            tma_3d(qsm + bx * kRows * T::kRowBytes, &p.q, bx * T::kCols, I.q0, I.bh, &qfull[0]);
        } else {
          const int qb = n & 1;
          if (n >= 2) mbar_wait(&qempty[qb], ((n >> 1) - 1) & 1);
          mbar_expect_tx(&qfull[qb], T::kQBytes);
#pragma unroll
          for (int bx = 0; bx < T::kBoxes; ++bx)
            tma_3d(qsm + qb * T::kQBytes + bx * kRows * T::kRowBytes, &p.q, bx * T::kCols, I.q0,
                   I.bh, &qfull[qb]);
        }
        for (int i = 0; i < I.n_kv; ++i, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
          mbar_expect_tx(&full[s], T::kStageBytes);
          uint8_t* kd = smem + s * T::kStageBytes;
          const int t0 = (I.kt0 + i) * BK;
          if constexpr (T::kQSmem) {
#pragma unroll 1
            for (int bx = 0; bx < T::kBoxes; ++bx) {
              tma_3d(kd + bx * T::kBoxBytes, &p.k, bx * T::kCols, t0, I.kv, &full[s]);
              tma_3d(kd + T::kTileBytes + bx * T::kBoxBytes, &p.v, bx * T::kCols, t0, I.kv,
                     &full[s]);
            }
          } else {
#pragma unroll
            for (int bx = 0; bx < T::kBoxes; ++bx) {
              tma_3d(kd + bx * T::kBoxBytes, &p.k, bx * T::kCols, t0, I.kv, &full[s]);
              tma_3d(kd + T::kTileBytes + bx * T::kBoxBytes, &p.v, bx * T::kCols, t0, I.kv,
                     &full[s]);
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // consumers: warp w holds the item's queries 16w..16w+15
    const int warp = tid / 32, lane = tid % 32;
    const int gid = lane >> 2, tig = lane & 3;
    // this lane's ldmatrix row of the Q tile, and its swizzle
    const int lrow = warp * 16 + (lane & 15);
    const int lswz = T::kLayout == 1 ? (lrow & 7) : ((lrow >> 1) & 3);
    float o[D / 2], sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;

    // Ping-pong: the two warpgroups take turns on the tensor cores, so one's
    // softmax runs while the other's products do. Both issue the same
    // number of groups; warpgroup 1 hands the first turn to warpgroup 0,
    // which takes the last hand-back after its loop.
    const int my_turn = 1 + warp / 4, other_turn = 2 - warp / 4;
    if (warp / 4 == 1) turn_pass(1);
    int it = 0;
    for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
      const Item I = item_at<G, BK>(p, w, BH, Sq, Skv, causal, window, q_offset);
      const int qi = I.q0 + warp * 16 + gid;       // query of rows r = 0 (qi) and 1 (qi + 8)
      const int pos[2] = {qi + q_offset, qi + 8 + q_offset};

      // Q as the A operand: bf16(q * scale), from the TMA tile (0 past Sq):
      // into registers, or (QSMEM) scaled in place in the tile, each warp
      // its own 16 rows, then made visible to the warpgroup's wgmma
      const int qb = n & 1;                        // (QSMEM: one buffer)
      uint32_t qf[T::kQSmem ? 1 : KSTEPS][4];
      if constexpr (T::kQSmem) {
        mbar_wait(&qfull[0], n & 1);
        // 16 rows x kBoxes boxes x 8 chunks of 16 bytes
#pragma unroll 1
        for (int c = lane; c < 16 * T::kBoxes * 8; c += 32) {
          const int row = warp * 16 + c / (T::kBoxes * 8), bx = (c / 8) % T::kBoxes;
          uint4* at = reinterpret_cast<uint4*>(qsm + bx * kRows * T::kRowBytes +
                                               row * T::kRowBytes + (c % 8) * 16);
          uint4 v = *at;
          uint32_t* pair = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&pair[r]);
            pair[r] = pack_bf16(__bfloat162float(x.x) * scale, __bfloat162float(x.y) * scale);
          }
          *at = v;
        }
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" ::"r"(3 + warp / 4) : "memory");
      } else {
        mbar_wait(&qfull[qb], (n >> 1) & 1);
        const uint32_t qbase = smem_addr(qsm + qb * T::kQBytes) + lrow * T::kRowBytes;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const int chunk = (kk % KPB) * 2 + (lane >> 4);
          ldmatrix_x4(qf[kk], qbase + (kk / KPB) * kRows * T::kRowBytes + ((chunk ^ lswz) << 4));
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&qf[kk][r]);
            qf[kk][r] = pack_bf16(__bfloat162float(x.x) * scale, __bfloat162float(x.y) * scale);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&qempty[qb]);
      }

#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
      uint32_t pf[PSTEPS][4];                       // bf16(p) of the tile in the PV product

      // S = Q K^T of ring slot `slot` into sc, committed as one group
      // (K-major: each k16 step starts 32 bytes further into a box row)
      auto issue_s = [&](int slot) {
        const uint32_t kbase = smem_addr(smem + slot * T::kStageBytes);
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          if constexpr (T::kQSmem) {
            // the warpgroup's 64 rows of Q's box kk / KPB
            const uint32_t qaddr = smem_addr(qsm) + (kk / KPB) * kRows * T::kRowBytes +
                                   (warp / 4) * 64 * T::kRowBytes + (kk % KPB) * 32;
            wgmma_ss_n32(sc, make_desc(qaddr, 16, 8 * T::kRowBytes, T::kLayout),
                         make_desc(kbase + (kk / KPB) * T::kBoxBytes + (kk % KPB) * 32, 16,
                                   8 * T::kRowBytes, T::kLayout),
                         kk > 0);
          } else {
            Wgmma<BK>::template rs<0>(
                sc, qf[kk],
                make_desc(kbase + (kk / KPB) * T::kBoxBytes + (kk % KPB) * 32, 16,
                          8 * T::kRowBytes, T::kLayout),
                kk > 0);
          }
        }
        wgmma_commit();
      };
      // O += bf16(p) V of ring slot `slot`, committed as one group (V
      // N-major: each k16 step starts 16 key rows further on)
      auto issue_pv = [&](int slot) {
        const uint32_t vbase = smem_addr(smem + slot * T::kStageBytes) + T::kTileBytes;
#pragma unroll
        for (int kk = 0; kk < PSTEPS; ++kk)
#pragma unroll
          for (int bx = 0; bx < T::kBoxes; ++bx)
            Wgmma<T::kCols>::template rs<1>(
                o + bx * (T::kCols / 2), pf[kk],
                make_desc(vbase + bx * T::kBoxBytes + kk * 16 * T::kRowBytes, T::kBoxBytes,
                          8 * T::kRowBytes, T::kLayout),
                1);
        wgmma_commit();
      };
      // the online softmax of the scores in sc for keys [t0, t0 + BK): masks
      // (MASK: on tiles that cross an edge), row max over the quad, p =
      // exp2(s * log2 e - m * log2 e) left in sc, l += the f32 p; alpha
      // rescales what came before. A masked score is -1e30, so its p is
      // exactly 0 once the row has seen a key; until then the row's max is
      // -1e30 too and is taken as 0 in the exponent, which keeps p 0.
      auto softmax = [&](auto mask, int t0, float alpha[2]) {
        if constexpr (decltype(mask)::value) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            // the row's visible keys as offsets from this thread's first column
            const int lo = window > 0 ? max(0, pos[r] - window + 1) : 0;
            const int hi = causal ? min(pos[r], Skv - 1) : Skv - 1;
            const int kmin = lo - t0 - tig * 2, kmax = hi - t0 - tig * 2;
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int k = j * 8 + c;
                float& x = sc[4 * j + 2 * r + c];
                x = k >= kmin && k <= kmax ? x : kNegInf;
              }
          }
        }
        // four partial maxima and sums per row: short dependency chains
        float mx4[2][4], sum4[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            mx4[r][c] = kNegInf;
            sum4[r][c] = 0.f;
          }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx4[e >> 1][(j & 1) * 2 + (e & 1)] =
                fmaxf(mx4[e >> 1][(j & 1) * 2 + (e & 1)], sc[4 * j + e]);
        float mx[2], mb[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3]));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          alpha[r] = ex2((m[r] - m_new) * kLog2e);
          mb[r] = m_new == kNegInf ? 0.f : m_new * kLog2e;
          m[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pv = ex2(fmaf(sc[4 * j + e], kLog2e, -mb[e >> 1]));
            sum4[e >> 1][(j & 1) * 2 + (e & 1)] += pv;
            sc[4 * j + e] = pv;
          }
        float sum[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] = (sum4[r][0] + sum4[r][1]) + (sum4[r][2] + sum4[r][3]);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          l[r] = l[r] * alpha[r] + sum[r];
        }
      };
      // bf16(p) from sc into the A fragments of the PV product
      auto pack_p = [&]() {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          pf[j / 2][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
          pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
        }
      };
      // does the tile at key t0 cross a mask edge for some row of the item?
      auto edge = [&](int t0) {
        return t0 + BK > Skv || (causal && t0 + BK - 1 > I.qa_lo) ||
               (window > 0 && t0 <= I.qa_hi - window);
      };

      // Software pipeline: the scores of tile i run on the tensor cores
      // together with the PV product of tile i - 1, and the softmax of tile
      // i overlaps that product; the wait for it comes only at the next
      // step, behind the turn barrier, where the compiler cannot hoist it
      // above the softmax. Per row the arithmetic is unchanged: o = o *
      // alpha_i + bf16(p_i) v_i, tile after tile. Each step is compiled
      // with and without masks, so no branch splits a step.
      float alpha[2];
      int s = it % kStages, sp = s;                 // the slots of tiles i and i - 1
      // before the PV product of tile i - 1: the one of tile i - 2 is done
      // (its slot, if any, goes back to the producer), o is rescaled by
      // alpha_(i-1) and p_(i-1) packed
      auto settle = [&](int done_slot) {
        wgmma_wait<0>();
        fence_regs<D / 2>(o);
        fence_regs<PSTEPS>(pf);
        if (done_slot >= 0 && tid % 128 == 0) mbar_arrive(&empty[done_slot]);
#pragma unroll
        for (int i2 = 0; i2 < D / 2; ++i2) o[i2] *= alpha[(i2 >> 1) & 1];
        pack_p();
      };
      auto first = [&](auto mask) {
        mbar_wait(&full[s], (it / kStages) & 1);
        turn_wait(my_turn);
        wgmma_fence();
        issue_s(s);
        turn_pass(other_turn);
        wgmma_wait<0>();
        fence_regs<BK / 2>(sc);
        softmax(mask, I.kt0 * BK, alpha);
      };
      auto next = [&](auto mask, int i) {
        const int s2 = sp;                          // the slot of tile i - 2
        sp = s;
        ++it;
        s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        turn_wait(my_turn);
        settle(i >= 2 ? s2 : -1);
        wgmma_fence();
        issue_s(s);
        issue_pv(sp);
        turn_pass(other_turn);
        wgmma_wait<1>();                            // the scores of tile i
        fence_regs<BK / 2>(sc);
        softmax(mask, (I.kt0 + i) * BK, alpha);
      };
      if (I.n_kv > 0) {
        if (edge(I.kt0 * BK))
          first(std::true_type{});
        else
          first(std::false_type{});
        for (int i = 1; i < I.n_kv; ++i) {
          if (edge((I.kt0 + i) * BK))
            next(std::true_type{}, i);
          else
            next(std::false_type{}, i);
        }
        turn_wait(my_turn);
        settle(I.n_kv >= 2 ? sp : -1);
        wgmma_fence();
        issue_pv(s);
        turn_pass(other_turn);
        wgmma_wait<0>();
        fence_regs<D / 2>(o);
        fence_regs<PSTEPS>(pf);
        if (tid % 128 == 0) mbar_arrive(&empty[s]);
        ++it;
      }

      // acc / l as acc times the f32 reciprocal of l (within two f32 ulps
      // of the quotient, far below the one bf16 rounding; a division per
      // element, each with its own slow-path branch, took longer than a
      // KV tile), staged through shared memory by each warp for its own 16
      // rows, then stored 16 bytes a lane, whole rows at a time (fragment
      // stores scatter 4 bytes a row); rows past Sq not stored
      constexpr int kChunks = D / 8;                 // 16-byte chunks a row
      if constexpr (T::kQSmem) {
        // staged in the warp's own 16 rows of the Q tile, at Q's swizzled
        // addresses (box ch / 8, chunk (ch % 8) ^ (row % 8)); the
        // warpgroup's last wgmma reading them completed above
        auto staged = [&](int row, int ch) -> uint8_t* {
          const int R = warp * 16 + row;
          return qsm + (ch / 8) * kRows * T::kRowBytes + R * T::kRowBytes +
                 (((ch % 8) ^ (R & 7)) << 4);
        };
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(staged(gid + 8 * r, j) + tig * 4) =
                pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        }
        __syncwarp();
        bf16* obase = out + ((size_t)I.bh * Sq + (qi - gid)) * D;
        // (four stores at a time: unrolled whole, the stores' addresses
        // took registers that the O accumulator needs, and ptxas spilled)
#pragma unroll 4
        for (int c = lane; c < 16 * kChunks; c += 32) {
          const int row = c / kChunks, ch = c % kChunks;
          if (qi - gid + row < Sq)
            *reinterpret_cast<uint4*>(obase + row * D + ch * 8) =
                *reinterpret_cast<const uint4*>(staged(row, ch));
        }
        __syncwarp();
        // the tile goes back to the producer, whose TMA writes the next Q
        fence_proxy_async();
        if (lane == 0) mbar_arrive(&qempty[0]);
      } else {
        uint8_t* stage = osm + warp * 16 * T::kOutPitch;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(stage + (gid + 8 * r) * T::kOutPitch + j * 16 + tig * 4) =
                pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
        }
        __syncwarp();
        bf16* obase = out + ((size_t)I.bh * Sq + (qi - gid)) * D;
#pragma unroll
        for (int c = lane; c < 16 * kChunks; c += 32) {
          const int row = c / kChunks, ch = c % kChunks;
          if (qi - gid + row < Sq)
            *reinterpret_cast<uint4*>(obase + row * D + ch * 8) =
                *reinterpret_cast<const uint4*>(stage + row * T::kOutPitch + ch * 16);
        }
        __syncwarp();
      }
    }
    if (warp / 4 == 0) turn_wait(1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// q, k or v (B*H, S, D) as a 3-D map with boxes of kCols x rows x 1;
// positions past S read as 0
template <int D, int BK>
bool make_map(CUtensorMap* map, const void* base, int S, int BH, int rows) {
  using T = Geo<D, BK>;
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)T::kCols, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            T::kLayout == 1 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D, int G, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int Hkv,
                   int Sq, int Skv, int causal, int window, int q_offset, float scale,
                   const uint16_t* order, int n_tiles, int ctas, cudaStream_t st) {
  using T = Geo<D, BK>;
  auto kernel = flash_attention_kernel<D, G, BK>;
  const int BH = B * Hkv * G;          // (batch row, query head) pairs
  Params p;                            // copied into the launch
  if (!make_map<D, BK>(&p.q, q, Sq, BH, kRows) || !make_map<D, BK>(&p.k, k, Skv, B * Hkv, BK) ||
      !make_map<D, BK>(&p.v, v, Skv, B * Hkv, BK))
    return cudaErrorInvalidValue;
  memcpy(p.order, order, sizeof(uint16_t) * n_tiles);
  static bool attr_set = false;        // once per instantiation (one device)
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  kernel<<<ctas, kThreads, T::kSmem, st>>>(p, static_cast<bf16*>(out), Sq, Skv, causal, window,
                                           q_offset, scale, BH, n_tiles * BH);
  return cudaGetLastError();
}

}  // namespace

// q (B, Hkv*G, Sq, D), k and v (B, Hkv, Skv, D), out like q; all bf16,
// contiguous, 16-byte aligned. block_q (queries per work item, of one
// query head) and block_k (keys per KV tile) come from the caller, as do
// order (the n_tiles = ceil(Sq / block_q) query tiles, heaviest first; at
// most 1024) and ctas (the persistent grid: at most one CTA per SM). The
// (D, G) pairs are those of the configs the port serves: llama3.2-1b
// (64, 4), qwen2-0.5b (64, 7), qwen2-1.5b (128, 6), llama3.2-3b (128, 3),
// llama3.1-8b, mistral-7b and mistral-nemo-12b (128, 4), deepseek-7b
// (128, 1), deepseek-67b and qwen1.5-110b (128, 8; kimi-k2's attention
// too), recurrentgemma-2b (256, 10), and the reduced smoke versions (32,
// 2); a config with another pair adds it here, with block_k 128 at D <= 64,
// 64 at D 128 and 32 at D 256 (the tile sizes of
// kernels/flash_attention.py::block_k). G enters only the
// work item's kv head (query head / G), so any G serves. Returns the
// launch's cudaError_t (0 on success), or -1 when no kernel is
// instantiated for (D, G, block_q, block_k).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                               int Hkv, int G, int Sq, int Skv, int D, int causal, int window,
                               int q_offset, float scale, int block_q, int block_k,
                               const void* order, int n_tiles, int ctas, void* stream) {
  if (n_tiles < 1 || n_tiles > kMaxTiles || (long long)n_tiles * block_q < Sq ||
      (long long)(n_tiles - 1) * block_q >= Sq || ctas < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* ord = static_cast<const uint16_t*>(order);
  if (block_q != kRows) return kNotInstantiated;
#define FA_CASE(D_, G_, BK_)                                                                   \
  if (D == D_ && G == G_ && block_k == BK_)                                                    \
    return launch<D_, G_, BK_>(q, k, v, out, B, Hkv, Sq, Skv, causal, window, q_offset, scale, \
                               ord, n_tiles, ctas, st);
  FA_CASE(64, 4, 128)
  FA_CASE(128, 1, 64)
  FA_CASE(32, 2, 128)
  FA_CASE(64, 7, 128)
  FA_CASE(128, 6, 64)
  FA_CASE(128, 3, 64)
  FA_CASE(128, 4, 64)
  FA_CASE(128, 8, 64)
  FA_CASE(256, 10, 32)
#undef FA_CASE
  return kNotInstantiated;
}
