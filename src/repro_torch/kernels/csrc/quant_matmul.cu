// W8A16 / W4A16 groupwise dequant GEMM on the tensor cores, for sm_90a.
//
// Replaces the JAX package's Pallas kernel
//   src/repro/kernels/quant_matmul.py:79  quant_matmul (_qmm_kernel,
//   _dequant_block_q8 / _dequant_block_q4; pallas_call at :117)
// out (M, N) = x (M, K) @ dequant(w), with w stored (K, N), N contiguous:
// q8_0 int8 (K, N) or q4_0 nibble-packed int8 (K/2, N) (low nibble = even
// k), bf16 scales (K/group, N).
//
// Bound (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16). At decode M (1..8
// slots) the weight bytes, K*N*(1 + 2/32) for q8_0 and K*N*(0.5 + 2/32)
// for q4_0, over the memory rate. At prefill M (a bucket of 512-3072
// rows) the 2*M*K*N operations over the tensor-core rate.
//
// Design: one kernel, one instruction shape, for every M. The product is
// computed transposed (swap AB): out^T (N, M) = w^T (N, K) x^T (K, M),
// so the weights are the A operand and the activations the B operand of
// mma.sync.m16n8k16 (bf16 in, f32 accumulate). A warp owns 32 output
// columns (two m16 tiles) and steps through x 8 rows (one n8) at a
// time: decode M fills one n8, a prefill CTA holds 128 rows of x (16 n8
// per CTA, 8 per warp) and reuses every dequantized weight fragment
// across them. The int8 payload, its bf16 scales and the bf16 rows of x
// stream through a shared-memory ring of 32-k tiles (4 stages at decode
// M, 3 at prefill M) by TMA: one thread starts a stage's three tile
// copies and an mbarrier counts their bytes (per-thread cp.async of the
// same tiles left the kernel waiting on its loads). The payload lands
// with TMA's 128-byte swizzle and x with its 64-byte swizzle, so the
// fragment loads below hit distinct banks; where N is not a multiple of
// 16 (TMA needs 16-byte row pitches) the tiles are copied element by
// element into the same layout. Each thread dequantizes its A fragments
// straight from the shared int8 tile; it owns 4 consecutive columns
// (thread-to-row map permuted within the warp's 32 columns), so one
// 32-bit shared load gives 4 weights of one k row. x's B fragments come
// from the shared tile by ldmatrix. Two CTAs
// share an SM (at most 128 registers a thread), so one CTA's loads and
// dequantization overlap the other's tensor-core work (with one CTA of 8
// warps an SM they ran one after the other; PERF.md has the numbers).
//
// K is cut into chunks of k_per_split rows, planned from (K, N, group,
// SM count) alone, never from M. With one M tile (decode M, or up to
// 128 rows) the chunks go to separate CTAs (grid.y), so enough of them
// stream the weights: each writes its chunk's f32 sums, and a second
// kernel adds them in chunk order. With more M tiles the grid fills the
// card without a split: each CTA walks the chunks itself, sums each in
// its own accumulators and adds them, in chunk order, to a running sum
// in shared memory (each thread's own floats: registers are kept for
// two CTAs an SM). Both routes compute s = 0; s += chunk[c] in the same
// order, and every output element is summed by the same mma instructions
// in the same k order, at the same row of its m16 tile, whatever M: a
// row's bits do not depend on how many rows share the call (a prompt
// prefilled alone and inside a padded bucket round alike). Each output
// element belongs to one warp, so no warps combine inside a chunk.
//
// Numerics follow the Pallas kernel: each weight is rounded to bf16 as
// bf16(float(q) * float(scale)) before the product (q is exact in bf16
// and the product is rounded once, by fma.rn.bf16x2 with a -0 addend);
// products accumulate in f32 on the tensor cores; the sum is cast to
// out_dtype.
//
// quant_matmul_swiglu: h (M, F) = swiglu(x @ dequant(w)) for the fused
// gate-up weight w (K, 2F) = [gate | up], the FFN's first product with
// the SwiGLU of the JAX package's models/mlp.py:42-48 (which XLA fuses)
// as its last step. Without it the GEMM writes gu (M, 2F) bf16 to
// device memory and a SwiGLU kernel reads it back (67 MB and 33.5 MB
// more at M 2048, and one launch more at decode M). The main loop, tile
// shapes, chunk plan (from (K, 2F, group, SMs)) and chunk order are the
// GEMM's; only the step after the last chunk changes, so each gu
// element gets the bits it has in quant_matmul's output. Every gu
// element is rounded to bf16 as the GEMM's epilogue rounds it, then h =
// bf16(silu(g) * u) with the standalone SwiGLU's arithmetic
// (fused_ops.cu, swiglu_kernel): h is bit-equal to the unfused pair.
// With a split along K (one M tile) the GEMM writes its f32 partials as
// for quant_matmul and sum_splits_swiglu_kernel sums the gate and up
// partials of one h element in split order. Without a split, a cluster
// of two CTAs along grid.z computes the gate block (rank 0, columns n0)
// and the up block (rank 1, columns F + n0) of the same rows; after the
// chunks each reads the other's running sums through distributed shared
// memory and stores one of the two column pairs of every thread's four
// columns of h. gu never reaches device memory.
// The activation is a template parameter (ACT): kSilu above, or kGelu,
// the GeGLU of the hybrid family's FFN: h = bf16(bf16(gelu(g)) * u) with
// the JAX layers.gelu in f32 (fused_ops.cu's geglu_kernel has the same
// arithmetic), so h is bit-equal to geglu(quant_matmul(x, w)).
//
// quant_matmul's out may be a column range of a wider row: row m of the
// result starts ldc >= N elements after row m - 1 (the unfused V0
// projections write q, k and v, or g and u, into one row this way). Only
// the stores move; the sums, and so the bits, are those of a contiguous
// out, and the columns past N of each row are never written.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

#include "gelu.cuh"  // round_bf16, gelu_f32 (shared with fused_ops.cu, rglru.cu)

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;                     // 8 warps
constexpr int kBK = 32;                           // k rows per stage
constexpr int kBigMT = 128;                       // x rows per CTA past decode M
constexpr int kPlanN = 256;                       // columns per block, for the plan
constexpr int kPlanRound = 4;                     // chunks hold a multiple of this many groups

enum Fmt { kQ8 = 0, kQ4 = 1 };

// The CTA's shape for an M tile of MT rows: 8 warps of 32 columns each,
// along N only (MT 8) or 4 along N by 2 along M (MT 128). A stage holds
// the payload tile (128-column boxes, 128-byte swizzle), x (64-byte rows,
// 64-byte swizzle) and the scale row, each where TMA writes it.
template <int FMT, int MT>
struct Tile {
  static constexpr int kStages = MT >= 64 ? 3 : 4;  // shared-memory ring
  static constexpr int kWarpsM = MT >= 64 ? 2 : 1;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kBN = 32 * kWarpsN;        // columns per CTA
  static constexpr int kN8 = MT / kWarpsM / 8;    // n8 tiles of x per warp
  static constexpr int kWRows = FMT == kQ8 ? kBK : kBK / 2;   // payload rows
  static constexpr int kBoxes = kBN / 128;        // payload boxes of 128 columns
  static constexpr int kWBytes = kWRows * kBN;
  static constexpr int kXBytes = MT * kBK * 2;
  static constexpr int kSBytes = kBN * 2;
  static constexpr int kStage = (kWBytes + kXBytes + kSBytes + 1023) / 1024 * 1024;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kBars = kRing;                  // kStages mbarriers
  static constexpr int kRun = kRing + 1024;
  static constexpr int kSmem = kRun + MT * kBN * 4 + 1024;  // + alignment slack
};

// byte offset of (row r, column c) in a payload tile: 128-column boxes of
// kWRows rows, 16-byte chunks XORed with the row (TMA's 128-byte swizzle)
template <int ROWS>
__device__ __forceinline__ int w_off(int r, int c) {
  return (c >> 7) * ROWS * 128 + r * 128 + ((((c >> 4) & 7) ^ (r & 7)) << 4) + (c & 15);
}
// byte offset of 16-byte chunk q of x row m: 64-byte rows, chunks XORed
// with bits 1-2 of the row (TMA's 64-byte swizzle)
__device__ __forceinline__ int x_off(int m, int q) {
  return m * 64 + ((q ^ ((m >> 1) & 3)) << 4);
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

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
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
// a 2-D TMA tile copy global -> shared, completing on bar
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col); fragments as
// in the PTX ISA (gid = lane / 4, tig = lane % 4): a = {(gid, 2tig..+1),
// (gid + 8, 2tig..+1), (gid, 2tig + 8..+9), (gid + 8, 2tig + 8..+9)},
// b = {(k 2tig..+1, n gid), (k 2tig + 8..+9, n gid)}, c = {(gid, 2tig),
// (gid, 2tig + 1), (gid + 8, 2tig), (gid + 8, 2tig + 1)}.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16x2 a * b + c, rounded once
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

constexpr uint32_t kNegZero2 = 0x80008000u;      // bf16x2 (-0, -0)

// q8_0: the weights of byte P of rows wa (even k, low half) and wb (odd
// k), both XORed with 0x80808080 (q + 128), times the pair's scale.
// 0x4B0000uu is the float 2^23 + u, so q = that - (2^23 + 128) exactly.
template <int P>
__device__ __forceinline__ uint32_t dequant_q8(uint32_t wa, uint32_t wb, uint32_t sc) {
  constexpr uint32_t sel = 0x7440u | P;
  const float qa = __uint_as_float(__byte_perm(wa, 0x4B000000u, sel)) - 8388736.f;
  const float qb = __uint_as_float(__byte_perm(wb, 0x4B000000u, sel)) - 8388736.f;
  const __nv_bfloat162 q = __floats2bfloat162_rn(qa, qb);   // exact
  return fma_bf16x2(*reinterpret_cast<const uint32_t*>(&q), sc, kNegZero2);
}

// q4_0: the two weights of byte P of w (low nibble = even k, to the low
// half), w4 = w >> 4, times the pair's scale. 0x4300 | (nibble ^ 8) is
// the bf16 128 + (q + 8), so q = that - 136 exactly.
template <int P>
__device__ __forceinline__ uint32_t dequant_q4(uint32_t w, uint32_t w4, uint32_t sc) {
  constexpr uint32_t sel = P | (P << 4) | ((4 + P) << 8) | ((4 + P) << 12);
  const uint32_t v = (__byte_perm(w, w4, sel) & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t q = fma_bf16x2(v, 0x3F803F80u, 0xC308C308u);   // v * 1 - 136
  return fma_bf16x2(q, sc, kNegZero2);
}

struct Maps {
  CUtensorMap x, w, s;   // x (M, K) bf16; payload rows (.., N) int8; scales (K/group, N) bf16
};

// Stage one 32-k tile at k0 for columns [n0, n0 + BN) and rows [m0, m0 +
// MT): with TMA (VEC: N % 16 == 0; one thread issues it), else element by
// element into the same swizzled layout. Past N and M the tile is zero.
template <int FMT, int MT, bool VEC>
__device__ __forceinline__ void load_stage(uint8_t* st, uint64_t* bar, const Maps& maps,
                                           const bf16* x, const int8_t* w,
                                           const bf16* scales, int M, int K, int N,
                                           int group, int k0, int n0, int m0, int tid) {
  using T = Tile<FMT, MT>;
  uint8_t* ws = st;
  uint8_t* xs = st + T::kWBytes;
  bf16* ss = reinterpret_cast<bf16*>(st + T::kWBytes + T::kXBytes);
  const int prow0 = FMT == kQ8 ? k0 : k0 / 2;       // first payload row
  if (VEC) {
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, T::kWBytes + T::kXBytes + T::kSBytes);
#pragma unroll
      for (int b = 0; b < T::kBoxes; ++b)
        tma_2d(ws + b * T::kWRows * 128, &maps.w, n0 + 128 * b, prow0, bar);
      tma_2d(xs, &maps.x, k0, m0, bar);
      tma_2d(ss, &maps.s, n0, k0 / group, bar);
    }
    return;
  }
  const bf16* srow = scales + (size_t)(k0 / group) * N;
  for (int i = tid; i < T::kWRows * T::kBN; i += kThreads) {
    const int r = i / T::kBN, c = i % T::kBN;
    ws[w_off<T::kWRows>(r, c)] =
        n0 + c < N ? (uint8_t)w[(size_t)(prow0 + r) * N + n0 + c] : (uint8_t)0;
  }
  for (int i = tid; i < T::kBN; i += kThreads)
    ss[i] = n0 + i < N ? srow[n0 + i] : __float2bfloat16(0.f);
  for (int i = tid; i < MT * 4; i += kThreads) {
    const int r = i / 4, c = i % 4;
    const bool in = m0 + r < M;
    const bf16* src = in ? x + (size_t)(m0 + r) * K + k0 + 8 * c : x;
    cp_async16(xs + x_off(r, c), src, in ? 16 : 0);
  }
}

// silu(g) * u in f32, as fused_ops.cu's swiglu_kernel computes it
__device__ __forceinline__ float silu_mul(float g, float u) {
  const float s = __fdiv_rn(g, __fadd_rn(1.f, expf(-g)));
  return __fmul_rn(s, u);
}

// the gate-up epilogue's activation: none (the plain GEMM), SwiGLU, GeGLU
enum Act { kNoAct = 0, kSilu = 1, kGelu = 2 };

// h of the bf16 gate and up values g, u, before its rounding to bf16:
// silu(g) * u in f32, or bf16(gelu(g)) * u (exact in f32)
template <int ACT>
__device__ __forceinline__ float glu(float g, float u) {
  if constexpr (ACT == kGelu) return __fmul_rn(round_bf16(gelu_f32(g)), u);
  return silu_mul(g, u);
}

// One CTA of the GEMM: columns [n0, n0 + BN) of rows [blockIdx.x * MT,
// + MT). CTA y reduces the K chunks [y * cta_chunks, (y + 1) *
// cta_chunks), each of k_per_split rows; with gridDim.y > 1 it holds one
// chunk and writes it to partial. ACT != kNoAct: the CTA is one rank of a
// two-CTA cluster (quant_matmul_swiglu_kernel) and out is h (M, N / 2).
// out's rows are ldc elements apart (ldc >= N; N / 2 for h).
template <int FMT, int MT, bool VEC, int ACT>
__device__ __forceinline__ void qmm_cta(const Maps& maps, const bf16* __restrict__ x,
                                        const int8_t* __restrict__ w,
                                        const bf16* __restrict__ scales,
                                        void* __restrict__ out, float* __restrict__ partial,
                                        int out_f32, int M, int K, int N, int ldc, int group,
                                        int k_per_split, int cta_chunks, int n0) {
  using T = Tile<FMT, MT>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + T::kBars);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wn0 = (warp % T::kWarpsN) * 32;       // warp's first column in the CTA
  const int wm0 = (warp / T::kWarpsN) * (MT / T::kWarpsM);
  const int m0 = blockIdx.x * MT;
  const int k_begin = blockIdx.y * cta_chunks * k_per_split;
  const int k_end = min(K, k_begin + cta_chunks * k_per_split);
  const int tiles = (k_end - k_begin) / kBK;
  const int chunk_tiles = k_per_split / kBK;

  // acc[m16 tile t][n8 tile j][c fragment]: the current chunk; run4
  // (float4 (t * kN8 + j) * kThreads + tid in shared memory): the chunks
  // so far, in chunk order
  float acc[2][T::kN8][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int j = 0; j < T::kN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
  float4* run4 = reinterpret_cast<float4*>(smem + T::kRun);
#pragma unroll
  for (int i = 0; i < 2 * T::kN8; ++i) run4[i * kThreads + tid] = make_float4(0.f, 0.f, 0.f, 0.f);

  constexpr int kStages = T::kStages;
  if (VEC && tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles)
      load_stage<FMT, MT, VEC>(smem + s * T::kStage, bars + s, maps, x, w, scales, M, K, N,
                               group, k_begin + s * kBK, n0, m0, tid);
    if (!VEC) cp_async_commit();
  }

  for (int it = 0; it < tiles; ++it) {
    if (VEC) mbar_wait(bars + it % kStages, (it / kStages) & 1);
    else cp_async_wait<kStages - 2>();
    __syncthreads();                    // tile it landed; tile it - 1's readers done
    {
      const int nt = it + kStages - 1;
      if (nt < tiles)
        load_stage<FMT, MT, VEC>(smem + (nt % kStages) * T::kStage, bars + nt % kStages,
                                 maps, x, w, scales, M, K, N, group, k_begin + nt * kBK,
                                 n0, m0, tid);
      if (!VEC) cp_async_commit();
    }
    const uint8_t* st = smem + (it % kStages) * T::kStage;
    const uint8_t* ws = st;
    const uint8_t* xs = st + T::kWBytes;
    const int c4 = wn0 + 4 * gid;       // this thread's first column in the CTA

    // this thread's 4 columns' scales, each as a bf16x2 pair
    uint32_t sc[4];
    {
      const uint2 s4 = *reinterpret_cast<const uint2*>(st + T::kWBytes + T::kXBytes + 2 * c4);
      sc[0] = __byte_perm(s4.x, 0, 0x1010);
      sc[1] = __byte_perm(s4.x, 0, 0x3232);
      sc[2] = __byte_perm(s4.y, 0, 0x1010);
      sc[3] = __byte_perm(s4.y, 0, 0x3232);
    }
    // one n8 tile: x's B fragments for both k16 steps at once
    uint32_t b1[4];
    if (T::kN8 == 1) ldmatrix_x4(b1, xs + x_off(wm0 + lane % 8, lane / 8));

#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // A fragments of the two m16 tiles: tile t, row gid is column
      // 4 * gid + 2t, row gid + 8 is column 4 * gid + 2t + 1
      uint32_t a[2][4];
      if (FMT == kQ8) {
        const int r = 16 * s + 2 * tig;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(ws + w_off<T::kWRows>(r + 0, c4)) ^ 0x80808080u;
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(ws + w_off<T::kWRows>(r + 1, c4)) ^ 0x80808080u;
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(ws + w_off<T::kWRows>(r + 8, c4)) ^ 0x80808080u;
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(ws + w_off<T::kWRows>(r + 9, c4)) ^ 0x80808080u;
        a[0][0] = dequant_q8<0>(w0, w1, sc[0]);
        a[0][1] = dequant_q8<1>(w0, w1, sc[1]);
        a[0][2] = dequant_q8<0>(w2, w3, sc[0]);
        a[0][3] = dequant_q8<1>(w2, w3, sc[1]);
        a[1][0] = dequant_q8<2>(w0, w1, sc[2]);
        a[1][1] = dequant_q8<3>(w0, w1, sc[3]);
        a[1][2] = dequant_q8<2>(w2, w3, sc[2]);
        a[1][3] = dequant_q8<3>(w2, w3, sc[3]);
      } else {
        // payload row 8s + tig holds k 16s + 2tig, +1; row + 4 holds +8, +9
        const int r = 8 * s + tig;
        const uint32_t lo = *reinterpret_cast<const uint32_t*>(ws + w_off<T::kWRows>(r, c4));
        const uint32_t hi = *reinterpret_cast<const uint32_t*>(ws + w_off<T::kWRows>(r + 4, c4));
        const uint32_t lo4 = lo >> 4, hi4 = hi >> 4;
        a[0][0] = dequant_q4<0>(lo, lo4, sc[0]);
        a[0][1] = dequant_q4<1>(lo, lo4, sc[1]);
        a[0][2] = dequant_q4<0>(hi, hi4, sc[0]);
        a[0][3] = dequant_q4<1>(hi, hi4, sc[1]);
        a[1][0] = dequant_q4<2>(lo, lo4, sc[2]);
        a[1][1] = dequant_q4<3>(lo, lo4, sc[3]);
        a[1][2] = dequant_q4<2>(hi, hi4, sc[2]);
        a[1][3] = dequant_q4<3>(hi, hi4, sc[3]);
      }
      if (T::kN8 == 1) {
        mma_bf16(acc[0][0], a[0], b1[2 * s], b1[2 * s + 1]);
        mma_bf16(acc[1][0], a[1], b1[2 * s], b1[2 * s + 1]);
      } else {
        // two n8 tiles a time: B fragments of step s for tiles j, j + 1
#pragma unroll
        for (int j = 0; j < T::kN8; j += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, xs + x_off(wm0 + 8 * (j + lane / 16) + lane % 8,
                                    2 * s + (lane / 8) % 2));
          mma_bf16(acc[0][j], a[0], b[0], b[1]);
          mma_bf16(acc[1][j], a[1], b[0], b[1]);
          mma_bf16(acc[0][j + 1], a[0], b[2], b[3]);
          mma_bf16(acc[1][j + 1], a[1], b[2], b[3]);
        }
      }
    }

    // end of a chunk: run += chunk (a CTA of a split holds one chunk,
    // so its run is 0 + chunk)
    if ((it + 1) % chunk_tiles == 0 || it + 1 == tiles) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int j = 0; j < T::kN8; ++j) {
          float4 r = run4[(t * T::kN8 + j) * kThreads + tid];
          r.x += acc[t][j][0];
          r.y += acc[t][j][1];
          r.z += acc[t][j][2];
          r.w += acc[t][j][3];
          run4[(t * T::kN8 + j) * kThreads + tid] = r;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;
        }
    }
  }
  if (!VEC) cp_async_wait<0>();

  if constexpr (ACT != kNoAct) {
    // rank 0 holds the gate sums of h's columns hj.., rank 1 the up sums
    // of the same columns; rank r stores h for the column pair 2r, 2r + 1
    // of the thread's four (m16 tile t = r), from its own run sums and
    // the peer's at the same index
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    cluster.sync();                     // both CTAs' run sums are complete
    const float4* peer = cluster.map_shared_rank(run4, rank ^ 1);
    const float4* gate = rank ? peer : run4;
    const float4* up = rank ? run4 : peer;
    const int F = N / 2;
    const int hj = (blockIdx.z >> 1) * T::kBN + wn0 + 4 * gid + 2 * rank;
#pragma unroll
    for (int j = 0; j < T::kN8; ++j) {
      const int i = (rank * T::kN8 + j) * kThreads + tid;
      const float4 g4 = gate[i], u4 = up[i];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + wm0 + 8 * j + 2 * tig + e;
        if (m >= M) continue;
        // columns hj and hj + 1: c fragments (gid, 2tig + e), (gid + 8, 2tig + e)
        const float h0 = glu<ACT>(round_bf16(e ? g4.y : g4.x), round_bf16(e ? u4.y : u4.x));
        const float h1 = glu<ACT>(round_bf16(e ? g4.w : g4.z), round_bf16(e ? u4.w : u4.z));
        bf16* dst = static_cast<bf16*>(out) + (size_t)m * F + hj;
        if (VEC && hj + 1 < F) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(h0, h1);
        } else {
          if (hj < F) dst[0] = __float2bfloat16(h0);
          if (hj + 1 < F) dst[1] = __float2bfloat16(h1);
        }
      }
    }
    cluster.sync();                     // the peer's reads of this CTA's sums are done
    return;
  }

  // thread's outputs: rows m = wm0 + 8j + 2tig + e, columns n .. n + 3
  const int n = n0 + wn0 + 4 * gid;
#pragma unroll
  for (int j = 0; j < T::kN8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + wm0 + 8 * j + 2 * tig + e;
      if (m >= M) continue;
      const float4 r0 = run4[j * kThreads + tid], r1 = run4[(T::kN8 + j) * kThreads + tid];
      const float v[4] = {e ? r0.y : r0.x, e ? r0.w : r0.z, e ? r1.y : r1.x,
                          e ? r1.w : r1.z};
      if (gridDim.y > 1) {
        float* dst = partial + ((size_t)blockIdx.y * M + m) * N + n;
        if (VEC && n < N) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (n + c < N) dst[c] = v[c];
        }
      } else if (out_f32) {
        float* dst = static_cast<float*>(out) + (size_t)m * ldc + n;
        if (VEC && n < N) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (n + c < N) dst[c] = v[c];
        }
      } else {
        bf16* dst = static_cast<bf16*>(out) + (size_t)m * ldc + n;
        if (VEC && n < N) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          uint2 u;
          u.x = *reinterpret_cast<const uint32_t*>(&lo);
          u.y = *reinterpret_cast<const uint32_t*>(&hi);
          *reinterpret_cast<uint2*>(dst) = u;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (n + c < N) dst[c] = __float2bfloat16(v[c]);
        }
      }
    }
}

// grid: (ceil(M / MT), CTAs along K, ceil(N / BN))
template <int FMT, int MT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
quant_matmul_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ x,
                    const int8_t* __restrict__ w, const bf16* __restrict__ scales,
                    void* __restrict__ out, float* __restrict__ partial, int out_f32,
                    int M, int K, int N, int ldc, int group, int k_per_split,
                    int cta_chunks) {
  qmm_cta<FMT, MT, VEC, kNoAct>(maps, x, w, scales, out, partial, out_f32, M, K, N, ldc, group,
                                k_per_split, cta_chunks, blockIdx.z * Tile<FMT, MT>::kBN);
}

// quant_matmul_kernel under another name: the split-K partials of the
// gate-up product, which sum_splits_swiglu_kernel merges (a profile then
// counts the fused operation's time apart from quant_matmul's)
template <int FMT, int MT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
quant_matmul_swiglu_split_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ x,
                                 const int8_t* __restrict__ w, const bf16* __restrict__ scales,
                                 void* __restrict__ out, float* __restrict__ partial,
                                 int out_f32, int M, int K, int N, int ldc, int group,
                                 int k_per_split, int cta_chunks) {
  qmm_cta<FMT, MT, VEC, kNoAct>(maps, x, w, scales, out, partial, out_f32, M, K, N, ldc, group,
                                k_per_split, cta_chunks, blockIdx.z * Tile<FMT, MT>::kBN);
}

// h (M, N / 2) = swiglu(x @ dequant(w)) without a split along K. grid:
// (ceil(M / MT), 1, 2 * ceil(F / BN)), launched in clusters of (1, 1, 2):
// cluster c's rank 0 computes the gate columns [c * BN, + BN), rank 1 the
// up columns [F + c * BN, + BN). The gate block's columns past F and the
// up block's past 2F are computed and not stored.
template <int FMT, int MT, bool VEC, int ACT>
__global__ void __launch_bounds__(kThreads, 2)
quant_matmul_swiglu_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ x,
                           const int8_t* __restrict__ w, const bf16* __restrict__ scales,
                           bf16* __restrict__ h, int M, int K, int N, int group,
                           int k_per_split, int cta_chunks) {
  const int n0 = (blockIdx.z & 1) * (N / 2) + (blockIdx.z >> 1) * Tile<FMT, MT>::kBN;
  qmm_cta<FMT, MT, VEC, ACT>(maps, x, w, scales, h, nullptr, 0, M, K, N, N / 2, group,
                             k_per_split, cta_chunks, n0);
}

__device__ __forceinline__ void store(void* out, size_t i, float v, int out_f32) {
  if (out_f32) static_cast<float*>(out)[i] = v;
  else static_cast<bf16*>(out)[i] = __float2bfloat16(v);
}

// out[m, n] (rows ldc apart) = the split sums of element i = m * N + n
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  void* __restrict__ out, int out_f32, int splits,
                                  int N, int ldc, int MN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * MN + i];
  const int m = i / N;
  store(out, (size_t)m * ldc + (i - m * N), s, out_f32);
}

// h[m, j] = swiglu of the split sums of gu[m, j] and gu[m, F + j], each
// summed in split order (as sum_splits_kernel) and rounded to bf16
template <int ACT>
__global__ void sum_splits_swiglu_kernel(const float* __restrict__ partial,
                                         bf16* __restrict__ h, int splits, int M, int F) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * F) return;
  const int m = i / F, j = i - m * F;
  const size_t MN = (size_t)M * 2 * F;
  const float* p0 = partial + (size_t)m * 2 * F + j;
  float g = 0.f, u = 0.f;
  for (int p = 0; p < splits; ++p) {
    g += p0[p * MN];
    u += p0[p * MN + F];
  }
  h[i] = __float2bfloat16(glu<ACT>(round_bf16(g), round_bf16(u)));
}

constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// x rows per CTA (the kernel's MT) for a given M
constexpr int m_tile(int M) { return M <= 8 ? 8 : kBigMT; }

bool takes_group(int K, int group) {
  return group > 0 && group % kBK == 0 && K % group == 0;
}

struct Plan {
  int chunks, k_per_split;   // K cut into `chunks` runs of k_per_split rows
  int ctas;                  // CTAs along K (grid.y): chunks with one M tile, else 1
};

// The K chunks: aim at two CTAs per SM of the current device for one M
// tile of 256-column blocks, each chunk a multiple of kPlanRound
// quantization groups (fewer, longer chunks: each chunk end adds the
// chunk into the running sum, which costs the walking CTAs). The chunks
// depend on (K, N, group, SM count) only; M decides just whether they go
// to separate CTAs (one M tile, so the grid needs the split to fill the
// card) or are walked inside one.
Plan split_plan(int M, int K, int N, int group) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int groups = K / group;
  const int want = std::max(1, std::min(groups, ceil_div(2 * sms, ceil_div(N, kPlanN))));
  const int per = ceil_div(ceil_div(groups, want), kPlanRound) * kPlanRound;
  const int k_per_split = per * group;
  const int chunks = std::max(1, ceil_div(K, k_per_split));
  const bool one_m_tile = ceil_div(M, m_tile(M)) == 1;
  return {chunks, k_per_split, one_m_tile ? chunks : 1};
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

// A 2-D row-major map: rows of `cols` elements, `pitch` bytes apart;
// boxes of box_c x box_r elements; out-of-range elements read as 0.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int cols,
              int rows, size_t pitch, int box_c, int box_r, CUtensorMapSwizzle swz) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_c, (cuuint32_t)box_r};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the TMA maps of x, the payload and the scales (VEC only; zeros else)
template <int FMT, int MT, bool VEC>
bool make_maps(Maps* maps, const void* x, const void* w, const void* scales, int M, int K,
               int N, int group) {
  using T = Tile<FMT, MT>;
  memset(maps, 0, sizeof(*maps));
  if (!VEC) return true;
  const int prows = FMT == kQ8 ? K : K / 2;
  return make_map(&maps->x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (size_t)K * 2, kBK, MT,
                  CU_TENSOR_MAP_SWIZZLE_64B) &&
         make_map(&maps->w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, prows, (size_t)N, 128,
                  T::kWRows, CU_TENSOR_MAP_SWIZZLE_128B) &&
         make_map(&maps->s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, scales, N, K / group,
                  (size_t)N * 2, T::kBN, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// the GEMM: out, or with plan.ctas > 1 the split-K partials (GATE_UP:
// those of quant_matmul_swiglu)
template <int FMT, int MT, bool VEC, bool GATE_UP>
cudaError_t launch_gemm(const void* x, const void* w, const void* scales, void* out,
                        float* partial, int out_f32, int M, int K, int N, int ldc,
                        int group, Plan plan, cudaStream_t st) {
  using T = Tile<FMT, MT>;
  auto kernel = GATE_UP ? quant_matmul_swiglu_split_kernel<FMT, MT, VEC>
                        : quant_matmul_kernel<FMT, MT, VEC>;
  Maps maps;
  if (!make_maps<FMT, MT, VEC>(&maps, x, w, scales, M, K, N, group))
    return cudaErrorInvalidValue;
  static bool attr_set = false;        // once per instantiation (one device)
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(ceil_div(M, MT), plan.ctas, ceil_div(N, T::kBN));
  kernel<<<grid, kThreads, T::kSmem, st>>>(
      maps, static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
      static_cast<const bf16*>(scales), out, partial, out_f32, M, K, N, ldc, group,
      plan.k_per_split, plan.chunks / plan.ctas);
  return cudaGetLastError();
}

template <int FMT, int MT, bool VEC>
cudaError_t launch(const void* x, const void* w, const void* scales, void* out,
                   float* partial, int out_f32, int M, int K, int N, int ldc, int group,
                   Plan plan, cudaStream_t st) {
  cudaError_t err = launch_gemm<FMT, MT, VEC, false>(x, w, scales, out, partial, out_f32, M,
                                                     K, N, ldc, group, plan, st);
  if (err != cudaSuccess || plan.ctas == 1) return err;
  const int MN = M * N;
  sum_splits_kernel<<<ceil_div(MN, 256), 256, 0, st>>>(partial, out, out_f32,
                                                       plan.ctas, N, ldc, MN);
  return cudaGetLastError();
}

// h = swiglu(x @ dequant(w)), w (K, 2F): with a split along K the GEMM's
// partials and the fused merge; without, one launch of two-CTA clusters
template <int FMT, int MT, bool VEC, int ACT>
cudaError_t launch_swiglu(const void* x, const void* w, const void* scales, bf16* h,
                          float* partial, int M, int K, int F, int group, Plan plan,
                          cudaStream_t st) {
  using T = Tile<FMT, MT>;
  const int N = 2 * F;
  if (plan.ctas > 1) {
    cudaError_t err = launch_gemm<FMT, MT, VEC, true>(x, w, scales, nullptr, partial, 0, M, K,
                                                      N, N, group, plan, st);
    if (err != cudaSuccess) return err;
    sum_splits_swiglu_kernel<ACT><<<ceil_div(M * F, 256), 256, 0, st>>>(partial, h,
                                                                        plan.ctas, M, F);
    return cudaGetLastError();
  }
  auto kernel = quant_matmul_swiglu_kernel<FMT, MT, VEC, ACT>;
  Maps maps;
  if (!make_maps<FMT, MT, VEC>(&maps, x, w, scales, M, K, N, group))
    return cudaErrorInvalidValue;
  static bool attr_set = false;        // once per instantiation (one device)
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ceil_div(M, MT), 1, 2 * ceil_div(F, T::kBN));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 2;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, maps, static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
      static_cast<const bf16*>(scales), h, M, K, N, group, plan.k_per_split, plan.chunks);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int FMT, bool VEC>
cudaError_t dispatch_m(const void* x, const void* w, const void* scales, void* out,
                       float* partial, int out_f32, int M, int K, int N, int ldc, int group,
                       Plan plan, cudaStream_t st) {
  if (m_tile(M) == 8)
    return launch<FMT, 8, VEC>(x, w, scales, out, partial, out_f32, M, K, N, ldc, group, plan,
                               st);
  return launch<FMT, kBigMT, VEC>(x, w, scales, out, partial, out_f32, M, K, N, ldc, group,
                                  plan, st);
}

template <int FMT, bool VEC, int ACT>
cudaError_t dispatch_swiglu_act(const void* x, const void* w, const void* scales, bf16* h,
                                float* partial, int M, int K, int F, int group, Plan plan,
                                cudaStream_t st) {
  if (m_tile(M) == 8)
    return launch_swiglu<FMT, 8, VEC, ACT>(x, w, scales, h, partial, M, K, F, group, plan, st);
  return launch_swiglu<FMT, kBigMT, VEC, ACT>(x, w, scales, h, partial, M, K, F, group, plan,
                                              st);
}

template <int FMT, bool VEC>
cudaError_t dispatch_swiglu(int act, const void* x, const void* w, const void* scales, bf16* h,
                            float* partial, int M, int K, int F, int group, Plan plan,
                            cudaStream_t st) {
  if (act == kGelu)
    return dispatch_swiglu_act<FMT, VEC, kGelu>(x, w, scales, h, partial, M, K, F, group, plan,
                                                st);
  return dispatch_swiglu_act<FMT, VEC, kSilu>(x, w, scales, h, partial, M, K, F, group, plan,
                                              st);
}

}  // namespace

// The f32 scratch (in elements) that quant_matmul needs for its split-K
// partial sums at this shape on the current device: 0 unless K is split
// across CTAs (one M tile), -1 when the kernel does not take this group
// (it takes a multiple of 32 that divides K).
extern "C" int quant_matmul_workspace(int M, int K, int N, int group) {
  if (!takes_group(K, group)) return -1;
  const Plan plan = split_plan(M, K, N, group);
  return plan.ctas > 1 ? plan.ctas * M * N : 0;
}

// The launch grid for this shape on the current device: CTAs, CTAs along
// K (splits) and K chunks, written to grid[0..2]. Returns 0, or -1 for a
// group the kernel does not take.
extern "C" int quant_matmul_grid(int M, int K, int N, int group, int* grid) {
  if (!takes_group(K, group)) return -1;
  const Plan plan = split_plan(M, K, N, group);
  const int bn = m_tile(M) == 8 ? Tile<kQ8, 8>::kBN : Tile<kQ8, kBigMT>::kBN;
  grid[0] = ceil_div(M, m_tile(M)) * plan.ctas * ceil_div(N, bn);
  grid[1] = plan.ctas;
  grid[2] = plan.chunks;
  return 0;
}

// fmt: 0 = q8_0, 1 = q4_0. x (M, K) bf16; w int8 (K, N) / (K/2, N); scales
// (K/group, N) bf16; out (M, N) bf16 or f32 (out_f32), its rows ldc >= N
// elements apart (with N % 16 == 0, whose stores are 4 columns wide, ldc a
// multiple of 4 and out 16-byte aligned); partial: f32 scratch of
// partial_elems >= quant_matmul_workspace(M, K, N, group). Returns the
// first failing launch's cudaError_t (0 on success).
extern "C" int quant_matmul(int fmt, const void* x, const void* w,
                            const void* scales, void* out, void* partial,
                            int partial_elems, int out_f32, int M, int K, int N,
                            int ldc, int group, void* stream) {
  if (!takes_group(K, group) || ldc < N ||
      (N % 16 == 0 && (ldc % 4 || reinterpret_cast<uintptr_t>(out) % 16)))
    return cudaErrorInvalidValue;
  const Plan plan = split_plan(M, K, N, group);
  if (plan.ctas > 1 && partial_elems < plan.ctas * M * N) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  // 16-byte payload and scale copies need N % 16 == 0 (rows stay aligned)
  const bool vec = N % 16 == 0;
  if (fmt == kQ8) {
    return vec ? dispatch_m<kQ8, true>(x, w, scales, out, part, out_f32, M, K, N, ldc, group, plan,
                                       st)
               : dispatch_m<kQ8, false>(x, w, scales, out, part, out_f32, M, K, N, ldc, group,
                                        plan, st);
  }
  if (fmt == kQ4) {
    return vec ? dispatch_m<kQ4, true>(x, w, scales, out, part, out_f32, M, K, N, ldc, group, plan,
                                       st)
               : dispatch_m<kQ4, false>(x, w, scales, out, part, out_f32, M, K, N, ldc, group,
                                        plan, st);
  }
  return cudaErrorInvalidValue;
}

// h (M, F) bf16 = swiglu(x (M, K) bf16 @ dequant(w)) (act 1; act 2: the
// GeGLU) with w the fused gate-up weight (K, 2F) / (K/2, 2F), scales
// (K/group, 2F) bf16; partial: f32 scratch of partial_elems >=
// quant_matmul_workspace(M, K, 2F, group). Returns the first failing
// launch's cudaError_t (0 on success).
extern "C" int quant_matmul_swiglu(int act, int fmt, const void* x, const void* w,
                                   const void* scales, void* h, void* partial,
                                   int partial_elems, int M, int K, int F, int group,
                                   void* stream) {
  if (!takes_group(K, group) || F < 1 || (act != kSilu && act != kGelu))
    return cudaErrorInvalidValue;
  const int N = 2 * F;
  const Plan plan = split_plan(M, K, N, group);
  if (plan.ctas > 1 && partial_elems < plan.ctas * M * N) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  bf16* out = static_cast<bf16*>(h);
  // as for quant_matmul, and the cluster route's up blocks start at
  // column F: TMA faults on a box whose first column is not 16-byte
  // aligned, so they need F % 16 == 0
  const bool vec = plan.ctas > 1 ? N % 16 == 0 : F % 16 == 0;
  if (fmt == kQ8) {
    return vec ? dispatch_swiglu<kQ8, true>(act, x, w, scales, out, part, M, K, F, group, plan, st)
               : dispatch_swiglu<kQ8, false>(act, x, w, scales, out, part, M, K, F, group, plan,
                                             st);
  }
  if (fmt == kQ4) {
    return vec ? dispatch_swiglu<kQ4, true>(act, x, w, scales, out, part, M, K, F, group, plan, st)
               : dispatch_swiglu<kQ4, false>(act, x, w, scales, out, part, M, K, F, group, plan,
                                             st);
  }
  return cudaErrorInvalidValue;
}
