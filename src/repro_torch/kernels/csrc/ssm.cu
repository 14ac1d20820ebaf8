// The SSM family's kernels (Mamba-2 SSD), for sm_90a: the short causal
// conv with its state, the conv and SSD state update of one decode token
// in one launch, the chunked SSD scan of a prefill, and the gated RMSNorm.
//
// No Pallas kernel of the JAX package stands behind these: it computes the
// SSD layer with jnp outside any kernel,
//   src/repro/models/ssm.py:43    _causal_conv (conv, bias, silu, state)
//   src/repro/models/ssm.py:150   ssm_decode (the O(1) state update)
//   src/repro/models/ssm.py:68    ssd_chunked (the prefill's scan)
//   src/repro/models/ssm.py:143   rmsnorm(y * silu(z)), and :173
// and XLA fuses what it can inside the jitted megastep and prefill.
// Eagerly, one decode step of the layer is about ten PyTorch launches, each
// reading or writing the layer's f32 state (10.5 MB at 4 slots of
// mamba2-2.7b); the scan builds (B, Q, Q, H) f32 tensors a chunk.
//
// Bounds and designs.
// - ssm_conv (the prefill's conv): bytes, 11 MB at 1 x 512 of mamba2's
//   5376 channels, but its silu's f32 arithmetic (an exp and an IEEE
//   division a value, 2.75 M values there) keeps the card's CUDA cores
//   about as long. A thread takes a 16-byte run of 8 channels and
//   kConvPos positions: every load of its stretch (kConvPos + 3 rows of
//   16 bytes, from device memory or the state) is issued before any
//   arithmetic, the products and partial sums run on bf16 pairs (mul.rn
//   / add.rn.bf16x2, rounded where the plain version rounds), and the
//   stores are 16 bytes; y and the state are bit-equal to the plain
//   version's. Launch bounds hold it to 80 registers a thread, so 6 CTAs
//   of 128 threads fit an SM. Tried and not kept (PERF.md): stretches of 8
//   and 16 positions, CTAs of 64 threads, no register bound (84 a
//   thread), and silu by the fast exp and division with the exact
//   expression only where their bf16 rounding could differ (bit-equal,
//   but the check cost what it saved).
// - gated_rmsnorm: bytes, and at decode (4 rows of 5120) a chain of
//   dependent latencies: the loads, the gates, the reduction, the
//   scaling. A thread takes one 16-byte run (one CTA of 640 threads a row
//   at mamba2's d 5120) where the former CTA of 256 gated up to 24 values
//   a thread serially; w is loaded with y and z, before the reduction;
//   the sum is two xor trees (a warp's runs, then the warps' sums), its
//   order from kernels/ssm.py::norm_plan(d) alone. A row spread over a
//   cluster of 4 or 7 CTAs (partial sums through distributed shared
//   memory) was about as fast at decode and slower at prefill, and a
//   launch under programmatic dependent launch did not make the decode
//   step faster; neither was kept (PERF.md). Folding the decode's gated
//   norm into the decode update's launch (the CTA that takes a slot's
//   last ticket normalizes the row) was bit-equal and slower on the card
//   (PERF.md).
// - ssm_decode_step (the decode's conv and SSD update in one launch):
//   bytes. The state (B, H, P, N) f32 is read once and written once, in
//   place; at 1 slot (2.6 MB) the launch, the dependent chain dt -> decay
//   -> state and the tail take most of the time. A CTA takes a head: 8
//   warps of 8 p rows (80 CTAs a slot at mamba2's 80 heads of P 64), a
//   lane the same four n of each row, so the lane loads its B and C once;
//   all its float4 state loads are issued first, and one thread of the
//   CTA computes the head's dt, decay and D meanwhile. Every CTA computes
//   the conv of B and C (256 channels at N 128) and of its own x channels
//   into shared memory; the slot's last CTA by a ticket writes B and C's
//   conv state. What holds it back (PERF.md): ptxas gives it 111
//   registers a thread, so 2 CTAs of 256 threads fit an SM: 264 run at
//   once, and 4 slots (320 CTAs) take a second wave; 1 slot is 80 CTAs
//   on 132 SMs. A conv launch and an update launch back to back (the
//   update 4 rows a warp, 4 warps a CTA, 320 CTAs a slot) were slower
//   at 1 and at 4 slots and were taken out. 4 x 4 and 8 x 4 rows x warps
//   (more CTAs, each repeating the B and C conv, and more tickets a slot)
//   are timed beside 8 x 8 by tools/ssm_step_tiles.py (PERF.md); register
//   bounds spilled.
// - ssd_prefill: two launches a slice of at most `slice` chunks (the
//   caller's, kernels/ssm.py's SCAN_SLICE), the slices in order, so its
//   f32 scratch of incoming states holds one slice's chunks, not the
//   prompt's; a slice's walk starts from the state the last one wrote,
//   which holds the walk's accumulator exactly, so the slices change no
//   bit of y or of the state. Chunks of kQ = 64 positions, the last
//   one masked (dt 0, x, B and C 0 past the prompt, which leave the state
//   alone), so an exact-length prefill of any length scans whole chunks; L
//   is a chunk's own running sum of dt * A (a warp scan), and exp(L_q -
//   L_k) is taken only for k <= q (the segment-sum form: no quotient of
//   two exponentials, which could underflow to 0/0).
//   1. ssd_prefill_state_kernel, a CTA a (sequence, head, 64 columns of
//      the state), the state passing: it walks the chunks in order with
//      its (P x 64) f32 state in the wgmma accumulator, writes each
//      chunk's incoming state s_in to scratch, then acc = acc exp(L_last)
//      and acc += sum_k exp(L_last - L_k) dt_k x_k B_k^T, the chunk state
//      accumulated onto the decayed state by the tensor cores; the final
//      state goes into the state. Chunk tiles come through a ring of
//      kWalkStages stages.
//   2. ssd_prefill_out_kernel, a CTA a (chunk, 2 heads, sequence), chunk-
//      parallel: C B^T once for its heads, then per head y = exp(L_q) C
//      s_in^T + M x with M = exp(L_q - L_k) C_q.B_k dt_k (k <= q), rounded,
//      plus the D skip.
//   Every product is a wgmma m64n64k16 (the chunk is wgmma's 64 rows; P =
//   64): C B^T (k N) and C s^T (k N) with C and B or s K-major in shared
//   memory; M x (k 64) and the chunk state (x w)^T B (k 64) with M or
//   (x w)^T in registers and x or B N-major (the descriptor's transpose
//   bit). x, B and C are bf16, so their products are exact in f32; M, s
//   and x w are f32, each split into three bf16 parts (hi, mid, lo: 24
//   significant bits, the f32 value exactly), three products where one
//   would do, so each product is as exact as an f32 fma; the sums are the
//   tensor cores' f32 accumulation. Tiles come by cp.async from the
//   strided rows into the 128-byte swizzle (zero past S and N), then a
//   proxy fence for wgmma; f32 outputs are staged in shared memory and
//   stored whole rows at a time (fragment stores, 32 bytes a row, were
//   slower).
//   Bound: bytes at mamba2's shapes (the counted operations at 989
//   TFLOP/s take a third of the bytes' time); the incoming states pass
//   through device memory twice, which the bound does not count. What
//   holds it back (PERF.md): each step is a few thousand dependent
//   instructions of one warpgroup (the split, the decay, the staging), and
//   at B 1 the walk has 160 chains of ceil(S / 64) steps for 132 SMs; the
//   output kernel runs two CTAs an SM (255 registers, 101 KB). Tried and
//   no faster: the chunk states chunk-parallel with a separate passing
//   kernel (its states read and written once more), four or one heads a
//   CTA, prefetching the next head's state by cp.async at one CTA an SM,
//   building the next chunk's operand during the products, and C s^T in
//   two passes over N.
//   A sequence's CTAs read only its rows: its y and final state do not
//   depend on B or the other sequences, bit for bit.
//
// Numerics follow the plain PyTorch versions in kernels/ssm.py op for op
// (the _rn intrinsics keep nvcc from contracting products and sums into
// FMAs where the plain version rounds between them): the conv rounds each
// product and each partial sum to bf16 as the JAX sum of bf16 products
// does, then the bias add, then silu in f32; dt = softplus(dt + dt_bias)
// = max(v, 0) + log1p(exp(-|v|)) and A = -exp(A_log) in f32; the decode
// update and the scan keep the state in f32 and round y once (the decode
// adds the D skip in f32 first; the prefill rounds y, then adds the bf16
// product x * D in bf16, as ssm.py:118 and :141 do); the gated norm
// rounds silu(z) and y * silu(z) to bf16, then normalizes in f32 with one
// rounding. The scan's and the decode's sums over N and over the chunk
// run in another order than the plain version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConvThreads = 128;  // conv: 16-byte runs a CTA
constexpr int kConvPos = 4;        // conv: positions a thread (its stretch)
constexpr int kConvMinCtas = 6;    // conv: CTAs an SM (80 registers a thread, no spill)
constexpr int kWidth = 4;          // the conv's width (every config's)
constexpr int kHalo = kWidth - 1;  // the inputs before a position that its output reads
constexpr int kStepRows = 8;       // ssm_decode_step: p rows a warp
constexpr int kStepWarps = 8;      // ssm_decode_step: warps a CTA
constexpr int kStepTile = kStepRows * kStepWarps;  // ssm_decode_step: p rows a CTA
constexpr int kDecN = 128;         // decode: the widest N (a float4 a lane)
constexpr int kNormMaxThreads = 1024;  // gated norm: a CTA a row, a thread a 16-byte run
constexpr int kQ = 64;             // the prefill scan's chunk (wgmma's M)
constexpr int kHP = 64;            // the scan's head dim P (a 128-byte row)
constexpr int kNS = 128;           // the state width the scan's tiles hold
constexpr int kOutHeads = 2;       // heads a CTA of ssd_prefill_out_kernel (share C B^T)
constexpr int kScanThreads = 128;  // one warpgroup
constexpr int kBox = 64 * 128;     // a swizzled box: 64 rows of 128 bytes

__device__ __forceinline__ float f(bf16 v) { return __bfloat162float(v); }
// v rounded to bf16, as a bf16 op's result is
__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16(v)); }
// PyTorch's silu: x / (1 + exp(-x)) in f32
__device__ __forceinline__ float silu(float v) { return __fdiv_rn(v, __fadd_rn(1.f, expf(-v))); }
__device__ __forceinline__ float softplus(float v) {
  return __fadd_rn(fmaxf(v, 0.f), log1pf(expf(-fabsf(v))));
}

__device__ __forceinline__ uint4 ld16(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void st16(bf16* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }
// the low and high bf16 of a pair, as f32
__device__ __forceinline__ float lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack2(float l, float h) {
  __nv_bfloat162 v = __floats2bfloat162_rn(l, h);
  return *reinterpret_cast<uint32_t*>(&v);
}
// A product and a sum of bf16 pairs, each rounded once to bf16. The f32
// product of two bf16 values is exact, and rounding an f32 sum to bf16
// gives the sum rounded once (24 >= 2 * 8 + 2 bits), so these are the
// plain version's f32 op then bf16 rounding, bit for bit; .rn keeps the
// compiler from contracting them into an fma.
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// ------------------------------------------------------------ causal conv --
static_assert(kWidth == 4, "conv_run takes a window of four inputs");

// A 16-byte run's output (8 channels) at one position from its window
// a0..a3 (oldest first): each product and partial sum rounded to bf16 on
// bf16 pairs, the bias added, then silu in f32, rounded once.
__device__ __forceinline__ uint4 conv_run(const uint4& a0, const uint4& a1, const uint4& a2,
                                          const uint4& a3, const uint4 (&w)[kWidth],
                                          const uint4& bias) {
  const uint32_t x0[4] = {a0.x, a0.y, a0.z, a0.w}, x1[4] = {a1.x, a1.y, a1.z, a1.w};
  const uint32_t x2[4] = {a2.x, a2.y, a2.z, a2.w}, x3[4] = {a3.x, a3.y, a3.z, a3.w};
  const uint32_t w0[4] = {w[0].x, w[0].y, w[0].z, w[0].w}, w1[4] = {w[1].x, w[1].y, w[1].z, w[1].w};
  const uint32_t w2[4] = {w[2].x, w[2].y, w[2].z, w[2].w}, w3[4] = {w[3].x, w[3].y, w[3].z, w[3].w};
  const uint32_t bb[4] = {bias.x, bias.y, bias.z, bias.w};
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t acc = mul2(x0[i], w0[i]);
    acc = add2(acc, mul2(x1[i], w1[i]));
    acc = add2(acc, mul2(x2[i], w2[i]));
    acc = add2(acc, mul2(x3[i], w3[i]));
    acc = add2(acc, bb[i]);
    out[i] = pack2(silu(lo(acc)), silu(hi(acc)));
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// A thread a (row b, 16-byte run of 8 channels, stretch of kConvPos
// positions); consecutive threads take consecutive runs, so a warp loads
// and stores 512 contiguous bytes a position. Every load is issued first:
// the stretch's window (its positions and the kHalo before them; position
// s < 0 is state row kHalo + s, zero without carry), the weights and the
// bias. Then the outputs position by position, stored 16 bytes at a time.
// Only stretch 0 reads the old state; its own thread then loads the new
// state (the last kHalo positions of state ++ x) and writes it.
__global__ void __launch_bounds__(kConvThreads, kConvMinCtas)
    ssm_conv_kernel(const bf16* __restrict__ x, long long x_sb, long long x_ss,
                    const bf16* __restrict__ w, const bf16* __restrict__ bias, bf16* state,
                    const unsigned char* __restrict__ advance, bf16* __restrict__ y, int B, int S,
                    int C, int carry) {
  const int runs = C / 8, stretches = (S + kConvPos - 1) / kConvPos;
  const int t = blockIdx.x * kConvThreads + threadIdx.x;  // < 2^31 (the caller's check)
  if (t >= B * stretches * runs) return;
  const int c = t % runs * 8, rest = t / runs;
  const int s0 = rest % stretches * kConvPos, b = rest / stretches;
  const bf16* xr = x + b * x_sb + c;
  bf16* st = state + (size_t)b * kHalo * C + c;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  auto input = [&](int pos) -> uint4 {  // position pos < S of state ++ x
    if (pos >= 0) return ldg16(xr + pos * x_ss);
    return carry ? ld16(st + (size_t)(kHalo + pos) * C) : zero;
  };
  uint4 win[kHalo + kConvPos], wt[kWidth];
#pragma unroll
  for (int j = 0; j < kHalo + kConvPos; ++j)
    win[j] = s0 - kHalo + j < S ? input(s0 - kHalo + j) : zero;
#pragma unroll
  for (int j = 0; j < kWidth; ++j) wt[j] = ldg16(w + (size_t)j * C + c);
  const uint4 bc = ldg16(bias + c);
  bf16* yr = y + ((size_t)b * S + s0) * C + c;
#pragma unroll
  for (int i = 0; i < kConvPos; ++i) {
    if (s0 + i >= S) break;
    st16(yr + i * C, conv_run(win[i], win[i + 1], win[i + 2], win[i + 3], wt, bc));
  }
  if (s0 != 0 || (advance != nullptr && !advance[b])) return;
  uint4 next[kHalo];  // loaded here, not with the window: fewer registers
#pragma unroll
  for (int j = 0; j < kHalo; ++j) next[j] = input(S - kHalo + j);
#pragma unroll
  for (int j = 0; j < kHalo; ++j) st16(st + (size_t)j * C, next[j]);
}

// ---------------------------------------------------- decode state update --
// dt = softplus(dt + dt_bias), the decay exp(dt A) with A = -exp(A_log),
// and D, of head h of row b, into head[0..2].
__device__ __forceinline__ void head_scalars(const bf16* __restrict__ dt, long long dt_sb,
                                             const bf16* __restrict__ dt_bias,
                                             const bf16* __restrict__ A_log,
                                             const bf16* __restrict__ D, int b, int h,
                                             float* head) {
  const float dtv = softplus(__fadd_rn(f(dt[b * dt_sb + h]), f(dt_bias[h])));
  head[0] = dtv;
  head[1] = expf(__fmul_rn(dtv, -expf(f(A_log[h]))));
  head[2] = f(D[h]);
}

// A warp's R rows once their inputs are in registers: s, the lane's
// float4 of each row (n = 4 lane ..); bn and cn, its four B and C values;
// xw, the rows' x values, two to a word. S <- S decay + (dt x) B_n,
// written back to sp where `write`; y = sum_n S C_n + x D, rounded once,
// stored by lane 0 8 bytes at a time. The sum over n: a lane's four in
// order, then the warp's xor tree over lanes (zeros past N): fixed by N
// alone.
template <int R>
__device__ __forceinline__ void decode_rows(float4 (&s)[R], uint2 bn, uint2 cn,
                                            const uint32_t (&xw)[R / 2], const float* head,
                                            float* sp, int N, bool lane_on, bool write, bf16* yp,
                                            int lane) {
  static_assert(R % 4 == 0, "decode_rows stores y four rows at a time");
  const float dtv = head[0], decay = head[1], Dh = head[2];
  const float bv[4] = {lo(bn.x), hi(bn.x), lo(bn.y), hi(bn.y)};
  const float cv[4] = {lo(cn.x), hi(cn.x), lo(cn.y), hi(cn.y)};
  float xv[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    xv[r] = r % 2 ? hi(xw[r / 2]) : lo(xw[r / 2]);
    const float dx = __fmul_rn(dtv, xv[r]);
    float v[4] = {s[r].x, s[r].y, s[r].z, s[r].w};
    acc[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = __fadd_rn(__fmul_rn(v[j], decay), __fmul_rn(dx, bv[j]));
      acc[r] = fmaf(v[j], cv[j], acc[r]);
    }
    if (write && lane_on)
      *reinterpret_cast<float4*>(sp + (size_t)r * N) = make_float4(v[0], v[1], v[2], v[3]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; r += 4) {
      float out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k] = __fadd_rn(acc[r + k], __fmul_rn(xv[r + k], Dh));
      *reinterpret_cast<uint2*>(yp + r) = make_uint2(pack2(out[0], out[1]), pack2(out[2], out[3]));
    }
  }
}

// One decode token's conv and SSD update. grid (P / kStepTile, H, B): a
// CTA of kStepWarps warps takes kStepTile p rows of one (slot b, head h),
// a warp kStepRows of them; lane l holds n = 4 l .. 4 l + 3 of each (N <=
// kDecN), so it takes its B and C once for all its rows. Every lane
// issues its float4 state loads before anything waits; meanwhile the
// CTA's last thread computes the head's dt, decay and D once, into shared
// memory.
//
// xbc is the conv's input. The CTA's first N / 4 + kStepTile / 8 threads
// each take a 16-byte run of the channels the CTA reads (B and C, which
// every CTA of the slot computes alike, then its rows' x) and compute its
// conv output from the old conv state, the token and the weights (their
// loads issued before the state's), into shared memory. A CTA owns its x
// channels and replaces their conv state itself. Every CTA of the slot
// reads the B and C conv state, so the slot's last CTA by its ticket (an
// int32 a slot, which atomicInc wraps back to 0) replaces it, from the
// values its own threads hold; no CTA waits: the ticket is taken before
// the update and read after it.
__global__ void __launch_bounds__(kStepWarps * 32)
    ssm_decode_step_kernel(const bf16* __restrict__ xbc, long long xbc_sb,
                           const bf16* __restrict__ dt, long long dt_sb,
                           const bf16* __restrict__ conv_w, const bf16* __restrict__ conv_b,
                           bf16* conv_state, const bf16* __restrict__ dt_bias,
                           const bf16* __restrict__ A_log, const bf16* __restrict__ D,
                           float* state, const unsigned char* __restrict__ advance,
                           bf16* __restrict__ y, unsigned* tickets, int H, int P, int N) {
  constexpr int R = kStepRows;
  __shared__ float head[3];
  __shared__ __align__(16) bf16 conv_out[2 * kDecN + kStepTile];  // B, C, the CTA's x
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, n = lane * 4;
  const int h = blockIdx.y, b = blockIdx.z, di = H * P, C = di + 2 * N;
  const int pc = blockIdx.x * kStepTile, p0 = pc + warp * R;
  // p0 < P holds at this grid; without the test ptxas gives the kernel 122
  // registers a thread in place of 111, and it runs slower on the H100
  const bool rows_on = p0 < P, lane_on = rows_on && n < N;
  const bool write = advance == nullptr || advance[b];
  const bf16* row = xbc + b * xbc_sb;
  float* sp = state + (((size_t)b * H + h) * P + p0) * N + n;
  uint2 bn = make_uint2(0, 0), cn = bn;
  uint32_t xw[R / 2];
  const bf16* xsrc = conv_out + 2 * N + warp * R;
  // the conv's run j < N / 4 is channels di + 8 j of B and C; then the
  // CTA's x runs
  const int bc_runs = N / 4, at = tid < bc_runs ? 8 * tid : 2 * N + 8 * (tid - bc_runs);
  const bool conv_on = tid < bc_runs + kStepTile / 8;
  const int c = tid < bc_runs ? di + at : h * P + pc + 8 * (tid - bc_runs);
  bf16* cs = conv_state + (size_t)b * kHalo * C + c;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 win[kWidth] = {zero, zero, zero, zero}, wt[kWidth] = {zero, zero, zero, zero}, bc = zero;
  if (conv_on) {
#pragma unroll
    for (int j = 0; j < kHalo; ++j) win[j] = ld16(cs + (size_t)j * C);
    win[kHalo] = ldg16(row + c);
#pragma unroll
    for (int j = 0; j < kWidth; ++j) wt[j] = ldg16(conv_w + (size_t)j * C + c);
    bc = ldg16(conv_b + c);
  }
  float4 s[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    s[r] = lane_on ? *reinterpret_cast<const float4*>(sp + (size_t)r * N)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid == kStepWarps * 32 - 1) head_scalars(dt, dt_sb, dt_bias, A_log, D, b, h, head);
  if (conv_on) {
    st16(conv_out + at, conv_run(win[0], win[1], win[2], win[3], wt, bc));
    if (write && tid >= bc_runs) {
#pragma unroll
      for (int j = 0; j < kHalo; ++j) st16(cs + (size_t)j * C, win[j + 1]);
    }
  }
  __syncthreads();  // every B and C conv state value this CTA reads is read
  unsigned t = 0;
  if (write && tid == 0) {
    __threadfence();
    t = atomicInc(tickets + b, gridDim.x * gridDim.y - 1);
  }
  if (lane_on) {
    bn = *reinterpret_cast<const uint2*>(conv_out + n);
    cn = *reinterpret_cast<const uint2*>(conv_out + N + n);
  }
#pragma unroll
  for (int r = 0; r < R; r += 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(xsrc + r);
    xw[r / 2] = v.x;
    xw[r / 2 + 1] = v.y;
  }
  if (rows_on)
    decode_rows(s, bn, cn, xw, head, sp, N, lane_on, write, y + (size_t)b * di + h * P + p0,
                lane);
  // the slot's last CTA (its ticket is the slot's CTA count less one)
  if (write && warp == 0 && __shfl_sync(0xffffffffu, t, 0) == gridDim.x * gridDim.y - 1 &&
      tid < bc_runs) {
    __threadfence();
#pragma unroll
    for (int j = 0; j < kHalo; ++j) st16(cs + (size_t)j * C, win[j + 1]);
  }
}

// ---------------------------------------------------------- gated RMSNorm --
// A CTA row blockIdx.x, of `per` run-warps (32 consecutive 8-element runs,
// a warp a run-warp, a thread a run), the order of kernels/ssm.py::
// norm_plan(d). g = bf16(y * bf16(silu(z))), out = bf16(g * rsqrt(mean(
// g^2) + eps) * w), w loaded with y and z, g kept as bf16 pairs (exact: it
// is rounded to bf16) until the scaling. The sum of squares: a run's 8 in
// order, each run-warp's xor tree, then the CTA's run-warp sums (zeros past
// per, 32 in all) by another xor tree that every warp takes alike.
__global__ void __launch_bounds__(kNormMaxThreads)
    gated_rmsnorm_kernel(const bf16* __restrict__ y, const bf16* __restrict__ z, long long z_rs,
                         const bf16* __restrict__ w, bf16* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[32];
  const int tid = threadIdx.x, lane = tid & 31, per = blockDim.x >> 5;
  const size_t row = blockIdx.x;
  const int at = tid * 8;
  uint4 uw = make_uint4(0, 0, 0, 0), uz = uw, uy = uw;
  if (at < d) {
    uw = *reinterpret_cast<const uint4*>(w + at);
    uz = *reinterpret_cast<const uint4*>(z + row * z_rs + at);
    uy = *reinterpret_cast<const uint4*>(y + row * d + at);
  }
  const bf16* hy = reinterpret_cast<const bf16*>(&uy);
  const bf16* hz = reinterpret_cast<const bf16*>(&uz);
  __nv_bfloat162 g[4];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    const float g0 = rb(__fmul_rn(f(hy[j]), rb(silu(f(hz[j])))));
    const float g1 = rb(__fmul_rn(f(hy[j + 1]), rb(silu(f(hz[j + 1])))));
    ss = __fadd_rn(ss, __fmul_rn(g0, g0));
    ss = __fadd_rn(ss, __fmul_rn(g1, g1));
    g[j / 2] = __floats2bfloat162_rn(g0, g1);
  }
  if (at >= d) ss = 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  if (lane == 0) warp_sums[tid >> 5] = ss;
  __syncthreads();
  float sum = lane < per ? warp_sums[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(sum, (float)d), eps));
  if (at >= d) return;
  const bf16* hw = reinterpret_cast<const bf16*>(&uw);
  uint4 uo;
  bf16* ho = reinterpret_cast<bf16*>(&uo);
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    ho[j] = __float2bfloat16(__fmul_rn(__fmul_rn(__low2float(g[j / 2]), r), f(hw[j])));
    ho[j + 1] = __float2bfloat16(__fmul_rn(__fmul_rn(__high2float(g[j / 2]), r), f(hw[j + 1])));
  }
  *reinterpret_cast<uint4*>(out + row * d + at) = uo;
}

// ------------------------------------------------- chunk-parallel SSD scan --
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// 16 bytes global -> shared; src_bytes 0 fills them with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of bf16 element (r, c) of a tile of 64 rows held in boxes of
// 64 columns (128-byte rows), with the 128-byte swizzle: the 16-byte chunk
// j of row r at chunk j ^ (r % 8). Boxes are 1024-byte aligned.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * kBox + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// Rows [0, 64) x columns [0, W) of a bf16 tile, row r at src + r * ld, by
// cp.async into the swizzled layout; rows >= nrows and columns >= ncols (a
// multiple of 8) are zero.
template <int W>
__device__ __forceinline__ void load_tile(uint8_t* tile, const bf16* src, long long ld, int nrows,
                                          int ncols) {
  constexpr int kRowChunks = W / 8;
  for (int i = threadIdx.x; i < 64 * kRowChunks; i += kScanThreads) {
    const int r = i / kRowChunks, c = (i % kRowChunks) * 8;
    const bool ok = r < nrows && c < ncols;
    cp_async16(tile + swz(r, c), ok ? src + r * ld + c : src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ float tile_at(const uint8_t* tile, int r, int c) {
  return f(*reinterpret_cast<const bf16*>(tile + swz(r, c)));
}

// v = hi + mid + lo, each a bf16 value (8 significant bits): exact for a
// normal f32 v (v - hi and its rest are exact by Sterbenz's lemma)
__device__ __forceinline__ void split3(float v, float part[3]) {
  part[0] = rb(v);
  const float r = __fsub_rn(v, part[0]);
  part[1] = rb(r);
  part[2] = rb(__fsub_rn(r, part[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo = low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// A warp's chunk of one head: dt_q = softplus(dt + bias) (0 at q >= qn),
// L_q = the running sum of dt_q A, w_q = exp(L_last - L_q) dt_q (the state
// weights), for q = lane and lane + 32, by a warp scan (the same order in
// every kernel). raw holds this lane's two dt values (dt_raw, from dt at
// the chunk's first position).
__device__ __forceinline__ void dt_raw(const bf16* __restrict__ dt, long long dt_ss, int qn,
                                       float raw[2]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) raw[i] = lane + 32 * i < qn ? f(dt[(lane + 32 * i) * dt_ss]) : 0.f;
}
__device__ __forceinline__ void decay_of(const float raw[2], int qn, float bias, float A,
                                         float* dts, float* L, float* wv) {
  const int lane = threadIdx.x % 32;
  float d[2], v[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    d[i] = lane + 32 * i < qn ? softplus(__fadd_rn(raw[i], bias)) : 0.f;
    v[i] = __fmul_rn(d[i], A);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v[i], o);
      if (lane >= o) v[i] = __fadd_rn(v[i], t);
    }
  }
  v[1] = __fadd_rn(__shfl_sync(0xffffffffu, v[0], 31), v[1]);
  const float last = __shfl_sync(0xffffffffu, v[1], 31);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dts[lane + 32 * i] = d[i];
    L[lane + 32 * i] = v[i];
    if (wv != nullptr) wv[lane + 32 * i] = __fmul_rn(expf(__fsub_rn(last, v[i])), d[i]);
  }
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (16-byte units), the 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}
// k16 step kk of a K-major B operand: rows (n) of a tile whose columns (k)
// are in 64-column boxes
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile, int kk) {
  return make_desc(tile + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
}
// k16 step kk of an N-major B operand: rows k of one 64-column box (n)
__device__ __forceinline__ uint64_t desc_nmajor(const uint8_t* box, int kk) {
  return make_desc(box + kk * 16 * 128, kBox, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// d (m64 x n64 f32, registers) (+)= a (m64 x k16 bf16, registers) * b (k16
// x n64 bf16, shared memory by descriptor; TRANS_B 0: K-major, 1:
// N-major); scale_d 0 starts d from zero. Fragments as in the PTX ISA:
// warp w of the warpgroup holds rows 16w..16w+15; with gid = lane / 4,
// tig = lane % 4, a = {(gid, 2tig), (gid + 8, 2tig), (gid, 2tig + 8),
// (gid + 8, 2tig + 8)} (two consecutive k each) and d[4j + e] = (gid + 8 *
// (e >> 1), 8j + 2tig + (e & 1)).
template <int TRANS_B>
__device__ __forceinline__ void wgmma64(float* d, const uint32_t a[4], uint64_t desc,
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

// The same with a from shared memory too, K-major, by descriptor.
__device__ __forceinline__ void wgmma64ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Shared memory of the two chunk kernels (bytes past the 1024-byte
// alignment): the swizzled tiles, then dt, L and the state weights.
// Outputs are staged a warp's 16 rows at a time and stored whole rows
// at a time (fragment stores scatter 32 bytes a row).
constexpr int kSoPitch = 64 + 8;    // a staged f32 state row (floats)
constexpr int kYPitch = kHP + 8;    // a staged bf16 y row (elements)
constexpr int kWalkStages = 4;      // the state walk's ring of chunk tiles
constexpr int kStateSmem = kWalkStages * 2 * kBox + 64 * kSoPitch * 4 + 2 * 3 * kQ * 4 + 1024;
constexpr int kOutSmem =
    (2 + 2 + 1 + 6) * kBox + 64 * kYPitch * 2 + 2 * kOutHeads * kQ * 4 + 1024;

// 1. grid (ceil(N / 64), H, B): one (sequence, head, 64 columns of the
// state) walks the chunks in order with its (P x 64) state in the wgmma
// accumulator: it writes s_in (the state before the chunk) into states
// (B, chunks, H, P, N), then acc = acc exp(L_last) and acc += (x w)^T B
// over the chunk's 64 positions, (x w)^T split into three bf16 parts as
// the register A operand (rows p), B N-major from the tile; the final
// state goes into state. The next chunk's tiles load (cp.async, two
// stages) and its decay is taken while this one's products run.
__global__ void __launch_bounds__(kScanThreads)
    ssd_prefill_state_kernel(const bf16* __restrict__ xbc, long long x_sb, long long x_ss,
                             const bf16* __restrict__ dt, long long dt_sb, long long dt_ss,
                             const bf16* __restrict__ dt_bias, const bf16* __restrict__ A_log,
                             float* state, float* __restrict__ states, int S, int H, int N,
                             int carry) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = align1024(smem_raw);                // per stage: B (rows q, cols n), x
  float* so = reinterpret_cast<float*>(tiles + kWalkStages * 2 * kBox);  // staging, 16 rows a warp
  float* dec = so + 64 * kSoPitch;                    // per stage: dt, L, w
  const int n0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int ncols = min(64, N - n0), nc = (S + kQ - 1) / kQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const float bias = f(dt_bias[h]), A = -expf(f(A_log[h]));
  const bf16* xrow = xbc + b * x_sb;
  const bf16* dtrow = dt + b * dt_sb + h;
  auto load = [&](int c) {                            // chunk c's tiles into its stage
    uint8_t* st = tiles + (c % kWalkStages) * 2 * kBox;
    const bf16* rows = xrow + c * kQ * x_ss;
    load_tile<64>(st, rows + H * kHP + n0, x_ss, min(kQ, S - c * kQ), ncols);
    load_tile<kHP>(st + kBox, rows + h * kHP, x_ss, min(kQ, S - c * kQ), kHP);
  };
  auto qn_of = [&](int c) { return min(kQ, S - c * kQ); };
  float raw[2] = {0.f, 0.f};                          // warp 0: the next chunk's dt
  auto decay = [&](int c) {                           // chunk c's dt, L, w (warp 0)
    float* d = dec + (c & 1) * 3 * kQ;
    decay_of(raw, qn_of(c), bias, A, d, d + kQ, d + 2 * kQ);
  };
  // stage acc (the state, rows p, this CTA's 64 columns) and store it at
  // dst (rows of N floats), whole rows at a time
  auto store_state = [&](const float* acc, float* dst) {
    float* stage = so + warp * 16 * kSoPitch;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(stage + (gid + 8 * rr) * kSoPitch + 8 * j + 2 * tig) =
            make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
    __syncwarp();
    const int row4 = ncols / 4;
    for (int e = lane; e < 16 * row4; e += 32)
      *reinterpret_cast<float4*>(dst + (warp * 16 + e / row4) * N + (e % row4) * 4) =
          *reinterpret_cast<const float4*>(stage + (e / row4) * kSoPitch + (e % row4) * 4);
    __syncwarp();
  };

  float acc[32];                                      // the state: rows p, columns n0 + 8j + ...
  float* gstate = state + ((size_t)b * H + h) * kHP * N + n0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int p = warp * 16 + gid + 8 * rr, n = 8 * j + 2 * tig;
      const float2 v = carry && n < ncols ? *reinterpret_cast<const float2*>(gstate + p * N + n)
                                          : make_float2(0.f, 0.f);
      acc[4 * j + 2 * rr] = v.x;
      acc[4 * j + 2 * rr + 1] = v.y;
    }
  // the ring: chunks c + 1 .. c + kWalkStages - 1 load while chunk c runs
  // (one commit group a chunk, empty past the last)
#pragma unroll
  for (int i = 0; i < kWalkStages - 1; ++i) {
    if (i < nc) load(i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  if (warp == 0) {
    dt_raw(dtrow, dt_ss, qn_of(0), raw);
    decay(0);
    if (nc > 1) dt_raw(dtrow + kQ * dt_ss, dt_ss, qn_of(1), raw);
  }
  // chunk c: its tiles and its decay (taken during chunk c - 1's products)
  // are ready after the barrier
  for (int c = 0; c < nc; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kWalkStages - 2) : "memory");
    fence_proxy_async();
    __syncthreads();
    if (c + kWalkStages - 1 < nc) load(c + kWalkStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint8_t* Bt = tiles + (c % kWalkStages) * 2 * kBox;
    const uint8_t* xt = Bt + kBox;
    const float* L = dec + (c & 1) * 3 * kQ + kQ;
    const float* w = L + kQ;
    store_state(acc, states + ((((size_t)b * nc + c) * H + h) * kHP) * N + n0);
    const float gamma = expf(L[kQ - 1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = __fmul_rn(acc[i], gamma);
    uint32_t a[3][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = warp * 16 + gid + 8 * (r & 1), q = 16 * kk + 2 * tig + 8 * (r >> 1);
        float v0[3], v1[3];
        split3(__fmul_rn(tile_at(xt, q, p), w[q]), v0);
        split3(__fmul_rn(tile_at(xt, q + 1, p), w[q + 1]), v1);
#pragma unroll
        for (int part = 0; part < 3; ++part) a[part][kk][r] = pack_bf16(v0[part], v1[part]);
      }
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma64<1>(acc, a[part][kk], desc_nmajor(Bt, kk), 1);
    wgmma_commit();
    if (warp == 0 && c + 1 < nc) {
      decay(c + 1);
      if (c + 2 < nc) dt_raw(dtrow + (c + 2) * kQ * dt_ss, dt_ss, qn_of(c + 2), raw);
    }
    wgmma_wait_all();
    fence_regs<32>(acc);
#pragma unroll
    for (int part = 0; part < 3; ++part) fence_regs<4>(a[part]);
  }
  store_state(acc, gstate);
}

// 2. grid (chunks, ceil(H / kOutHeads), B). C B^T once for the CTA's
// heads (C and B K-major in shared memory), then per head acc = C s_in^T
// (s_in split into three K-major tiles), scaled by exp(L_q), then acc +=
// M x (M split, the register A operand; x N-major); y = bf16(acc) + bf16(x
// D) in bf16, rows q < qn. A slice's chunks: x, dt and y start at its
// first position, S is its length and Sy the rows of a sequence's y.
__global__ void __launch_bounds__(kScanThreads)
    ssd_prefill_out_kernel(const bf16* __restrict__ xbc, long long x_sb, long long x_ss,
                           const bf16* __restrict__ dt, long long dt_sb, long long dt_ss,
                           const bf16* __restrict__ dt_bias, const bf16* __restrict__ A_log,
                           const bf16* __restrict__ D, const float* __restrict__ states,
                           bf16* __restrict__ y, int Sy, int S, int H, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ct = align1024(smem_raw);                   // C: rows q, 2 boxes of n
  uint8_t* Bt = Ct + 2 * kBox;                         // B: rows k, 2 boxes of n
  uint8_t* xt = Bt + 2 * kBox;                         // x of the head: rows k, cols p
  uint8_t* st = xt + kBox;                             // s_in hi, mid, lo: rows p, 2 boxes of n
  bf16* ys = reinterpret_cast<bf16*>(st + 6 * kBox);  // y staging, 16 rows a warp
  float* dts = reinterpret_cast<float*>(ys + 64 * kYPitch);
  float* L = dts + kOutHeads * kQ;
  const int c = blockIdx.x, nc = gridDim.x, h0 = blockIdx.y * kOutHeads, b = blockIdx.z;
  const int c0 = c * kQ, qn = min(kQ, S - c0), nh = min(kOutHeads, H - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int di = H * kHP;
  const bf16* rows = xbc + b * x_sb + c0 * x_ss;
  load_tile<kNS>(Bt, rows + di, x_ss, qn, N);
  load_tile<kNS>(Ct, rows + di + N, x_ss, qn, N);
  for (int i = warp; i < nh; i += kScanThreads / 32) {
    const int h = h0 + i;
    float raw[2];
    dt_raw(dt + b * dt_sb + c0 * dt_ss + h, dt_ss, qn, raw);
    decay_of(raw, qn, f(dt_bias[h]), -expf(f(A_log[h])), dts + i * kQ, L + i * kQ, nullptr);
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  // C B^T, C (rows q) and B (rows k) both K-major in shared memory
  float cb[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) cb[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma64ss(cb, desc_kmajor(Ct, kk), desc_kmajor(Bt, kk), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<32>(cb);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    __syncthreads();                                    // the last head's reads of xt and st
    load_tile<kHP>(xt, rows + h * kHP, x_ss, qn, kHP);
    {  // s_in, split into three bf16 tiles; half a thread's loads in flight at a time
      constexpr int kLoads = kHP * kNS / 4 / kScanThreads, kBatch = kLoads / 2;
      const float* sin = states + (((size_t)b * nc + c) * H + h) * kHP * N;
#pragma unroll
      for (int k0 = 0; k0 < kLoads; k0 += kBatch) {
        float4 v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int e = tid + (k0 + k) * kScanThreads, p = e / (kNS / 4), n = (e % (kNS / 4)) * 4;
          v[k] = n < N ? __ldcs(reinterpret_cast<const float4*>(sin + p * N + n))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int e = tid + (k0 + k) * kScanThreads, p = e / (kNS / 4), n = (e % (kNS / 4)) * 4;
          float s0[3], s1[3], s2[3], s3[3];
          split3(v[k].x, s0);
          split3(v[k].y, s1);
          split3(v[k].z, s2);
          split3(v[k].w, s3);
#pragma unroll
          for (int part = 0; part < 3; ++part)
            *reinterpret_cast<uint2*>(st + part * 2 * kBox + swz(p, n)) =
                make_uint2(pack_bf16(s0[part], s1[part]), pack_bf16(s2[part], s3[part]));
        }
      }
    }
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();

    const float* Lh = L + i * kQ;
    const float* dh = dts + i * kQ;
    uint32_t mf[3][4][4];                               // M's parts, k16 steps of keys
    {
      // acc = C s_in^T on the tensor cores, while M = exp(L_q - L_k) CB dt_k
      // (k <= q) is computed and split
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 3; ++part)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma64ss(acc, desc_kmajor(Ct, kk), desc_kmajor(st + part * 2 * kBox, kk),
                    part + kk > 0);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int q = warp * 16 + gid + 8 * rr, k = 8 * j + 2 * tig;
          if (8 * j > warp * 16 + 15) {                 // the warp's rows see none of these keys
#pragma unroll
            for (int part = 0; part < 3; ++part) mf[part][j / 2][(j & 1) * 2 + rr] = 0u;
            continue;
          }
          float m0[3], m1[3];
          split3(k <= q ? __fmul_rn(expf(__fsub_rn(Lh[q], Lh[k])),
                                    __fmul_rn(cb[4 * j + 2 * rr], dh[k]))
                        : 0.f, m0);
          split3(k + 1 <= q ? __fmul_rn(expf(__fsub_rn(Lh[q], Lh[k + 1])),
                                        __fmul_rn(cb[4 * j + 2 * rr + 1], dh[k + 1]))
                            : 0.f, m1);
#pragma unroll
          for (int part = 0; part < 3; ++part)
            mf[part][j / 2][(j & 1) * 2 + rr] = pack_bf16(m0[part], m1[part]);
        }
      wgmma_wait_all();
      fence_regs<32>(acc);
    }
    // acc = exp(L_q) C s_in^T, then += M x
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float eL = expf(Lh[warp * 16 + gid + 8 * rr]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * j + 2 * rr] = __fmul_rn(acc[4 * j + 2 * rr], eL);
        acc[4 * j + 2 * rr + 1] = __fmul_rn(acc[4 * j + 2 * rr + 1], eL);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma64<1>(acc, mf[part][kk], desc_nmajor(xt, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(acc);
#pragma unroll
    for (int part = 0; part < 3; ++part) fence_regs<4>(mf[part]);

    // y = bf16(the scan's y) + bf16(x D) in bf16, staged, then rows q < qn
    const float Dh = f(D[h]);
    bf16* stage = ys + warp * 16 * kYPitch;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int q = warp * 16 + gid + 8 * rr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + 2 * tig;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float skip = rb(__fmul_rn(tile_at(xt, q, p + e), Dh));
          o[e] = __fadd_rn(rb(acc[4 * j + 2 * rr + e]), skip);
        }
        *reinterpret_cast<__nv_bfloat162*>(stage + (gid + 8 * rr) * kYPitch + p) =
            __floats2bfloat162_rn(o[0], o[1]);
      }
    }
    __syncwarp();
    for (int e = lane; e < 16 * (kHP / 8); e += 32) {
      const int r = e / (kHP / 8), q = warp * 16 + r;
      if (q < qn)
        *reinterpret_cast<uint4*>(y + ((size_t)b * Sy + c0 + q) * di + h * kHP +
                                  (e % (kHP / 8)) * 8) =
            *reinterpret_cast<const uint4*>(stage + r * kYPitch + (e % (kHP / 8)) * 8);
    }
    __syncwarp();
  }
}

}  // namespace

// x (B, S, C) bf16 at row strides (x_sb, x_ss), both multiples of 8, and
// unit column stride, 16-byte aligned; w (kWidth, C), b (C,) bf16; state
// (B, kWidth - 1, C) bf16, read (carry) and written in place for the rows
// where advance (B,) bool is set (null: every row); y (B, S, C) bf16; C %
// 8 == 0. Returns the launch's cudaError_t.
extern "C" int ssm_conv(const void* x, long long x_sb, long long x_ss, const void* w,
                        const void* b, void* state, const void* advance, void* y, int B, int S,
                        int C, int carry, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || C % 8 || x_sb % 8 || x_ss % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  const long long threads = (long long)B * ((S + kConvPos - 1) / kConvPos) * (C / 8);
  if (threads >= (1ll << 31) - kConvThreads) return cudaErrorInvalidValue;
  ssm_conv_kernel<<<(unsigned)((threads + kConvThreads - 1) / kConvThreads), kConvThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), x_sb, x_ss, static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<bf16*>(state),
      static_cast<const unsigned char*>(advance), static_cast<bf16*>(y), B, S, C, carry);
  return cudaGetLastError();
}

// One decode token's conv and state update in one launch: xbc (B, H*P +
// 2N) bf16, the token's conv input (x, then B, then C), rows at stride
// xbc_sb, a multiple of 8, 16-byte aligned; dt (B, H) bf16 rows at stride
// dt_sb (before softplus); conv_w (kWidth, H*P + 2N), conv_b bf16;
// conv_state (B, kWidth - 1, H*P + 2N) bf16; dt_bias, A_log, D (H,) bf16;
// state (B, H, P, N) f32, 16-byte aligned; y (B, H*P) bf16. Both states
// are replaced in place where advance (B,) bool is set (null: every row).
// tickets: B int32 zeros, left zero. P % 64 == 0, N % 4 == 0, N <= 128.
// Returns the launch's cudaError_t.
extern "C" int ssm_decode_step(const void* xbc, long long xbc_sb, const void* dt, long long dt_sb,
                               const void* conv_w, const void* conv_b, void* conv_state,
                               const void* dt_bias, const void* A_log, const void* D,
                               void* state, const void* advance, void* y, void* tickets, int B,
                               int H, int P, int N, void* stream) {
  if (B <= 0 || H <= 0 || P <= 0 || P % kStepTile || N <= 0 || N % 4 || N > kDecN ||
      xbc_sb % 8 || reinterpret_cast<uintptr_t>(xbc) % 16)
    return cudaErrorInvalidValue;
  const dim3 grid(P / kStepTile, H, B);
  ssm_decode_step_kernel<<<grid, kStepWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xbc), xbc_sb, static_cast<const bf16*>(dt), dt_sb,
      static_cast<const bf16*>(conv_w), static_cast<const bf16*>(conv_b),
      static_cast<bf16*>(conv_state), static_cast<const bf16*>(dt_bias),
      static_cast<const bf16*>(A_log), static_cast<const bf16*>(D), static_cast<float*>(state),
      static_cast<const unsigned char*>(advance), static_cast<bf16*>(y),
      static_cast<unsigned*>(tickets), H, P, N);
  return cudaGetLastError();
}

// xbc (B, S, H*P + 2N) bf16 at row strides (x_sb, x_ss), both multiples of
// 8, 16-byte aligned; dt (B, S, H) bf16 at strides (dt_sb, dt_ss) (before
// softplus); dt_bias, A_log, D (H,) bf16; state (B, H, P, N) f32: the
// initial state (carry; else zeros), then the final one, in place; states
// (B, min(ceil(S / 64), slice), H, P, N) f32 scratch (a slice's incoming
// states); y (B, S, H*P) bf16 with the D skip. P == 64, N % 8 == 0, N <=
// 128, slice > 0. Two launches a slice of `slice` chunks: the state walk,
// then the chunk outputs. Returns the first launch error.
extern "C" int ssd_prefill(const void* xbc, long long x_sb, long long x_ss, const void* dt,
                           long long dt_sb, long long dt_ss, const void* dt_bias,
                           const void* A_log, const void* D, void* state, void* states, void* y,
                           int B, int S, int H, int P, int N, int carry, int slice,
                           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P != kHP || N <= 0 || N % 8 || N > kNS || x_sb % 8 ||
      x_ss % 8 || slice <= 0 || reinterpret_cast<uintptr_t>(xbc) % 16)
    return cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(ssd_prefill_state_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kStateSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_prefill_out_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kOutSmem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + kQ - 1) / kQ, di = H * kHP;
  for (int c0 = 0; c0 < nc; c0 += slice) {
    const int s0 = c0 * kQ, n = slice < nc - c0 ? slice : nc - c0;
    const int Ss = S - s0 < n * kQ ? S - s0 : n * kQ;
    const bf16* x = static_cast<const bf16*>(xbc) + s0 * x_ss;
    const bf16* d = static_cast<const bf16*>(dt) + s0 * dt_ss;
    ssd_prefill_state_kernel<<<dim3((N + 63) / 64, H, B), kScanThreads, kStateSmem, st>>>(
        x, x_sb, x_ss, d, dt_sb, dt_ss, static_cast<const bf16*>(dt_bias),
        static_cast<const bf16*>(A_log), static_cast<float*>(state), static_cast<float*>(states),
        Ss, H, N, carry || c0 > 0);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ssd_prefill_out_kernel<<<dim3(n, (H + kOutHeads - 1) / kOutHeads, B), kScanThreads, kOutSmem,
                             st>>>(
        x, x_sb, x_ss, d, dt_sb, dt_ss, static_cast<const bf16*>(dt_bias),
        static_cast<const bf16*>(A_log), static_cast<const bf16*>(D),
        static_cast<const float*>(states), static_cast<bf16*>(y) + (size_t)s0 * di,
        S, Ss, H, N);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// y (M, d) bf16, d % 8 == 0 and d <= per * 256; z (M, d) bf16 rows at
// stride z_rs, z_rs % 8 == 0; w (d,) bf16; out (M, d) bf16; every pointer
// 16-byte aligned. per (run-warps a CTA, at most kNormMaxThreads / 32) is
// kernels/ssm.py::norm_plan(d)'s. Returns the launch's cudaError_t.
extern "C" int gated_rmsnorm(const void* y, const void* z, long long z_rs, const void* w,
                             void* out, int M, int d, float eps, int per, void* stream) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (M <= 0 || d <= 0 || d % 8 || z_rs % 8 || per < 1 || per > kNormMaxThreads / 32 ||
      d > per * 256 || !aligned(y) || !aligned(z) || !aligned(w) || !aligned(out))
    return cudaErrorInvalidValue;
  gated_rmsnorm_kernel<<<M, 32 * per, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(z), z_rs, static_cast<const bf16*>(w),
      static_cast<bf16*>(out), d, eps);
  return cudaGetLastError();
}
