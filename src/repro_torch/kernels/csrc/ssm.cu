// The SSM family's kernels (Mamba-2 SSD), for sm_90a: the short causal
// conv with its state, the SSD state update of one decode token, the
// chunked SSD scan of a prefill, and the gated RMSNorm.
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
// mamba2-2.7b); the scan builds (B, Q, Q, H) f32 tensors a chunk. Each
// kernel here is one launch.
//
// Bounds.
// - ssm_conv and gated_rmsnorm: bytes. One pass over their rows, reading
//   each input once (the gated norm keeps a row in registers, its loads
//   in flight together: a decode step has only B rows, one CTA each); at
//   decode they are a few hundred kilobytes, so the launch latency bounds
//   them.
// - ssm_decode_update: bytes. The state (B, H, P, N) f32 is read once and
//   written once, in place; a warp takes one (slot, head, p) row of N
//   states in 16-byte loads, a CTA eight rows, so one slot of 80 heads of
//   64 is 640 CTAs on 132 SMs (the split along P fills the card at 1 slot).
// - ssd_prefill: operations, in f32 on CUDA cores. A CTA takes one
//   (sequence, head, 32 columns of P) and walks the chunks in order,
//   carrying its (32, N) state in shared memory. A chunk of kQ = 64
//   positions: C B^T (64 x 64 over N), the decay matrix
//   M = exp(L_q - L_k) C_q.B_k dt_k for k <= q (the segment-sum form: L
//   is the chunk's own running sum of dt * A, so no quotient of two
//   exponentials can underflow to 0/0 over a long prompt), y = M x +
//   exp(L_q) C s^T, and s <- s exp(L_last) + sum_k exp(L_last - L_k)
//   dt_k x_k B_k. The chunk is fixed and the last one masked (dt 0, x, B
//   and C 0 past the prompt, which leave the state alone), so an
//   exact-length prefill of any length scans whole chunks; the JAX rule
//   halves its chunk until it divides S, down to one position for an odd
//   S. The algorithm is exact: only the rounding differs from the plain
//   scan. C B^T is recomputed by each of a sequence's 2H CTAs; a
//   tensor-core design that shares it is later work.
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

constexpr int kConvThreads = 128;  // channels a CTA
constexpr int kConvRun = 32;       // positions a thread walks
constexpr int kWidth = 4;          // the conv's width (every config's)
constexpr int kDecRows = 8;        // decode: p rows a CTA, a warp each
constexpr int kNormThreads = 256;
constexpr int kNormRuns = 4;       // gated norm: 8-element runs a thread keeps
constexpr int kQ = 64;             // the prefill scan's chunk
constexpr int kPT = 32;            // the prefill scan's columns of P a CTA
constexpr int kScanThreads = 256;

__device__ __forceinline__ float f(bf16 v) { return __bfloat162float(v); }
// v rounded to bf16, as a bf16 op's result is
__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16(v)); }
// PyTorch's silu: x / (1 + exp(-x)) in f32
__device__ __forceinline__ float silu(float v) { return __fdiv_rn(v, __fadd_rn(1.f, expf(-v))); }
__device__ __forceinline__ float softplus(float v) {
  return __fadd_rn(fmaxf(v, 0.f), log1pf(expf(-fabsf(v))));
}

// ------------------------------------------------------------ causal conv --
// grid (ceil(C / kConvThreads), ceil(S / kConvRun), B). Thread (c, run)
// keeps the kWidth - 1 inputs before its run in registers and slides them
// along it. Position s < 0 of a row is state row kWidth - 1 + s (zero
// without carry). The thread of run 0 also writes the new state (the last
// kWidth - 1 positions of state ++ x), after reading every old state value
// it needs: no other thread reads the state (a later run starts at
// s >= kConvRun >= kWidth - 1).
__global__ void __launch_bounds__(kConvThreads)
    ssm_conv_kernel(const bf16* __restrict__ x, long long x_sb, long long x_ss,
                    const bf16* __restrict__ w, const bf16* __restrict__ bias, bf16* state,
                    const unsigned char* __restrict__ advance, bf16* __restrict__ y, int S, int C,
                    int carry) {
  const int c = blockIdx.x * kConvThreads + threadIdx.x;
  if (c >= C) return;
  const int b = blockIdx.z;
  constexpr int K = kWidth - 1;
  const int s0 = blockIdx.y * kConvRun;
  const int s1 = min(s0 + kConvRun, S);
  const bf16* xr = x + b * x_sb + c;
  bf16* st = state + (size_t)b * K * C + c;
  auto at = [&](int pos) -> float {  // position pos of state ++ x (pos < S)
    if (pos >= 0) return f(xr[pos * x_ss]);
    return carry ? f(st[(size_t)(K + pos) * C]) : 0.f;
  };
  float wt[kWidth], win[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) wt[j] = f(w[(size_t)j * C + c]);
  const float bc = f(bias[c]);
#pragma unroll
  for (int j = 0; j < K; ++j) win[j] = at(s0 - K + j);
  for (int s = s0; s < s1; ++s) {
    win[K] = f(xr[s * x_ss]);
    float acc = rb(__fmul_rn(win[0], wt[0]));
#pragma unroll
    for (int j = 1; j < kWidth; ++j) acc = rb(__fadd_rn(acc, rb(__fmul_rn(win[j], wt[j]))));
    y[((size_t)b * S + s) * C + c] = __float2bfloat16(silu(rb(__fadd_rn(acc, bc))));
#pragma unroll
    for (int j = 0; j < K; ++j) win[j] = win[j + 1];
  }
  if (blockIdx.y != 0 || (advance != nullptr && !advance[b])) return;
  float next[K];
#pragma unroll
  for (int j = 0; j < K; ++j) next[j] = at(S - K + j);
#pragma unroll
  for (int j = 0; j < K; ++j) st[(size_t)j * C] = __float2bfloat16(next[j]);
}

// ---------------------------------------------------- decode state update --
// grid (ceil(P / kDecRows), H, B), a warp a (b, h, p) row of N states:
// lane l takes n = 4 l, 4 l + 128, ... (N % 4 == 0) in float4 loads.
// S <- S decay + (dt x) B_n; y = sum_n S C_n + x D, rounded once.
__global__ void __launch_bounds__(kDecRows * 32)
    ssm_decode_kernel(const bf16* __restrict__ xbc, long long xbc_sb, const bf16* __restrict__ dt,
                      long long dt_sb, const bf16* __restrict__ dt_bias,
                      const bf16* __restrict__ A_log, const bf16* __restrict__ D, float* state,
                      const unsigned char* __restrict__ advance, bf16* __restrict__ y, int H,
                      int P, int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.x * kDecRows + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (p >= P) return;
  const bf16* row = xbc + b * xbc_sb;
  const int di = H * P;
  const float dtv = softplus(__fadd_rn(f(dt[b * dt_sb + h]), f(dt_bias[h])));
  const float A = -expf(f(A_log[h]));
  const float decay = expf(__fmul_rn(dtv, A));
  const float xv = f(row[h * P + p]);
  const float dx = __fmul_rn(dtv, xv);
  float* sp = state + (((size_t)b * H + h) * P + p) * N;
  const bool write = advance == nullptr || advance[b];
  float acc = 0.f;
  for (int n = lane * 4; n < N; n += 128) {
    float4 s = *reinterpret_cast<const float4*>(sp + n);
    float* sv = reinterpret_cast<float*>(&s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sv[j] = __fadd_rn(__fmul_rn(sv[j], decay), __fmul_rn(dx, f(row[di + n + j])));
      acc = fmaf(sv[j], f(row[di + N + n + j]), acc);
    }
    if (write) *reinterpret_cast<float4*>(sp + n) = s;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0)
    y[(size_t)b * di + h * P + p] = __float2bfloat16(__fadd_rn(acc, __fmul_rn(xv, f(D[h]))));
}

// ---------------------------------------------------------- gated RMSNorm --
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kNormThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = lane < kNormThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One CTA a row of d: g = bf16(y * bf16(silu(z))), out = bf16(g * rsqrt(
// mean(g^2) + eps) * w). A thread takes the runs of 8 elements at
// (threadIdx.x + c * kNormThreads) * 8, c < kNormRuns, in 16-byte loads
// (d % 8 == 0, rows 16-byte aligned, d <= kNormRuns * kNormThreads * 8),
// and keeps g in registers between the sum and the scaling, so the row is
// read once, all its loads in flight together (a decode step has 4 rows: 4
// CTAs, where a loop over the row would pay one memory latency a step).
__global__ void __launch_bounds__(kNormThreads)
    gated_rmsnorm_kernel(const bf16* __restrict__ y, const bf16* __restrict__ z, long long z_rs,
                         const bf16* __restrict__ w, bf16* __restrict__ out, int d, float eps) {
  const size_t row = blockIdx.x;
  const bf16* yr = y + row * d;
  const bf16* zr = z + row * z_rs;
  auto gate = [&](float yv, float zv) { return rb(__fmul_rn(yv, rb(silu(zv)))); };
  float ss = 0.f;
  float g[kNormRuns][8];
#pragma unroll
  for (int c = 0; c < kNormRuns; ++c) {
    const int i = (threadIdx.x + c * kNormThreads) * 8;
    if (i >= d) continue;
    const uint4 uy = *reinterpret_cast<const uint4*>(yr + i);
    const uint4 uz = *reinterpret_cast<const uint4*>(zr + i);
    const bf16* hy = reinterpret_cast<const bf16*>(&uy);
    const bf16* hz = reinterpret_cast<const bf16*>(&uz);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      g[c][j] = gate(f(hy[j]), f(hz[j]));
      ss = __fadd_rn(ss, __fmul_rn(g[c][j], g[c][j]));
    }
  }
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(block_sum(ss), (float)d), eps));
#pragma unroll
  for (int c = 0; c < kNormRuns; ++c) {
    const int i = (threadIdx.x + c * kNormThreads) * 8;
    if (i >= d) continue;
    const uint4 uw = *reinterpret_cast<const uint4*>(w + i);
    const bf16* hw = reinterpret_cast<const bf16*>(&uw);
    uint4 uo;
    bf16* ho = reinterpret_cast<bf16*>(&uo);
#pragma unroll
    for (int j = 0; j < 8; ++j) ho[j] = __float2bfloat16(__fmul_rn(__fmul_rn(g[c][j], r), f(hw[j])));
    *reinterpret_cast<uint4*>(out + row * d + i) = uo;
  }
}

// ------------------------------------------------------- chunked SSD scan --
// Shared memory: B and C of the chunk (kQ x N, rows padded to N + 1 so a
// warp reading one column across rows hits 32 banks), the state (kPT x N,
// padded), M (kQ x kQ, padded), x (kQ x kPT, padded), and L, dt and the
// state weights exp(L_last - L_k) dt_k.
__host__ __device__ constexpr size_t scan_smem(int N) {
  return sizeof(float) * ((size_t)2 * kQ * (N + 1) + (size_t)kPT * (N + 1) +
                          (size_t)kQ * (kQ + 1) + (size_t)kQ * (kPT + 1) + 3 * kQ);
}

// grid (ceil(P / kPT), H, B)
__global__ void __launch_bounds__(kScanThreads)
    ssd_prefill_kernel(const bf16* __restrict__ xbc, long long x_sb, long long x_ss,
                       const bf16* __restrict__ dt, long long dt_sb, long long dt_ss,
                       const bf16* __restrict__ dt_bias, const bf16* __restrict__ A_log,
                       const bf16* __restrict__ D, float* state, bf16* __restrict__ y, int S, int H,
                       int P, int N, int carry) {
  extern __shared__ float smem[];
  const int NP = N + 1, MP = kQ + 1, XP = kPT + 1;
  float* Bs = smem;
  float* Cs = Bs + kQ * NP;
  float* st = Cs + kQ * NP;
  float* Ms = st + kPT * NP;
  float* xs = Ms + kQ * MP;
  float* L = xs + kQ * XP;
  float* dts = L + kQ;
  float* wv = dts + kQ;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const int di = H * P;
  float* gst = state + (((size_t)b * H + h) * P) * N;
  for (int i = tid; i < kPT * N; i += kScanThreads) {
    const int pr = i / N, n = i % N;
    st[pr * NP + n] = (carry && p0 + pr < P) ? gst[(size_t)(p0 + pr) * N + n] : 0.f;
  }
  const float A = -expf(f(A_log[h]));
  const float Dh = f(D[h]);
  const float bias = f(dt_bias[h]);
  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int qn = min(kQ, S - c0);
    __syncthreads();  // the last chunk's reads of B, C, x, M are done
    if (tid < kQ) {
      const float d =
          tid < qn ? softplus(__fadd_rn(f(dt[b * dt_sb + (c0 + tid) * dt_ss + h]), bias)) : 0.f;
      dts[tid] = d;
      L[tid] = __fmul_rn(d, A);
    }
    for (int i = tid; i < kQ * N; i += kScanThreads) {
      const int q = i / N, n = i % N;
      const bf16* r = xbc + b * x_sb + (c0 + q) * x_ss;
      Bs[q * NP + n] = q < qn ? f(r[di + n]) : 0.f;
      Cs[q * NP + n] = q < qn ? f(r[di + N + n]) : 0.f;
    }
    for (int i = tid; i < kQ * kPT; i += kScanThreads) {
      const int q = i / kPT, pr = i % kPT;
      xs[q * XP + pr] = (q < qn && p0 + pr < P)
                            ? f(xbc[b * x_sb + (c0 + q) * x_ss + h * P + p0 + pr]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // the chunk's running sum of dt * A, in order
      float acc = 0.f;
      for (int q = 0; q < kQ; ++q) {
        acc = __fadd_rn(acc, L[q]);
        L[q] = acc;
      }
    }
    __syncthreads();
    const float Llast = L[kQ - 1];
    if (tid < kQ) wv[tid] = __fmul_rn(expf(__fsub_rn(Llast, L[tid])), dts[tid]);
    {  // M: thread (ty, tx) takes q = ty + 16 i, k = tx + 16 j
      const int ty = tid / 16, tx = tid % 16;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cq[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cq[i] = Cs[(ty + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = Bs[(tx + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cq[i], bk[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = ty + 16 * i, k = tx + 16 * j;
          Ms[q * MP + k] = k <= q ? __fmul_rn(expf(__fsub_rn(L[q], L[k])),
                                              __fmul_rn(acc[i][j], dts[k]))
                                  : 0.f;
        }
    }
    __syncthreads();
    {  // y: thread (ty, tx) takes q = ty + 32 i, pr = tx + 8 j
      const int ty = tid / 8, tx = tid % 8;
      float yi[2][4] = {}, ye[2][4] = {};
      for (int k = 0; k < kQ; ++k) {
        float m[2], xv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) m[i] = Ms[(ty + 32 * i) * MP + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[k * XP + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yi[i][j] = fmaf(m[i], xv[j], yi[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[2], sv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) cv[i] = Cs[(ty + 32 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = st[(tx + 8 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ye[i][j] = fmaf(cv[i], sv[j], ye[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = ty + 32 * i;
        if (q >= qn) continue;
        const float eL = expf(L[q]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pr = tx + 8 * j;
          if (p0 + pr >= P) continue;
          const float yv = rb(__fadd_rn(yi[i][j], __fmul_rn(ye[i][j], eL)));
          const float skip = rb(__fmul_rn(xs[q * XP + pr], Dh));
          y[((size_t)b * S + c0 + q) * di + h * P + p0 + pr] =
              __float2bfloat16(__fadd_rn(yv, skip));
        }
      }
    }
    __syncthreads();  // every read of the old state is done
    {  // state: thread takes n = lane + 32 j, pr = warp + 8 i
      const int lane = tid % 32, warp = tid / 32;
      const float gamma = expf(Llast);
      float acc[4][4] = {};
      for (int k = 0; k < kQ; ++k) {
        float wb[4], xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wb[j] = __fmul_rn(wv[k], Bs[k * NP + lane + 32 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[k * XP + warp + 8 * i];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wb[j], xv[i], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pr = warp + 8 * i, n = lane + 32 * j;
          if (n < N) st[pr * NP + n] = __fadd_rn(__fmul_rn(st[pr * NP + n], gamma), acc[i][j]);
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < kPT * N; i += kScanThreads) {
    const int pr = i / N, n = i % N;
    if (p0 + pr < P) gst[(size_t)(p0 + pr) * N + n] = st[pr * NP + n];
  }
}

}  // namespace

// x (B, S, C) bf16 at row strides (x_sb, x_ss) and unit column stride; w
// (kWidth, C), b (C,) bf16; state (B, kWidth - 1, C) bf16, read (carry) and
// written in place for the rows where advance (B,) bool is set (null: every
// row); y (B, S, C) bf16. Returns the launch's cudaError_t.
extern "C" int ssm_conv(const void* x, long long x_sb, long long x_ss, const void* w,
                        const void* b, void* state, const void* advance, void* y, int B, int S,
                        int C, int carry, void* stream) {
  static_assert(kConvRun >= kWidth - 1, "a run must hold the state's positions");
  if (B <= 0 || S <= 0 || C <= 0) return cudaErrorInvalidValue;
  const dim3 grid((C + kConvThreads - 1) / kConvThreads, (S + kConvRun - 1) / kConvRun, B);
  ssm_conv_kernel<<<grid, kConvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), x_sb, x_ss, static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<bf16*>(state),
      static_cast<const unsigned char*>(advance), static_cast<bf16*>(y), S, C, carry);
  return cudaGetLastError();
}

// xbc (B, H*P + 2N) bf16 rows at stride xbc_sb (x, then B, then C); dt
// (B, H) bf16 rows at stride dt_sb (before softplus); dt_bias, A_log, D
// (H,) bf16; state (B, H, P, N) f32, 16-byte aligned, N % 4 == 0, updated
// in place where advance (B,) bool is set (null: every row); y (B, H*P)
// bf16. Returns the launch's cudaError_t.
extern "C" int ssm_decode_update(const void* xbc, long long xbc_sb, const void* dt,
                                 long long dt_sb, const void* dt_bias, const void* A_log,
                                 const void* D, void* state, const void* advance, void* y, int B,
                                 int H, int P, int N, void* stream) {
  if (B <= 0 || H <= 0 || P <= 0 || N <= 0 || N % 4) return cudaErrorInvalidValue;
  const dim3 grid((P + kDecRows - 1) / kDecRows, H, B);
  ssm_decode_kernel<<<grid, kDecRows * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xbc), xbc_sb, static_cast<const bf16*>(dt), dt_sb,
      static_cast<const bf16*>(dt_bias), static_cast<const bf16*>(A_log),
      static_cast<const bf16*>(D), static_cast<float*>(state),
      static_cast<const unsigned char*>(advance), static_cast<bf16*>(y), H, P, N);
  return cudaGetLastError();
}

// xbc (B, S, H*P + 2N) bf16 at row strides (x_sb, x_ss); dt (B, S, H) bf16
// at strides (dt_sb, dt_ss) (before softplus); dt_bias, A_log, D (H,) bf16;
// state (B, H, P, N) f32: the initial state (carry; else zeros), then the
// final one, in place; y (B, S, H*P) bf16 with the D skip. Returns the
// launch's cudaError_t.
extern "C" int ssd_prefill(const void* xbc, long long x_sb, long long x_ss, const void* dt,
                           long long dt_sb, long long dt_ss, const void* dt_bias,
                           const void* A_log, const void* D, void* state, void* y, int B, int S,
                           int H, int P, int N, int carry, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || N > 128) return cudaErrorInvalidValue;
  const size_t smem = scan_smem(N);
  static size_t sized = 0;
  if (smem > sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)scan_smem(128));
    if (e != cudaSuccess) return e;
    sized = scan_smem(128);
  }
  const dim3 grid((P + kPT - 1) / kPT, H, B);
  ssd_prefill_kernel<<<grid, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xbc), x_sb, x_ss, static_cast<const bf16*>(dt), dt_sb, dt_ss,
      static_cast<const bf16*>(dt_bias), static_cast<const bf16*>(A_log),
      static_cast<const bf16*>(D), static_cast<float*>(state), static_cast<bf16*>(y), S, H, P, N,
      carry);
  return cudaGetLastError();
}

// y (M, d) bf16, d % 8 == 0 and d <= kNormRuns * kNormThreads * 8; z (M, d)
// bf16 rows at stride z_rs, z_rs % 8 == 0; w (d,) bf16; out (M, d) bf16;
// every pointer 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int gated_rmsnorm(const void* y, const void* z, long long z_rs, const void* w,
                             void* out, int M, int d, float eps, void* stream) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (M <= 0 || d <= 0 || d % 8 || z_rs % 8 || d > kNormRuns * kNormThreads * 8 || !aligned(y) ||
      !aligned(z) || !aligned(w) || !aligned(out))
    return cudaErrorInvalidValue;
  gated_rmsnorm_kernel<<<M, kNormThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(z), z_rs, static_cast<const bf16*>(w),
      static_cast<bf16*>(out), d, eps);
  return cudaGetLastError();
}
