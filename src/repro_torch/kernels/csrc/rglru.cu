// The RG-LRU recurrence of the hybrid family (recurrentgemma) for
// sm_90a: the prefill scan over a whole prompt, and the decode step of one
// token.
//
// No Pallas kernel of the JAX package stands behind these: its
//   src/repro/models/hybrid.py:43   _gates (r, i and a from the gate products)
//   src/repro/models/hybrid.py:52   rglru_scan (an associative scan in jnp)
//   src/repro/models/hybrid.py:71   rglru_forward (the prefill's recurrence
//                                   and its gelu-gated output)
//   src/repro/models/hybrid.py:95   rglru_decode (one step)
// compute the layer with jnp outside any kernel. Eagerly the gates, the
// recurrence and the gated output are a dozen PyTorch launches a layer,
// each reading or writing (B, S, w) f32 temporaries; each kernel here is
// one launch that reads the layer's bf16 rows once and writes y once.
//
// Per channel c of width w (every operation in f32, rounded where the JAX
// layer rounds to the activations' bf16):
//   r = bf16(sigmoid(bf16(gx_a + ba)))      the recurrence gate (wa's product
//   i = bf16(sigmoid(bf16(gx_x + bx)))      and bias), the input gate (wx's)
//   a = exp(-8 softplus(a_param) * r)
//   h_t = a h_(t-1) + sqrt(max(1 - a^2, 1e-12)) * xg
//   y_t = bf16(h_t * gelu(gate_t))          gelu in f32 (the JAX logistic form)
// with xg = x * i in f32 in the prefill (rglru_forward) and bf16(x * i) at
// decode (rglru_decode), as the JAX layer computes them. gx holds wa's and
// wx's products side by side in one row, [x wa | x wx] (B, S, 2w), bf16,
// without their biases: the kernels add them (no launch of their own).
//
// Bound: bytes. The scan reads x, the two gate products and the gate
// (8 bytes a position and channel) and writes y (2 bytes); the decode step
// reads the same for one position plus the f32 state and writes both. Of
// the few dozen operations a position and channel, only h = a h + b
// depends on the position before; the gates, the decay, the sqrt factor
// and gelu(gate) do not. Design:
// - rglru_scan_kernel: channels are independent and time is sequential. A
//   CTA owns 32 channels of one sequence (W / 32 * B CTAs: 80 at 1 x 2560,
//   on 132 SMs) and walks the positions in blocks of kBlock, through two
//   shared-memory buffers. Its kScanWarps producer warps compute each
//   position's a, b = sqrt(max(1 - a^2, 1e-12)) xg and gelu(gate),
//   kScanSteps positions a warp, with the next block's loads already in
//   flight. The chain warp runs only h = a h + b over a block, its reads
//   of a and b issued ahead of the chain (the block unrolled), and writes
//   each h over that position's a. A round later the producers read h
//   back, store y = bf16(h gelu(gate)) and fill the same slots with a
//   newer block. One barrier a block hands the buffers over. So the
//   special-function and division work of a position, about a hundred
//   instructions, is spread over 16 producer warps (of the splits that
//   tools/rglru_scan_tiles.py times, the fastest at 4 x 300 and within 3%
//   of the fastest at 1 x 512; fewer warps leave the SM idle on the
//   divisions' and exps' latency), and the serial chain is two dependent
//   operations a position. (One thread a (sequence, channel)
//   doing all of it leaves one or two warps an SM to issue every
//   instruction of 512 positions in turn: 0.182 ms at 1 x 512 on an H100
//   80GB HBM3 at 700 W.) A chunked two-pass scan would also spread the
//   positions over all the SMs.
// - rglru_decode_step_kernel: one thread a (slot, channel); the gates, the
//   step, the gated output and the state write in one pass; a row whose
//   advance is false keeps its state.
// The order of operations is the plain versions' (kernels/rglru.py) op for
// op, each product and sum rounded on its own (the _rn intrinsics keep nvcc
// from contracting them); exp, log1p and the sigmoid's division are CUDA's,
// so the two differ in the last f32 bits only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gelu.cuh"  // round_bf16, gelu_f32 (shared with fused_ops.cu, quant_matmul.cu)

namespace {

using bf16 = __nv_bfloat16;

constexpr int kScanWarps = 16;    // producer warps of a scan CTA
constexpr int kScanSteps = 3;     // positions a producer computes a block
constexpr int kBlock = kScanWarps * kScanSteps;     // positions a block
constexpr int kScanThreads = 32 * (1 + kScanWarps);  // the chain warp first
constexpr int kStepThreads = 256;
constexpr float kC = 8.f;         // the RG-LRU decay sharpness (the JAX _C)

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

// jax.nn.softplus: max(v, 0) + log1p(exp(-|v|))
__device__ __forceinline__ float softplus(float v) {
  return __fadd_rn(fmaxf(v, 0.f), log1pf(expf(-fabsf(v))));
}

// the decay a and the input gate i of one position from wa's and wx's
// products (without bias) and the channel's constants
__device__ __forceinline__ void gates(float ga, float gi, float ba, float bx, float log_a,
                                      float* a, float* i) {
  const float r = round_bf16(sigmoid(round_bf16(__fadd_rn(ga, ba))));
  *i = round_bf16(sigmoid(round_bf16(__fadd_rn(gi, bx))));
  *a = expf(__fmul_rn(log_a, r));
}

// the step's input b = sqrt(max(1 - a^2, 1e-12)) xg
__device__ __forceinline__ float step_input(float a, float xg) {
  return __fmul_rn(sqrtf(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 1e-12f)), xg);
}

// h_t = a h_(t-1) + b
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// the scan CTA's barrier, reached by the chain warp and the producers at
// their own points in the code (a named barrier over all its threads)
__device__ __forceinline__ void handoff() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kScanThreads) : "memory");
}

// grid (ceil(W / 32), B), kScanThreads threads. x (B, S, W), gx (B, S,
// 2W), gate (B, S, W): bf16 rows at the given strides (elements), unit
// channel stride; y (B, S, W) bf16 contiguous; state (B, W) f32, written
// at the end with the last position's y (as the JAX model's prefill
// stores it); the recurrence starts from zeros.
//
// Block k is filled before barrier k, run by the chain between barriers k
// and k + 1, and its y stored after barrier k + 1, when the producers
// refill its buffer with block k + 2: a thread reads and writes only its
// own slots, so one barrier a block orders it all.
__global__ void __launch_bounds__(kScanThreads)
    rglru_scan_kernel(const bf16* __restrict__ x, long long x_bs, long long x_ss,
                      const bf16* __restrict__ gx, long long gx_bs, long long gx_ss,
                      const bf16* __restrict__ gate, long long g_bs, long long g_ss,
                      const bf16* __restrict__ ba, const bf16* __restrict__ bx,
                      const bf16* __restrict__ a_param, float* __restrict__ state,
                      bf16* __restrict__ y, int S, int W) {
  // [buffer][a (then h), b, gelu(gate)][position of the block][channel]
  __shared__ float sm[2][3][kBlock][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int b = blockIdx.y;
  const int blocks = (S + kBlock - 1) / kBlock;
  if (warp == 0) {
    // the chain; past S (the last block's tail) it runs on the producers'
    // values for zero inputs, finite and never stored
    float h = 0.f;
    for (int k = 0; k < blocks; ++k) {
      handoff();                             // barrier k: block k filled
      float(*buf)[kBlock][32] = sm[k & 1];
#pragma unroll
      for (int u = 0; u < kBlock; ++u) {
        h = step(buf[0][u][lane], h, buf[1][u][lane]);
        buf[0][u][lane] = h;
      }
    }
    handoff();                               // barrier `blocks`: the last h written
    return;
  }
  // a producer: positions q * kScanSteps + u of each block
  const int q = warp - 1;
  const bool in = c < W;
  const int cc = in ? c : 0;               // a lane past W computes channel 0, unstored
  const float log_a = __fmul_rn(-kC, softplus(f32(a_param[cc])));
  const float bia = f32(ba[cc]), bix = f32(bx[cc]);
  const bf16* xp = x + b * x_bs + cc;
  const bf16* ap = gx + b * gx_bs + cc;
  const bf16* gp = gate + b * g_bs + cc;
  bf16* yp = y + (size_t)b * S * W + c;
  struct Pos { bf16 x, a, i, g; };          // a position's four loads (0 past S)
  auto load = [&](int t0, Pos* v) {
#pragma unroll
    for (int u = 0; u < kScanSteps; ++u) {
      const long long t = t0 + q * kScanSteps + u;
      const bf16 z = __float2bfloat16(0.f);
      const bool ok = t < S;
      v[u] = Pos{ok ? xp[t * x_ss] : z, ok ? ap[t * gx_ss] : z, ok ? ap[t * gx_ss + W] : z,
                 ok ? gp[t * g_ss] : z};
    }
  };
  Pos cur[kScanSteps], nxt[kScanSteps];
  load(0, cur);
  for (int k = 0; k <= blocks + 1; ++k) {
    float(*buf)[kBlock][32] = sm[k & 1];
    if (k < blocks) load((k + 1) * kBlock, nxt);   // in flight meanwhile
    if (k >= 2) {                          // y of block k - 2, whose h the chain wrote
#pragma unroll
      for (int u = 0; u < kScanSteps; ++u) {
        const int p = q * kScanSteps + u, t = (k - 2) * kBlock + p;
        const bf16 yv = __float2bfloat16(__fmul_rn(buf[0][p][lane], buf[2][p][lane]));
        if (in && t < S) yp[(size_t)t * W] = yv;
        if (in && t == S - 1) state[(size_t)b * W + c] = f32(yv);
      }
    }
    if (k < blocks) {                      // block k into the same slots
#pragma unroll
      for (int u = 0; u < kScanSteps; ++u) {
        float a, i;
        gates(f32(cur[u].a), f32(cur[u].i), bia, bix, log_a, &a, &i);
        const int p = q * kScanSteps + u;
        buf[0][p][lane] = a;
        buf[1][p][lane] = step_input(a, __fmul_rn(f32(cur[u].x), i));
        buf[2][p][lane] = gelu_f32(f32(cur[u].g));
      }
    }
    if (k <= blocks) handoff();            // barrier k
    if (k < blocks) {
#pragma unroll
      for (int u = 0; u < kScanSteps; ++u) cur[u] = nxt[u];
    }
  }
}

// grid (ceil(W / kStepThreads), B). x (B, W), gx (B, 2W), gate (B, W) bf16
// at the given row strides; state (B, W) f32; advance (B,) bool or null; y
// (B, W) bf16 contiguous.
__global__ void __launch_bounds__(kStepThreads)
    rglru_decode_step_kernel(const bf16* __restrict__ x, long long x_bs,
                             const bf16* __restrict__ gx, long long gx_bs,
                             const bf16* __restrict__ gate, long long g_bs,
                             const bf16* __restrict__ ba, const bf16* __restrict__ bx,
                             const bf16* __restrict__ a_param, float* __restrict__ state,
                             const bool* __restrict__ advance, bf16* __restrict__ y, int W) {
  const int c = blockIdx.x * kStepThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= W) return;
  const bf16* row = gx + b * gx_bs + c;
  const float xv = f32(x[b * x_bs + c]), ga = f32(row[0]), gi = f32(row[W]);
  const float gv = f32(gate[b * g_bs + c]);
  float* st = state + (size_t)b * W + c;
  const float h0 = *st;
  const float log_a = __fmul_rn(-kC, softplus(f32(a_param[c])));
  float a, i;
  gates(ga, gi, f32(ba[c]), f32(bx[c]), log_a, &a, &i);
  const float h = step(a, h0, step_input(a, round_bf16(__fmul_rn(xv, i))));
  y[(size_t)b * W + c] = __float2bfloat16(__fmul_rn(h, gelu_f32(gv)));
  if (advance == nullptr || advance[b]) *st = h;
}

}  // namespace

// The prefill scan: see rglru_scan_kernel. Strides in elements. Returns
// the launch's cudaError_t (0 on success).
extern "C" int rglru_scan(const void* x, long long x_bs, long long x_ss, const void* gx,
                          long long gx_bs, long long gx_ss, const void* gate, long long g_bs,
                          long long g_ss, const void* ba, const void* bx, const void* a_param,
                          void* state, void* y, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return cudaErrorInvalidValue;
  const dim3 grid((W + 31) / 32, B);
  rglru_scan_kernel<<<grid, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), x_bs, x_ss, static_cast<const bf16*>(gx), gx_bs, gx_ss,
      static_cast<const bf16*>(gate), g_bs, g_ss, static_cast<const bf16*>(ba),
      static_cast<const bf16*>(bx), static_cast<const bf16*>(a_param),
      static_cast<float*>(state), static_cast<bf16*>(y), S, W);
  return cudaGetLastError();
}

// The decode step: see rglru_decode_step_kernel. Row strides in elements.
// Returns the launch's cudaError_t (0 on success).
extern "C" int rglru_decode_step(const void* x, long long x_bs, const void* gx, long long gx_bs,
                                 const void* gate, long long g_bs, const void* ba,
                                 const void* bx, const void* a_param, void* state,
                                 const void* advance, void* y, int B, int W, void* stream) {
  if (B <= 0 || W <= 0) return cudaErrorInvalidValue;
  const dim3 grid((W + kStepThreads - 1) / kStepThreads, B);
  rglru_decode_step_kernel<<<grid, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), x_bs, static_cast<const bf16*>(gx), gx_bs,
      static_cast<const bf16*>(gate), g_bs, static_cast<const bf16*>(ba),
      static_cast<const bf16*>(bx), static_cast<const bf16*>(a_param),
      static_cast<float*>(state), static_cast<const bool*>(advance), static_cast<bf16*>(y), W);
  return cudaGetLastError();
}
