// W8A16 / W4A16 groupwise dequant GEMV/GEMM, for sm_90a.
//
// Replaces the JAX package's Pallas kernel
//   src/repro/kernels/quant_matmul.py  quant_matmul (_qmm_kernel,
//   _dequant_block_q8 / _dequant_block_q4)
// out (M, N) = x (M, K) @ dequant(w), with w stored (K, N), N contiguous:
// q8_0 int8 (K, N) or q4_0 nibble-packed int8 (K/2, N) (low nibble = even
// k), bf16 scales (K/group, N).
//
// Bound: at decode M (1..8 slots) the weight bytes, K*N*(1 + 2/32) for
// q8_0 and K*N*(0.5 + 2/32) for q4_0, over the card's memory rate; the
// work is 2*M FLOPs per weight, far below the tensor-core line. Design
// against that bound: consecutive threads take consecutive groups of 4
// columns, so each weight row is read coalesced (4 bytes a thread) and
// exactly once per M tile; each group's 4 scales are read once per 32
// rows; x is staged through shared memory a K tile at a time (x for
// M = 8, K = 8192 does not fit whole).
//
// K is cut into chunks of k_per_split rows, planned from (K, N, group,
// SM count) alone, never from M. At decode M (one M tile) the chunks go
// to separate CTAs (grid.y), so enough of them stream at N = 2048: each
// writes f32 partial sums and a second kernel adds them in chunk order.
// At larger M the grid fills the card without a split: one CTA per (N
// block, M tile) walks the chunks itself, sums each into its own f32
// partial and adds the partials to a running sum in chunk order. Both
// routes compute s = 0; s += partial[chunk] in the same order, so an
// output row does not depend on how many rows share the call (a
// prompt prefilled alone and inside a padded bucket round alike).
// At prefill M the kernel is bound by its arithmetic on the CUDA cores
// (2*M*K*N FLOPs in f32 FMAs, with the dequant redone per M tile); a
// tensor-core GEMM for prefill M is later work.
//
// Numerics follow the Pallas kernel: each weight is dequantized in f32
// and rounded to bf16, bf16(float(q) * float(scale)); products with the
// bf16 activations accumulate in f32, one explicit fused multiply-add per
// product in k order, so every M-tile instantiation sums a row alike;
// the sum is cast to out_dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kCols = 4;                          // columns per thread
constexpr int kColThreads = 64;                   // threads across N
constexpr int kRowGroups = 4;                     // threads across K
constexpr int kThreads = kColThreads * kRowGroups;
constexpr int kBlockN = kColThreads * kCols;      // 256 columns per CTA
constexpr int kXTile = 512;                       // max K rows of x per stage

enum Fmt { kQ8 = 0, kQ4 = 1 };

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(void* out, size_t i, float v, int out_f32) {
  if (out_f32) static_cast<float*>(out)[i] = v;
  else static_cast<bf16*>(out)[i] = __float2bfloat16(v);
}

// Load the 4 int8 bytes of one payload row for this thread's columns.
template <bool VEC>
__device__ __forceinline__ void load_row(const int8_t* row, int n0, int N,
                                         int8_t q[kCols]) {
  if (VEC) {
    // N % 4 == 0: the thread's 4 columns are all in range or all out
    const uint32_t u = n0 < N ? *reinterpret_cast<const uint32_t*>(row + n0) : 0u;
#pragma unroll
    for (int c = 0; c < kCols; ++c) q[c] = (int8_t)(u >> (8 * c));
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) q[c] = n0 + c < N ? row[n0 + c] : 0;
  }
}

// grid: (ceil(N / 256), ctas along K, ceil(M / MT)). CTA y reduces the
// K chunks [y * cta_chunks, (y + 1) * cta_chunks), each of k_per_split
// rows, for 256 columns and MT rows of x; its row groups take whole
// quantization groups of a chunk round-robin.
template <int FMT, bool VEC, int MT>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                    const bf16* __restrict__ scales, void* __restrict__ out,
                    float* __restrict__ partial, int out_f32, int M, int K, int N,
                    int group, int k_per_split, int cta_chunks, int x_tile) {
  __shared__ float xs[MT * kXTile];
  __shared__ float red[MT * kBlockN];

  const int tid = threadIdx.x;
  const int ct = tid % kColThreads, rg = tid / kColThreads;
  const int n0 = blockIdx.x * kBlockN + ct * kCols;
  const int m0 = blockIdx.z * MT;
  const int mt = min(MT, M - m0);

  // this thread's outputs i = tid + j * kThreads of the CTA's MT x 256
  // block: the running sum over chunks, in chunk order
  float run[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) run[j] = 0.f;

  const int chunk0 = blockIdx.y * cta_chunks;
  for (int ch = chunk0; ch < chunk0 + cta_chunks; ++ch) {
    const int k_begin = ch * k_per_split;
    if (k_begin >= K) break;
    const int k_end = min(K, k_begin + k_per_split);

    float acc[MT][kCols];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

    for (int kt = k_begin; kt < k_end; kt += x_tile) {
      const int kn = min(x_tile, k_end - kt);
      __syncthreads();
      for (int i = tid; i < MT * kn; i += kThreads) {
        const int m = i / kn, kk = i % kn;
        xs[m * x_tile + kk] = m < mt ? __bfloat162float(x[(size_t)(m0 + m) * K + kt + kk]) : 0.f;
      }
      __syncthreads();

      for (int gi = rg; gi * group < kn; gi += kRowGroups) {
        const int kg = kt + gi * group;             // first k of this group
        float sc[kCols];
        const bf16* srow = scales + (size_t)(kg / group) * N;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          sc[c] = n0 + c < N ? __bfloat162float(srow[n0 + c]) : 0.f;
        const float* xg = xs + (kg - kt);
        if (FMT == kQ8) {
          for (int r = 0; r < group; ++r) {
            int8_t q[kCols];
            load_row<VEC>(w + (size_t)(kg + r) * N, n0, N, q);
            float wv[kCols];
#pragma unroll
            for (int c = 0; c < kCols; ++c) wv[c] = round_bf16((float)q[c] * sc[c]);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float xv = xg[m * x_tile + r];
#pragma unroll
              for (int c = 0; c < kCols; ++c) acc[m][c] = __fmaf_rn(xv, wv[c], acc[m][c]);
            }
          }
        } else {
          for (int r = 0; r < group; r += 2) {
            int8_t q[kCols];
            load_row<VEC>(w + (size_t)((kg + r) / 2) * N, n0, N, q);
            float wlo[kCols], whi[kCols];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              const uint32_t b = (uint8_t)q[c];
              const int lo = ((int)(b << 28)) >> 28;  // even k, sign-extended
              const int hi = ((int)(b << 24)) >> 28;  // odd k
              wlo[c] = round_bf16((float)lo * sc[c]);
              whi[c] = round_bf16((float)hi * sc[c]);
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float x0 = xg[m * x_tile + r], x1 = xg[m * x_tile + r + 1];
#pragma unroll
              for (int c = 0; c < kCols; ++c)
                acc[m][c] = __fmaf_rn(x1, whi[c], __fmaf_rn(x0, wlo[c], acc[m][c]));
            }
          }
        }
      }
    }

    // the chunk's partial: the row groups' sums added in a fixed order
    for (int r = 0; r < kRowGroups; ++r) {
      if (rg == r) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            float* dst = red + m * kBlockN + ct * kCols + c;
            *dst = (r == 0 ? 0.f : *dst) + acc[m][c];
          }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < MT; ++j) run[j] += red[tid + j * kThreads];
    __syncthreads();                              // red is rewritten next chunk
  }

#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int i = tid + j * kThreads;
    const int m = i / kBlockN, n = blockIdx.x * kBlockN + i % kBlockN;
    if (m >= mt || n >= N) continue;
    if (gridDim.y == 1) store(out, (size_t)(m0 + m) * N + n, run[j], out_f32);
    else partial[((size_t)blockIdx.y * M + m0 + m) * N + n] = run[j];
  }
}

__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  void* __restrict__ out, int out_f32, int splits,
                                  int MN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[(size_t)p * MN + i];
  store(out, i, s, out_f32);
}

constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// x rows per CTA (the kernel's MT) for a given M
constexpr int m_tile(int M) { return M <= 1 ? 1 : (M <= 4 ? 4 : 8); }

bool takes_group(int K, int group) {
  return group > 0 && group % 2 == 0 && group <= kXTile && K % group == 0;
}

struct Plan {
  int chunks, k_per_split;   // K cut into `chunks` runs of k_per_split rows
  int ctas;                  // CTAs along K (grid.y): chunks at decode M, else 1
};

// The K chunks: aim at two CTAs per SM of the current device for one M
// tile, each chunk a whole multiple of kRowGroups quantization groups
// where K has that many. The chunks depend on (K, N, group, SM count)
// only; M decides just whether they go to separate CTAs (one M tile, so
// the grid needs the split to fill the card) or are walked inside one.
Plan split_plan(int M, int K, int N, int group) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int groups = K / group;
  const int want = std::max(1, std::min(groups, ceil_div(2 * sms, ceil_div(N, kBlockN))));
  int per = std::max(1, ceil_div(groups, want));
  if (per > kRowGroups) per = ceil_div(per, kRowGroups) * kRowGroups;
  const int k_per_split = per * group;
  const int chunks = std::max(1, ceil_div(K, k_per_split));
  const bool one_m_tile = ceil_div(M, m_tile(M)) == 1;
  return {chunks, k_per_split, one_m_tile ? chunks : 1};
}

template <int FMT, bool VEC, int MT>
cudaError_t launch(const void* x, const void* w, const void* scales, void* out,
                   float* partial, int out_f32, int M, int K, int N, int group,
                   Plan plan, cudaStream_t st) {
  const int x_tile = (kXTile / group) * group;
  dim3 grid(ceil_div(N, kBlockN), plan.ctas, ceil_div(M, MT));
  quant_matmul_kernel<FMT, VEC, MT><<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
      static_cast<const bf16*>(scales), out, partial, out_f32, M, K, N, group,
      plan.k_per_split, plan.chunks / plan.ctas, x_tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || plan.ctas == 1) return err;
  const int MN = M * N;
  sum_splits_kernel<<<ceil_div(MN, 256), 256, 0, st>>>(partial, out, out_f32,
                                                       plan.ctas, MN);
  return cudaGetLastError();
}

template <int FMT, bool VEC>
cudaError_t dispatch_m(const void* x, const void* w, const void* scales, void* out,
                       float* partial, int out_f32, int M, int K, int N, int group,
                       Plan plan, cudaStream_t st) {
  switch (m_tile(M)) {
    case 1: return launch<FMT, VEC, 1>(x, w, scales, out, partial, out_f32, M, K, N, group, plan, st);
    case 4: return launch<FMT, VEC, 4>(x, w, scales, out, partial, out_f32, M, K, N, group, plan, st);
  }
  return launch<FMT, VEC, 8>(x, w, scales, out, partial, out_f32, M, K, N, group, plan, st);
}

}  // namespace

// The f32 scratch (in elements) that quant_matmul needs for its split-K
// partial sums at this shape on the current device: 0 unless K is split
// across CTAs (decode M), -1 when the kernel does not take this group
// (it takes an even group <= 512 that divides K).
extern "C" int quant_matmul_workspace(int M, int K, int N, int group) {
  if (!takes_group(K, group)) return -1;
  const Plan plan = split_plan(M, K, N, group);
  return plan.ctas > 1 ? plan.ctas * M * N : 0;
}

// fmt: 0 = q8_0, 1 = q4_0. x (M, K) bf16; w int8 (K, N) / (K/2, N); scales
// (K/group, N) bf16; out (M, N) bf16 or f32 (out_f32); partial: f32
// scratch of partial_elems >= quant_matmul_workspace(M, K, N, group).
// Returns the first failing launch's cudaError_t (0 on success).
extern "C" int quant_matmul(int fmt, const void* x, const void* w,
                            const void* scales, void* out, void* partial,
                            int partial_elems, int out_f32, int M, int K, int N,
                            int group, void* stream) {
  if (!takes_group(K, group)) return cudaErrorInvalidValue;
  const Plan plan = split_plan(M, K, N, group);
  if (plan.ctas > 1 && partial_elems < plan.ctas * M * N) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  // 4-byte column loads need N % 4 == 0 (rows then stay 4-byte aligned)
  const bool vec = N % kCols == 0;
  if (fmt == kQ8) {
    return vec ? dispatch_m<kQ8, true>(x, w, scales, out, part, out_f32, M, K, N, group, plan, st)
               : dispatch_m<kQ8, false>(x, w, scales, out, part, out_f32, M, K, N, group, plan, st);
  }
  if (fmt == kQ4) {
    return vec ? dispatch_m<kQ4, true>(x, w, scales, out, part, out_f32, M, K, N, group, plan, st)
               : dispatch_m<kQ4, false>(x, w, scales, out, part, out_f32, M, K, N, group, plan, st);
  }
  return cudaErrorInvalidValue;
}
