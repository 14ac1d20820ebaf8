// Tiled GQA prefill attention (flash attention), for sm_90a.
//
// Replaces the JAX package's Pallas kernel
//   src/repro/kernels/flash_attention.py:87  flash_attention (_flash_kernel)
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
// axis and carries (m, l, acc) in VMEM scratch from one grid step to the
// next. CUDA blocks run in parallel and in no order, so nothing can be
// carried between them: each CTA walks its KV tiles in a loop of its
// own, with the online-softmax state in registers. One CTA per (64-query
// tile, batch row, kv head) holds all G query heads of that kv head (one
// warp per 16 query rows of one head, 4 * G warps), so each K/V tile is
// staged through shared memory once for G heads. The loop starts at the
// window's first visible 64-key tile and stops after the causal last
// one: the Pallas block skip, done inside the CTA. Ragged Sq and Skv are
// masked in the kernel (rows past Skv are zeroed in shared memory and
// masked, rows past Sq are not stored), so any Sq >= 1 and Skv >= 1 work.
// Tiles are anchored at position 0 and a row's arithmetic depends only
// on its own query and the keys: the same query position gives the same
// bits whatever Sq, Skv or the batch, so a padded bucket's real rows
// equal the prompt prefilled alone. Both products run on the tensor
// cores with mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (bf16
// in, f32 accumulate); the P tile goes from the score accumulators
// straight into the A operand of the PV product, in registers. Loads are
// plain 16-byte copies, one tile at a time (no TMA, no cp.async
// pipeline, no wgmma): right and simple first.
//
// Numerics follow the model path's chunked_attention: q * scale is
// computed in f32 and rounded to bf16; scores are f32 sums of bf16
// products; masked scores are -1e30 and masked p is 0; p is rounded to
// bf16 for the PV product while l sums the unrounded f32 p; acc / l is
// rounded to bf16 at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;            // query positions per CTA
constexpr int kBK = 64;            // key positions per shared-memory tile
constexpr float kNegInf = -1e30f;
constexpr int kNotInstantiated = -1;  // no kernel for this (D, G)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo = low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 h;
  h.x = lo;
  h.y = hi;
  return *reinterpret_cast<uint32_t*>(&h);
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col). Fragments as
// in the PTX ISA: with gid = lane / 4, tig = lane % 4, a = {(gid, 2tig),
// (gid + 8, 2tig), (gid, 2tig + 8), (gid + 8, 2tig + 8)} (two
// consecutive columns each); b = {(k 2tig, n gid), (k 2tig + 8, n gid)}
// (two consecutive k each); c = {(gid, 2tig), (gid, 2tig + 1),
// (gid + 8, 2tig), (gid + 8, 2tig + 1)}.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage key rows [t0, t0 + kBK) of one (b, kv head) slice into shared
// rows of ROW bf16 (padded: 16-byte aligned, and the fragment reads of
// neighbouring rows land on distinct banks); rows at or past Skv are 0.
template <int D, int ROW, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int t0,
                                          int Skv, int tid) {
  constexpr int kVec = D / 8;      // 8 bf16 per 16-byte vector
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (int i = tid; i < kBK * kVec; i += NT) {
    const int j = i / kVec, c = i % kVec;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (t0 + j < Skv) u = s[(size_t)(t0 + j) * kVec + c];
    reinterpret_cast<uint4*>(dst + j * ROW)[c] = u;
  }
}

// grid: (ceil(Sq / 64), B * Hkv); block: 4 * G warps. Warp w takes query
// head g = w / 4 of the kv head and query rows q0 + (w % 4) * 16 + [0, 16).
template <int D, int G>
__global__ void __launch_bounds__(128 * G)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int Sq, int Skv, int causal, int window, int q_offset,
                       float scale) {
  constexpr int NT = 128 * G;
  constexpr int kRow = D + 8;
  constexpr int KS = D / 16;       // k16 steps over the head dim (QK^T)
  constexpr int NBS = kBK / 8;     // n8 score blocks per key tile
  constexpr int NBO = D / 8;       // n8 output blocks
  __shared__ __align__(16) bf16 ks[kBK * kRow];
  __shared__ __align__(16) bf16 vs[kBK * kRow];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y;                       // b * Hkv + kv head
  const int q0 = blockIdx.x * kBQ;
  const size_t head = (size_t)bh * G + warp / 4;   // b * Hq + query head
  const int row0 = q0 + (warp % 4) * 16 + gid;     // rows row0, row0 + 8
  const int pos[2] = {row0 + q_offset, row0 + 8 + q_offset};

  const bf16* qh = q + head * Sq * D;
  const bf16* kb = k + (size_t)bh * Skv * D;
  const bf16* vb = v + (size_t)bh * Skv * D;

  // this warp's 16 query rows as A fragments: bf16(q * scale), 0 past Sq
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + (r & 1) * 8, col = kk * 16 + tig * 2 + (r >> 1) * 8;
      float x0 = 0.f, x1 = 0.f;
      if (row < Sq) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
            qh + (size_t)row * D + col);
        x0 = __bfloat162float(x.x) * scale;
        x1 = __bfloat162float(x.y) * scale;
      }
      qf[kk][r] = pack_bf16(x0, x1);
    }

  float o[NBO][4];
#pragma unroll
  for (int nb = 0; nb < NBO; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nb][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // the keys any row of this CTA can see (block skip)
  const int qa_lo = q0 + q_offset;
  const int qa_hi = min(q0 + kBQ, Sq) - 1 + q_offset;
  const int k_end = causal ? max(0, min(Skv, qa_hi + 1)) : Skv;
  const int k_lo = window > 0 ? max(0, qa_lo - window + 1) : 0;

  for (int t0 = (k_lo / kBK) * kBK; t0 < k_end; t0 += kBK) {
    __syncthreads();                               // last tile's readers done
    load_tile<D, kRow, NT>(ks, kb, t0, Skv, tid);
    load_tile<D, kRow, NT>(vs, vb, t0, Skv, tid);
    __syncthreads();

    // scores s = q k^T for 16 rows x 64 keys
    float s[NBS][4];
#pragma unroll
    for (int nb = 0; nb < NBS; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
      const bf16* kr = ks + (nb * 8 + gid) * kRow + tig * 2;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[nb], qf[kk], b0, b1);
      }
    }

    // mask, row max over the quad's 4 threads
    uint32_t vis = 0;                              // bit nb * 4 + e
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < NBS; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kpos = t0 + nb * 8 + tig * 2 + (e & 1);
        const bool ok = kpos < Skv && (!causal || kpos <= pos[r]) &&
                        (window <= 0 || kpos > pos[r] - window);
        if (ok) vis |= 1u << (nb * 4 + e);
        s[nb][e] = ok ? s[nb][e] : kNegInf;
        mx[r] = fmaxf(mx[r], s[nb][e]);
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new[r]);
    }

    // p = exp(s - m_new), 0 where masked; l sums the f32 p, the PV
    // product takes bf16(p) straight from these registers
    float sum[2] = {0.f, 0.f};
    uint32_t pf[NBS][2];
#pragma unroll
    for (int nb = 0; nb < NBS; ++nb) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = (vis >> (nb * 4 + e)) & 1u ? expf(s[nb][e] - m_new[e >> 1]) : 0.f;
        sum[e >> 1] += p[e];
      }
      pf[nb][0] = pack_bf16(p[0], p[1]);
      pf[nb][1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
      m[r] = m_new[r];
    }

    // o = o * alpha + bf16(p) v
#pragma unroll
    for (int nb = 0; nb < NBO; ++nb) {
      o[nb][0] *= alpha[0];
      o[nb][1] *= alpha[0];
      o[nb][2] *= alpha[1];
      o[nb][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                             pf[2 * kk + 1][1]};
      const bf16* v0 = vs + (kk * 16 + tig * 2) * kRow + gid;
#pragma unroll
      for (int nb = 0; nb < NBO; ++nb) {
        const bf16* vc = v0 + nb * 8;
        const uint32_t b0 = pack_bf16(vc[0], vc[kRow]);
        const uint32_t b1 = pack_bf16(vc[8 * kRow], vc[9 * kRow]);
        mma_bf16(o[nb], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= Sq) continue;
    const float lr = l[r] == 0.f ? 1.f : l[r];
    bf16* orow = out + (head * Sq + row) * D + tig * 2;
#pragma unroll
    for (int nb = 0; nb < NBO; ++nb) {
      const __nv_bfloat162 y = __floats2bfloat162_rn(
          o[nb][2 * r] / lr, o[nb][2 * r + 1] / lr);
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8) = y;
    }
  }
}

template <int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B,
                   int Hkv, int Sq, int Skv, int causal, int window, int q_offset,
                   float scale, cudaStream_t st) {
  dim3 grid((Sq + kBQ - 1) / kBQ, B * Hkv);
  flash_attention_kernel<D, G><<<grid, 128 * G, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Skv, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, Hkv*G, Sq, D), k and v (B, Hkv, Skv, D), out like q; all bf16,
// contiguous. The (D, G) pairs are those of the configs the port serves:
// llama3.2-1b (64, 4), deepseek-7b (128, 1) and their reduced smoke
// versions (32, 2); a config with another pair adds it here. Returns the
// launch's cudaError_t (0 on success), or -1 when no kernel is
// instantiated for (D, G).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Hkv, int G, int Sq, int Skv,
                               int D, int causal, int window, int q_offset,
                               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 && G == 4)
    return launch<64, 4>(q, k, v, out, B, Hkv, Sq, Skv, causal, window, q_offset, scale, st);
  if (D == 128 && G == 1)
    return launch<128, 1>(q, k, v, out, B, Hkv, Sq, Skv, causal, window, q_offset, scale, st);
  if (D == 32 && G == 2)
    return launch<32, 2>(q, k, v, out, B, Hkv, Sq, Skv, causal, window, q_offset, scale, st);
  return kNotInstantiated;
}
