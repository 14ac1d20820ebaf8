// The f32 helpers that fused_ops.cu (geglu_kernel), quant_matmul.cu (the
// GeGLU epilogue) and rglru.cu (the gelu-gated output) share, so that the
// three compute the JAX gelu bit for bit alike. kernels/build.py hashes
// this header into each library's name, so an edit rebuilds all three.
#pragma once

#include <cuda_bf16.h>

// v rounded to bf16 and back
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The JAX layers.gelu in f32: the tanh approximation with tanh written as
// 2 sigmoid(2z) - 1, op for op as kernels/fused_ops.py::gelu (the _rn
// intrinsics keep nvcc from contracting a product and a sum)
__device__ __forceinline__ float gelu_f32(float x) {
  const float c = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float z = __fmul_rn(0.7978845608028654f, __fadd_rn(x, c));
  const float sg = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(2.f, z))));
  const float t = __fsub_rn(__fmul_rn(2.f, sg), 1.f);
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, t));
}
