// The bf16 operand split of the TPU's one-hot kernels, shared by
// onehot_apply.cu (kernels for fused_apply and the prestacked-A
// fused_apply_packed) and ell_split_apply.cu (the one-hot A built from the
// ELL arrays in the kernel), so the split cannot drift between them:
//
//     b0 = bf16_rn(x), b1 = bf16_rn(x - b0), b2 = bf16_rn(x - b0 - b1)
//
// (hi = b0, lo = b1), as matmul_apply._split_hilo/_split_3way round. Both
// kernels multiply the parts on the tensor cores: a product of two bf16
// values is exact in f32, so only the order of the f32 sums differs from
// the TPU's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the parts of two values at once, PREC + 1 of them (1: hi, lo; 2: b0, b1,
// b2): part i of (x0, x1) as a bf16 pair in p[i], x0 at the lower address
template <int PREC>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&p)[PREC + 1]) {
  const __nv_bfloat162 b0 = __floats2bfloat162_rn(x0, x1);
  const float2 f0 = __bfloat1622float2(b0);
  const float r0 = __fsub_rn(x0, f0.x), r1 = __fsub_rn(x1, f0.y);
  const __nv_bfloat162 b1 = __floats2bfloat162_rn(r0, r1);
  p[0] = *reinterpret_cast<const uint32_t*>(&b0);
  p[1] = *reinterpret_cast<const uint32_t*>(&b1);
  if constexpr (PREC == 2) {
    const float2 f1 = __bfloat1622float2(b1);
    const __nv_bfloat162 b2 =
        __floats2bfloat162_rn(__fsub_rn(r0, f1.x), __fsub_rn(r1, f1.y));
    p[2] = *reinterpret_cast<const uint32_t*>(&b2);
  }
}
