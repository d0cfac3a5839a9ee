// The bf16 term sets of the TPU's one-hot kernels, shared by
// onehot_apply.cu (kernels for fused_apply and the prestacked-A
// fused_apply_packed) and ell_split_apply.cu (the one-hot A built from the
// ELL arrays in the kernel), so the split cannot drift between them.
//
//     highest:     a s                                     (f32)
//     split_bf16:  ah sh + ah sl + al sh
//     split6_bf16: a0 s0 + a0 s1 + a1 s0 + a0 s2 + a1 s1 + a2 s0
//
// with b0 = bf16_rn(x), b1 = bf16_rn(x - b0), b2 = bf16_rn(x - b0 - b1)
// (hi = b0, lo = b1), as matmul_apply._split_hilo/_split_3way round. A
// product of two bf16 values is exact in f32, so each FMA rounds its term
// exactly as the MXU's multiply and f32 add do; only the order of the f32
// sums differs from the TPU's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x -> its parts for precision PREC (0 highest, 1 split_bf16, 2 split6_bf16)
template <int PREC>
__device__ __forceinline__ float4 split(float x) {
  if (PREC == 0) return make_float4(x, 0.0f, 0.0f, 0.0f);
  const float b0 = bf16_rn(x);
  const float r1 = __fsub_rn(x, b0);
  const float b1 = bf16_rn(r1);
  if (PREC == 1) return make_float4(b0, b1, 0.0f, 0.0f);
  return make_float4(b0, b1, bf16_rn(__fsub_rn(r1, b1)), 0.0f);
}

// acc + the term set of PREC for one contraction row, in the TPU stack order
template <int PREC>
__device__ __forceinline__ float terms(float acc, const float4& a,
                                       const float4& s) {
  if (PREC == 0) return __fmaf_rn(a.x, s.x, acc);
  acc = __fmaf_rn(a.x, s.x, acc);
  acc = __fmaf_rn(a.x, s.y, acc);
  acc = __fmaf_rn(a.y, s.x, acc);
  if (PREC == 2) {
    acc = __fmaf_rn(a.x, s.z, acc);
    acc = __fmaf_rn(a.y, s.y, acc);
    acc = __fmaf_rn(a.z, s.x, acc);
  }
  return acc;
}

// acc[p] += terms(a_s[w][p], split(col[w * Cp])) for the rows w < nw, in
// row order: a_s holds one window of the operator, already split, for NP
// target points; col is this thread's slab column at the window's first row
template <int PREC, int NP>
__device__ __forceinline__ void accumulate(float (&acc)[NP],
                                           const float4 (*a_s)[NP],
                                           const float* __restrict__ col,
                                           int nw, int Cp) {
  for (int wi = 0; wi < nw; ++wi) {
    const float4 s = split<PREC>(__ldg(col + (int64_t)wi * Cp));
#pragma unroll
    for (int pi = 0; pi < NP; ++pi) acc[pi] = terms<PREC>(acc[pi], a_s[wi][pi], s);
  }
}
