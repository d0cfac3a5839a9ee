// Ampere/Hopper asynchronous global -> shared copies (cp.async), shared by
// ell_apply.cuh and ell_split_apply.cu: 16-byte copies with zero fill,
// grouped so a thread can wait for all but its N most recent groups.

#pragma once

#include <cuda_runtime.h>

// 16 bytes from src to dst, or 16 zero bytes when n == 0 (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of every group but the N most recent have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
