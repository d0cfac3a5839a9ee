// Store-only probe for Hopper (sm_90a): the device-memory write ceiling at
// an apply's output shape.
//
// Replaces the TPU kernel bench.py::make_write_wall (body kern): every row
// of the (nty*32, ntx*32, Cp) f32 output equals the seed row seed[0, 0, :].
// Zero compute and one read of the seed row per thread, so its time is the
// least a kernel that writes this output can take on the card, the roofline
// an apply kernel (packed_apply.cu) is judged against.
//
// What bounds it: device-memory writes, 8.1 GB at the packed CONUS shape
// (1088 x 1824 x 1024 f32). The design keeps the store stream as wide as
// the card takes it: 16-byte stores, a warp writing 512 contiguous bytes,
// each block a contiguous span of whole output rows, and the grid covering
// the output exactly once. Offsets are 64-bit: the packed CONUS output has
// 2.03e9 elements, within 5% of 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256       // threads per block
#define ROW_STEPS 16      // rows each thread writes per column it owns

// threadIdx.x: a float4 column of the row (strided by blockDim.x when a row
// holds more than THREADS of them); threadIdx.y: a row lane of the block's
// span [r0, r1)
__global__ void __launch_bounds__(THREADS)
write_wall_kernel(const float4* __restrict__ seed, float4* __restrict__ out,
                  int64_t n_rows, int row4, int rows_per_block) {
  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < n_rows ? r0 + rows_per_block
                                                  : n_rows;
  for (int c = threadIdx.x; c < row4; c += blockDim.x) {
    const float4 v = __ldg(seed + c);
    for (int64_t r = r0 + threadIdx.y; r < r1; r += blockDim.y)
      out[r * row4 + c] = v;
  }
}

// seed: Cp floats; out: n_rows * Cp floats, both 16-byte aligned. Returns
// 0, a cudaError_t from the launch, or -1 for arguments the kernel does not
// take. Launches on `stream`; does not synchronise and allocates nothing.
extern "C" int write_wall_launch(const float* seed, float* out,
                                 long long n_rows, int Cp, void* stream) {
  if (n_rows < 1 || Cp < 4 || Cp % 4 != 0 ||
      ((uintptr_t)seed | (uintptr_t)out) % 16 != 0)
    return -1;
  const int row4 = Cp / 4;
  const int bx = row4 < THREADS ? row4 : THREADS;
  const int by = THREADS / bx;
  const int rows_per_block = by * ROW_STEPS;
  const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return -1;
  write_wall_kernel<<<(unsigned)blocks, dim3(bx, by), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(seed), reinterpret_cast<float4*>(out),
      (int64_t)n_rows, row4, rows_per_block);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : (int)err;
}
