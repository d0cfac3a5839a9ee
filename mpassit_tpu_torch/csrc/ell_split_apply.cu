// One-hot apply with the operator built from the ELL arrays in the kernel,
// split_bf16 term set, for Hopper (sm_90a): the two kernel-structure
// variants of tools/kernel_variants.py.
//
// Replaces the TPU kernels make_v1.kern and make_v2.kern. For target point
// p of tile t and column c:
//
//     A[r, p]  = sum over k = 0..K-1 (in k order, f32, from 0) of w[t,k,p]
//                where loc[t,k,p] == r,  for the rows r < W
//     out[t, p, c] = sum_r  Ah[r,p] Sh[r,c] + Ah[r,p] Sl[r,c] + Al[r,p] Sh[r,c]
//
// with Ah = bf16_rn(A), Al = bf16_rn(A - Ah) and Sh, Sl the same split of
// slab[t, r, c] (bf16_terms.cuh). A is summed before it is split, as the
// TPU kernel's A + where(iota == loc[k], w[k], 0) does, so duplicate loc
// entries give the TPU's Ah/Al; rows >= W and w = 0 pads add nothing. v1
// (three dots) and v2 (one stacked dot) compute the same terms; here both
// sum them per row in row order, so they agree bit for bit, and differ from
// the plain versions and the TPU only in the order of the f32 sums.
//
// Layouts (threadIdx.x is the column, so slab reads and output writes are
// 512-byte rows; each block serves PB = 32 target points, whose loc/w it
// stages in shared memory, and keeps their 32 sums in registers):
//   v1: one block per (tile, 128 columns, 32 points), as onehot_apply.cu:
//       each 32-row step builds that window of A from loc/w, split, in
//       shared memory (16 KB), and every block builds its own windows.
//   v2: one block per (tile, 32 points) with CC = 128 or 256 threads: the
//       block builds its W-row slice of [Ah; Al] once into shared memory
//       (W * 512 bytes, 40 KB at W = 80) and reuses it for every CC-column
//       chunk of the row. The TPU kernel keeps the whole tile's [Ah; Ah; Al]
//       in VMEM scratch, 4*W KB even without the repeat, more than a block's
//       227 KB at W = 80; splitting the points across blocks keeps the
//       build-once structure without a device-memory scratch.
//
// What bounds both on an H100: f32 FMA issue on the CUDA cores. The
// operator is dense in this formulation (W rows per point, K of them
// nonzero), so the work is n_tiles * 1024 * Cp * W * 3 FMAs: 1.2e11 at the
// CONUS grid, Cp = 512 and the bilinear operator of a 655,362-cell mesh
// (W = 40), 2.4e11 at 2.6M cells (W = 80). Tensor cores (mma.sync / wgmma,
// bf16 in, f32 accumulate: the same exact products) are the natural
// redesign.
//
// No --use_fast_math: subnormal residuals survive. Offsets are 64-bit.

#include "bf16_terms.cuh"

#define TY 32
#define TX 32
#define TILE 1024
#define COLS 128          // v1 columns per block (threadIdx.x)
#define PB 32             // target points per block (sums in registers)
#define WB 32             // v1 A rows per step
#define NPCH (TILE / PB)  // point chunks per tile
#define MAXK 16           // ELL entries per point

// the block's points' loc/w, (K, PB) each, from (n_tiles, K, TILE)
__device__ __forceinline__ void stage_ell(int (&loc_s)[MAXK][PB],
                                          float (&w_s)[MAXK][PB],
                                          const int* __restrict__ loc,
                                          const float* __restrict__ w,
                                          int64_t t, int p0, int K) {
  for (int i = threadIdx.x; i < K * PB; i += blockDim.x) {
    const int k = i / PB, pi = i % PB;
    const int64_t g = (t * K + k) * TILE + p0 + pi;
    loc_s[k][pi] = __ldg(loc + g);
    w_s[k][pi] = __ldg(w + g);
  }
}

// A[r, p0 + pi], split: the weights of the entries naming row r, added in
// k order from 0 with f32 rounding, as the TPU kernel's K one-hot adds
__device__ __forceinline__ float4 a_entry(const int (&loc_s)[MAXK][PB],
                                          const float (&w_s)[MAXK][PB],
                                          int r, int pi, int K) {
  float a = 0.0f;
  for (int k = 0; k < K; ++k)
    if (loc_s[k][pi] == r) a = __fadd_rn(a, w_s[k][pi]);
  return split<1>(a);
}

// the block's 32 sums of column c into the row-major output
__device__ __forceinline__ void store_points(float* __restrict__ out,
                                             const float (&acc)[PB],
                                             int64_t t, int p0, int c,
                                             int ntx, int Cp) {
  const int ty = (int)(t / ntx), tx = (int)(t % ntx);
  const int64_t nxp = (int64_t)ntx * TX;
#pragma unroll
  for (int pi = 0; pi < PB; ++pi) {
    const int p = p0 + pi;
    out[((int64_t)(ty * TY + p / TX) * nxp + (tx * TX + p % TX)) * Cp + c] =
        acc[pi];
  }
}

__global__ void __launch_bounds__(COLS)
ell_split_v1_kernel(const int* __restrict__ loc, const float* __restrict__ w,
                    const float* __restrict__ slab, float* __restrict__ out,
                    int K, int W, int Cp, int ntx) {
  __shared__ float4 a_s[WB][PB];
  __shared__ int loc_s[MAXK][PB];
  __shared__ float w_s[MAXK][PB];
  const int64_t t = blockIdx.x;
  const int c = blockIdx.y * COLS + threadIdx.x;
  const int p0 = blockIdx.z * PB;
  const float* col = slab + t * (int64_t)W * Cp + c;
  stage_ell(loc_s, w_s, loc, w, t, p0, K);

  float acc[PB];
#pragma unroll
  for (int pi = 0; pi < PB; ++pi) acc[pi] = 0.0f;
  for (int w0 = 0; w0 < W; w0 += WB) {
    const int nw = min(WB, W - w0);
    __syncthreads();          // staged loc/w visible; last step's readers done
    for (int i = threadIdx.x; i < WB * PB; i += COLS) {
      const int wi = i / PB, pi = i % PB;
      a_s[wi][pi] = (wi < nw) ? a_entry(loc_s, w_s, w0 + wi, pi, K)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    accumulate<1, PB>(acc, a_s, col + (int64_t)w0 * Cp, nw, Cp);
  }
  store_points(out, acc, t, p0, c, ntx, Cp);
}

template <int CC>
__global__ void __launch_bounds__(CC)
ell_split_v2_kernel(const int* __restrict__ loc, const float* __restrict__ w,
                    const float* __restrict__ slab, float* __restrict__ out,
                    int K, int W, int Cp, int ntx) {
  extern __shared__ float4 a_dyn[];            // (W, PB): [Ah; Al] slice
  float4 (*a_s)[PB] = reinterpret_cast<float4 (*)[PB]>(a_dyn);
  __shared__ int loc_s[MAXK][PB];
  __shared__ float w_s[MAXK][PB];
  const int64_t t = blockIdx.x;
  const int p0 = blockIdx.y * PB;
  stage_ell(loc_s, w_s, loc, w, t, p0, K);
  __syncthreads();
  for (int i = threadIdx.x; i < W * PB; i += CC) {
    const int wi = i / PB, pi = i % PB;
    a_s[wi][pi] = a_entry(loc_s, w_s, wi, pi, K);
  }
  __syncthreads();

  const float* slab_t = slab + t * (int64_t)W * Cp;
  for (int c0 = 0; c0 < Cp; c0 += CC) {
    const int c = c0 + threadIdx.x;
    float acc[PB];
#pragma unroll
    for (int pi = 0; pi < PB; ++pi) acc[pi] = 0.0f;
    accumulate<1, PB>(acc, a_s, slab_t + c, W, Cp);
    store_points(out, acc, t, p0, c, ntx, Cp);
  }
}

static bool args_ok(int n_tiles, int K, int W, int Cp, int cols) {
  return n_tiles >= 1 && K >= 1 && K <= MAXK && W >= 1 && Cp >= cols &&
         Cp % cols == 0;
}

// loc (n_tiles, K, 1024) int32, w likewise f32, slab (n_tiles, W, Cp) f32,
// out (nty*32, ntx*32, Cp) f32. Each returns 0, a cudaError_t from the
// launch, or -1 for arguments the kernel does not take. They launch on
// `stream`, do not synchronise and allocate nothing.
extern "C" int ell_split_v1_launch(const int* loc, const float* w,
                                   const float* slab, float* out,
                                   int n_tiles, int ntx, int K, int W, int Cp,
                                   void* stream) {
  if (!args_ok(n_tiles, K, W, Cp, COLS)) return -1;
  dim3 grid(n_tiles, Cp / COLS, NPCH);
  ell_split_v1_kernel<<<grid, COLS, 0, static_cast<cudaStream_t>(stream)>>>(
      loc, w, slab, out, K, W, Cp, ntx);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : (int)err;
}

template <int CC>
static int v2_launch(const int* loc, const float* w, const float* slab,
                     float* out, int n_tiles, int ntx, int K, int W, int Cp,
                     cudaStream_t s) {
  const size_t smem = (size_t)W * PB * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      ell_split_v2_kernel<CC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, NPCH);
  ell_split_v2_kernel<CC><<<grid, CC, smem, s>>>(loc, w, slab, out, K, W,
                                                 Cp, ntx);
  err = cudaGetLastError();
  return err == cudaSuccess ? 0 : (int)err;
}

// CC: 128 or 256 columns per chunk; W * 512 bytes of dynamic shared memory
extern "C" int ell_split_v2_launch(const int* loc, const float* w,
                                   const float* slab, float* out,
                                   int n_tiles, int ntx, int K, int W, int Cp,
                                   int CC, void* stream) {
  if ((CC != 128 && CC != 256) || !args_ok(n_tiles, K, W, Cp, CC)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (CC == 128)
    return v2_launch<128>(loc, w, slab, out, n_tiles, ntx, K, W, Cp, s);
  return v2_launch<256>(loc, w, slab, out, n_tiles, ntx, K, W, Cp, s);
}
