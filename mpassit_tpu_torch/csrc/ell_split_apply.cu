// One-hot apply with the operator built from the ELL arrays in the kernel,
// split_bf16 term set, for Hopper (sm_90a) on the tensor cores: the two
// kernel-structure variants of tools/kernel_variants.py.
//
// Replaces the TPU kernels make_v1.kern (tools/kernel_variants.py:34) and
// make_v2.kern (:85). For target point p of tile t and column c:
//
//     A[r, p]  = sum over k = 0..K-1 (in k order, f32, from 0) of w[t,k,p]
//                where loc[t,k,p] == r,  for the rows 0 <= r < W
//     out[t, p, c] = sum_r  Ah[r,p] Sh[r,c] + Ah[r,p] Sl[r,c] + Al[r,p] Sh[r,c]
//
// with Ah = bf16_rn(A), Al = bf16_rn(A - Ah) and Sh, Sl the same split of
// slab[t, r, c]. A is summed before it is split, as the TPU kernel's
// A + where(iota == loc[k], w[k], 0) does, so duplicate loc entries give
// the TPU's Ah/Al; entries outside [0, W) add nothing.
//
// Design. A block covers 64 target points of one tile and COLS = 128 or
// 256 columns: one warpgroup per 128 columns, each a wgmma m64n128k16 tile
// (bf16 operands, f32 accumulation; onehot_mma.cuh, as onehot_apply.cu),
// over K = W padded to a multiple of 16 in 32-row steps (rows >= W are
// zeros in both operands, never loaded). The terms sum in two register
// accumulators, Ah Sh in one and Ah Sl + Al Sh in the other, added once
// (IEEE) in the epilogue: the tensor cores add with truncation, and one
// accumulator for all terms cost up to 1.2e-6 of max|plain| in
// onehot_apply.cu.
//
// A never exists in device memory. A block stages its points' loc/w
// (K x 64 x 8 bytes) in shared memory, zeroes its bf16 A parts and
// scatters into them: the thread of (point, piece of rows) sums the weights
// of each distinct row it owns, in k order (__fadd_rn), splits the sum once
// and stores the two bf16 parts (K scattered 2-byte stores per part,
// against W x K compares per point in the CUDA-core design this replaces).
// Zeroing and scatter of a row are done by the same thread, so only the
// fence.proxy.async + __syncthreads before the wgmma orders them for the
// tensor cores. The slab streams through a ring of STAGES f32 steps filled
// by 16-byte cp.async two steps ahead (zero-filled past W), and each step
// is split once (split_pair of bf16_terms.cuh) into a double-buffered ring
// of bf16 parts that the wgmma read.
//
// Operand layout (both K-major, no swizzle): a bf16 part is a sequence of
// k16 chunks, each (rows / 8) core matrices of 8 rows x 16 bytes by 2
// along K, LBO = 128 and SBO = 256 (chunk_off): a point's entry for row r
// of a chunk lies at chunk_off(p, r & 15).
//
//   v1: one block per (tile, 128-column chunk, 64-point strip), strips
//       fastest: each 32-row step builds that window of A from the staged
//       loc/w into the ring beside the slab step, so every block builds its
//       own windows, as the TPU v1 builds A per grid step.
//   v2: one block per (tile, 64-point strip): the block builds [Ah; Al] for
//       all K rows once into shared memory (64 x K x 4 bytes) and reuses it
//       for every CC-column chunk of the row; only the slab streams, and
//       the next chunk's first steps are in flight during an epilogue.
//       CC = 128: one warpgroup; CC = 256: two, each a 128-column half of
//       the chunk over the same A operand (m64n256 would need 2 x 128
//       accumulator registers a thread).
// Every output element is one warpgroup's product of the same 64-point M
// tile and 128-column N tile over the same k16 chunks in the same order
// into the same two accumulators in both variants, so v1 and v2 (each CC)
// agree bit for bit.
//
// Epilogue: the f32 tile is staged in shared memory (over the bf16 ring)
// and each point's 128-column spans are written as 512 contiguous bytes
// with 16-byte stores. No rotation, no checksum. Offsets are 64-bit.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s dense bf16): at the
// smoke shape (bilinear operator of a 655,362-cell mesh, 1938 tiles,
// W = 40, K = 3, Cp = 512) the output write, 4.06 GB, with 159 MB of slab
// and 48 MB of loc/w: >= 1.26 ms; the three products over K = 48 are
// 2.9e11 FLOP, >= 0.30 ms. Measured there on random operands
// (NVIDIA H100 80GB HBM3, 700.00 W): v1 3.47-3.53 ms, v2 2.29-2.32
// (CC 128) and 3.17-3.28 (CC 256), torch.sparse.mm 4.48, the store-only
// write wall 1.28-1.30; the CUDA-core design before it 9.41-9.52 and
// 12.50-12.78. Neither floor binds: built without the output stores, the
// products or the slab loads, v2 at CC 128 still took 2.32, 1.96 and
// 2.16 ms, so its time is each 32-row
// step's serial chain (two barriers, the split through shared memory, the
// wgmma wait) at two 128-thread blocks per SM (190 registers, 96 KB);
// v1 runs that chain in 4x as many blocks, each building its A windows.
//
// No --use_fast_math.

#include <climits>

#include "bf16_terms.cuh"
#include "cp_async.cuh"
#include "onehot_mma.cuh"

#define TY 32
#define TX 32
#define TILE 1024
#define PTS 64            // target points per block: the wgmma M
#define KS 32             // operator rows per pipeline step
#define STAGES 3          // f32 slab steps in flight (the cp.async ring)
#define MAXK 16           // ELL entries per point
#define LBO 128           // descriptor: core matrices adjacent in K
#define SBO 256           // ... adjacent in M (points) or N (columns)
#define EXTRA 8           // row padding (floats) of the staged f32 tile
#define SMEM_MAX 232448
#define A_CHUNK (PTS * 32)  // one k16 chunk of one bf16 part of A

// byte offset of (row r of the operand, K index k of the chunk) in one k16
// chunk of a bf16 part: core matrix (r / 8, k / 8), row r % 8
__host__ __device__ constexpr int chunk_off(int r, int k) {
  return ((r >> 3) * 2 + ((k >> 3) & 1)) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

__host__ __device__ constexpr int cmax(int a, int b) {
  return a > b ? a : b;
}

// the geometry of a block of 64 points x COLS columns
template <int COLS>
struct Geo {
  static constexpr int THREADS = COLS;           // a warpgroup a 128 columns
  static constexpr int S_CHUNK = COLS * 32;      // k16 chunk of a slab part
  static constexpr int S_STEP = 2 * 2 * S_CHUNK; // slab step, both parts
  static constexpr int F_STEP = KS * COLS * 4;   // slab step, f32 stage
  static constexpr int PIECE = KS * PTS / THREADS;  // A rows a build thread
  static constexpr int EP = COLS + EXTRA;        // staged tile row stride
  static constexpr int E_BYTES = PTS * EP * 4;
};

// dynamic shared memory: v1 a ring of two A-and-slab steps (or the staged
// tile), the f32 stages, loc/w; v2 both A parts for all K rows, the f32
// stages, then a ring of two slab steps, the staged tile or loc/w
static int v1_smem(int K) {
  using G = Geo<128>;
  return cmax(2 * (2 * 2 * A_CHUNK + G::S_STEP), G::E_BYTES) +
         STAGES * G::F_STEP + K * PTS * 8;
}
template <int COLS>
static int v2_smem(int K, int Kpad) {
  using G = Geo<COLS>;
  return 2 * (Kpad / 16) * A_CHUNK + STAGES * G::F_STEP +
         cmax(cmax(2 * G::S_STEP, G::E_BYTES), K * PTS * 8);
}

// the block's points' loc/w, (K, PTS) each, from (n_tiles, K, TILE)
template <int COLS>
__device__ __forceinline__ void stage_ell(int* loc_s, float* w_s,
                                          const int* __restrict__ loc,
                                          const float* __restrict__ w,
                                          int64_t t, int p0, int K) {
  for (int i = threadIdx.x; i < K * PTS / 4; i += Geo<COLS>::THREADS) {
    const int k = i / (PTS / 4), q = i % (PTS / 4);
    const int64_t g = ((t * K + k) * TILE + p0) / 4 + q;
    reinterpret_cast<int4*>(loc_s)[i] =
        __ldg(reinterpret_cast<const int4*>(loc) + g);
    reinterpret_cast<float4*>(w_s)[i] =
        __ldg(reinterpret_cast<const float4*>(w) + g);
  }
}

// This thread's share (point p = tid % 64, the piece q = tid / 64 of every
// 32-row window) of the split operator rows [klo, khi) (klo a multiple of
// 32, khi of 16) in the part buffer `a` (Ah at a, Al at a + apart; chunk 0
// holds rows klo..): zero the pieces, then for each distinct row l of the
// point's entries that falls in them, sum its weights in k order and store
// the two parts.
template <int COLS>
__device__ __forceinline__ void build_a(uint8_t* a, int apart,
                                        const int* loc_s, const float* w_s,
                                        int K, int W, int klo, int khi) {
  constexpr int PIECE = Geo<COLS>::PIECE;
  const int p = threadIdx.x % PTS, q = threadIdx.x / PTS;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int r0 = klo + q * PIECE; r0 < khi; r0 += KS) {
#pragma unroll
    for (int g = 0; g < PIECE; g += 8) {
      const int r = r0 + g - klo;
      const int off = (r >> 4) * A_CHUNK + chunk_off(p, r & 15);
      *reinterpret_cast<uint4*>(a + off) = zero;
      *reinterpret_cast<uint4*>(a + apart + off) = zero;
    }
  }
  for (int k = 0; k < K; ++k) {
    const int l = loc_s[k * PTS + p];
    if (l < klo || l >= khi || l >= W || (l & (KS - 1)) / PIECE != q)
      continue;
    bool first = true;
    for (int j = 0; j < k; ++j) first &= loc_s[j * PTS + p] != l;
    if (!first) continue;
    float s = 0.0f;
    for (int j = k; j < K; ++j)
      if (loc_s[j * PTS + p] == l) s = __fadd_rn(s, w_s[j * PTS + p]);
    const float hi = bf16_rn(s), lo = bf16_rn(__fsub_rn(s, hi));
    const int r = l - klo;
    const int off = (r >> 4) * A_CHUNK + chunk_off(p, r & 15);
    *reinterpret_cast<__nv_bfloat16*>(a + off) = __float2bfloat16_rn(hi);
    *reinterpret_cast<__nv_bfloat16*>(a + apart + off) =
        __float2bfloat16_rn(lo);
  }
}

// rows k0..k0+31 of the block's columns (`src`: their column 0, row 0 of
// the tile's slab) into the f32 stage F (32 x COLS) by 16-byte cp.async;
// rows >= W are zero-filled, never read
template <int COLS>
__device__ __forceinline__ void fetch_step(float* F, const float* src,
                                           int k0, int W, int Cp) {
  constexpr int PIECES = COLS / 4;   // 16-byte pieces of a row
  for (int i = threadIdx.x; i < KS * PIECES; i += Geo<COLS>::THREADS) {
    const int r = i / PIECES, c4 = i % PIECES;
    const bool in = k0 + r < W;
    cp_async16(F + r * COLS + 4 * c4,
               in ? src + (int64_t)(k0 + r) * Cp + 4 * c4 : src, in ? 16 : 0);
  }
}

// this thread's column of the f32 stage F, split, into the step's slab
// buffer `s` (Sh chunks 0, 1 then Sl chunks 0, 1)
template <int COLS>
__device__ __forceinline__ void split_slab(uint8_t* s, const float* F) {
  const int cl = threadIdx.x;
#pragma unroll
  for (int g = 0; g < KS / 8; ++g) {
    uint32_t w[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_pair<1>(F[(8 * g + 2 * i) * COLS + cl],
                    F[(8 * g + 2 * i + 1) * COLS + cl], w[i]);
    const int off = (g >> 1) * Geo<COLS>::S_CHUNK + chunk_off(cl, (g & 1) * 8);
    *reinterpret_cast<uint4*>(s + off) =
        make_uint4(w[0][0], w[1][0], w[2][0], w[3][0]);
    *reinterpret_cast<uint4*>(s + 2 * Geo<COLS>::S_CHUNK + off) =
        make_uint4(w[0][1], w[1][1], w[2][1], w[3][1]);
  }
}

// one step's products for this warpgroup (its 128 columns): for the
// step's nk k16 chunks, big += Ah Sh, small += Ah Sl, small += Al Sh. `a`
// holds the step's first A chunk (Al at a + apart), `s` the step's slab
// buffer.
template <int COLS>
__device__ __forceinline__ void products(float (&big)[64], float (&small)[64],
                                         const uint8_t* a, int apart,
                                         const uint8_t* s, int nk) {
  constexpr int S_CHUNK = Geo<COLS>::S_CHUNK;
  const int sn = (threadIdx.x >> 7) * (128 / 8) * SBO;   // the N tile
  wgmma_fence();
  for (int kk = 0; kk < nk; ++kk) {
    const uint8_t* ah = a + kk * A_CHUNK;
    const uint8_t* sh = s + kk * S_CHUNK + sn;
    wgmma_m64n128k16(big, smem_desc(ah, LBO, SBO), smem_desc(sh, LBO, SBO));
    wgmma_m64n128k16(small, smem_desc(ah, LBO, SBO),
                     smem_desc(sh + 2 * S_CHUNK, LBO, SBO));
    wgmma_m64n128k16(small, smem_desc(ah + apart, LBO, SBO),
                     smem_desc(sh, LBO, SBO));
  }
  wgmma_commit();
}

// big + small of every warpgroup -> the staged tile E (64 x COLS f32), then
// each point's 128-column spans into the row-major output
template <int COLS>
__device__ __forceinline__ void epilogue(float* E, const float (&big)[64],
                                         const float (&small)[64],
                                         float* __restrict__ out, int64_t t,
                                         int p0, int cbase, int ntx, int Cp) {
  constexpr int EP = Geo<COLS>::EP;
  const int tid = threadIdx.x, lt = tid & 127;
  const int row = (lt >> 5) * 16 + ((lt & 31) >> 2);
  const int col = (tid >> 7) * 128 + 2 * (lt & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<float2*>(E + row * EP + 8 * j + col) =
        make_float2(__fadd_rn(big[4 * j], small[4 * j]),
                    __fadd_rn(big[4 * j + 1], small[4 * j + 1]));
    *reinterpret_cast<float2*>(E + (row + 8) * EP + 8 * j + col) =
        make_float2(__fadd_rn(big[4 * j + 2], small[4 * j + 2]),
                    __fadd_rn(big[4 * j + 3], small[4 * j + 3]));
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (int)(t / ntx), tx = (int)(t % ntx);
  const int64_t nxp = (int64_t)ntx * TX;
  constexpr int NH = COLS / 128;
  for (int i = warp; i < PTS * NH; i += COLS / 32) {
    const int pi = i / NH, c = (i % NH) * 128 + 4 * lane;
    const int p = p0 + pi;
    const int64_t orow =
        ((int64_t)(ty * TY + p / TX) * nxp + (tx * TX + p % TX)) * Cp;
    const float4 x = *reinterpret_cast<const float4*>(E + pi * EP + c);
    *reinterpret_cast<float4*>(out + orow + cbase + c) = x;
  }
}

__global__ void __launch_bounds__(128)
ell_split_v1_kernel(const int* __restrict__ loc, const float* __restrict__ w,
                    const float* __restrict__ slab, float* __restrict__ out,
                    int K, int W, int Kpad, int Cp, int ntx) {
  using G = Geo<128>;
  constexpr int A_STEP = 2 * 2 * A_CHUNK;
  constexpr int STAGE = A_STEP + G::S_STEP;
  constexpr int F_OFF = cmax(2 * STAGE, G::E_BYTES);
  constexpr int LOCW = F_OFF + STAGES * G::F_STEP;
  extern __shared__ __align__(128) uint8_t sm[];
  float* F = reinterpret_cast<float*>(sm + F_OFF);
  int* loc_s = reinterpret_cast<int*>(sm + LOCW);
  float* w_s = reinterpret_cast<float*>(sm + LOCW + K * PTS * 4);
  const int nstrip = TILE / PTS, nchunk = Cp / 128;
  const int strip = blockIdx.x % nstrip;
  const int64_t tc = blockIdx.x / nstrip;
  const int cbase = (int)(tc % nchunk) * 128;
  const int64_t t = tc / nchunk;
  const int p0 = strip * PTS;
  const float* src = slab + t * (int64_t)W * Cp + cbase;
  const int nst = (Kpad + KS - 1) / KS;
  auto fetch = [&](int n) {   // step n into its stage; one group per call
    if (n < nst)
      fetch_step<128>(F + (n % STAGES) * KS * 128, src, n * KS, W, Cp);
    cp_async_commit();
  };

  for (int n = 0; n < STAGES - 1; ++n) fetch(n);
  stage_ell<128>(loc_s, w_s, loc, w, t, p0, K);
  float big[64], small[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) big[i] = small[i] = 0.0f;
  for (int s = 0; s < nst; ++s) {
    const int k0 = s * KS;
    uint8_t* buf = sm + (s & 1) * STAGE;
    fetch(s + STAGES - 1);        // its stage was last read by step s-1
    cp_async_wait<STAGES - 1>();
    // step s's stage landed; loc/w staged; step s-2, the last reader of
    // buf, done
    __syncthreads();
    build_a<128>(buf, 2 * A_CHUNK, loc_s, w_s, K, W, k0, min(k0 + KS, Kpad));
    split_slab<128>(buf + A_STEP, F + (s % STAGES) * KS * 128);
    fence_async_smem();
    __syncthreads();
    products<128>(big, small, buf, 2 * A_CHUNK, buf + A_STEP,
                  min(2, (Kpad - k0) >> 4));
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  __syncthreads();     // the products are done: the ring is free
  epilogue<128>(reinterpret_cast<float*>(sm), big, small, out, t, p0, cbase,
                ntx, Cp);
}

template <int COLS>
__global__ void __launch_bounds__(COLS)
ell_split_v2_kernel(const int* __restrict__ loc, const float* __restrict__ w,
                    const float* __restrict__ slab, float* __restrict__ out,
                    int K, int W, int Kpad, int Cp, int ntx) {
  using G = Geo<COLS>;
  extern __shared__ __align__(128) uint8_t sm[];
  const int apart = (Kpad / 16) * A_CHUNK;
  float* F = reinterpret_cast<float*>(sm + 2 * apart);
  uint8_t* ring = sm + 2 * apart + STAGES * G::F_STEP;  // slab, E or loc/w
  int* loc_s = reinterpret_cast<int*>(ring);
  float* w_s = reinterpret_cast<float*>(ring + K * PTS * 4);
  const int nstrip = TILE / PTS;
  const int strip = blockIdx.x % nstrip;
  const int64_t t = blockIdx.x / nstrip;
  const int p0 = strip * PTS;
  const float* slab_t = slab + t * (int64_t)W * Cp;
  const int nst = (Kpad + KS - 1) / KS;
  const int total = (Cp / COLS) * nst;          // (chunk, step) pairs
  auto fetch = [&](int n) {   // pair n into its stage; one group per call
    if (n < total)
      fetch_step<COLS>(F + (n % STAGES) * KS * COLS,
                       slab_t + (n / nst) * COLS, (n % nst) * KS, W, Cp);
    cp_async_commit();
  };

  for (int n = 0; n < STAGES - 1; ++n) fetch(n);
  stage_ell<COLS>(loc_s, w_s, loc, w, t, p0, K);
  __syncthreads();
  build_a<COLS>(sm, apart, loc_s, w_s, K, W, 0, Kpad);
  fence_async_smem();

  float big[64], small[64];
  for (int it = 0; it < total; ++it) {
    const int s = it % nst, k0 = s * KS;
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) big[i] = small[i] = 0.0f;
    }
    uint8_t* buf = ring + (it & 1) * G::S_STEP;
    fetch(it + STAGES - 1);       // its stage was last read by pair it-1
    cp_async_wait<STAGES - 1>();
    // pair it's stage landed; A built, loc/w read; pair it-2, the last
    // reader of buf, done; the last epilogue's reads of E done
    __syncthreads();
    split_slab<COLS>(buf, F + (it % STAGES) * KS * COLS);
    fence_async_smem();
    __syncthreads();
    products<COLS>(big, small, sm + 2 * s * A_CHUNK, apart, buf,
                   min(2, (Kpad - k0) >> 4));
    wgmma_wait<1>();
    if (s == nst - 1) {
      wgmma_wait<0>();
      __syncthreads();   // every warpgroup's products done: the ring is free
      epilogue<COLS>(reinterpret_cast<float*>(ring), big, small, out, t, p0,
                     (it / nst) * COLS, ntx, Cp);
    }
  }
}

static bool args_ok(int n_tiles, int K, int W, int Cp, int cols) {
  return n_tiles >= 1 && K >= 1 && K <= MAXK && W >= 1 && Cp >= cols &&
         Cp % cols == 0;
}

// loc (n_tiles, K, 1024) int32, w likewise f32, slab (n_tiles, W, Cp) f32,
// all 16-byte aligned; out (nty*32, ntx*32, Cp) f32; smem: the dynamic
// shared-memory bytes as ops/variant_kernels.ell_split_plan computed them
// (checked against the launch's own count). Each returns 0, a cudaError_t
// from the launch, or -1 for arguments the kernel does not take. They
// launch on `stream`, do not synchronise and allocate nothing.
extern "C" int ell_split_v1_launch(const int* loc, const float* w,
                                   const float* slab, float* out,
                                   int n_tiles, int ntx, int K, int W, int Cp,
                                   int smem, void* stream) {
  if (!args_ok(n_tiles, K, W, Cp, 128) || smem != v1_smem(K) ||
      smem > SMEM_MAX)
    return -1;
  const int64_t nblocks = (int64_t)n_tiles * (Cp / 128) * (TILE / PTS);
  if (nblocks > INT_MAX) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      ell_split_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ell_split_v1_kernel<<<(unsigned)nblocks, 128, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      loc, w, slab, out, K, W, (W + 15) / 16 * 16, Cp, ntx);
  return (int)cudaGetLastError();
}

template <int COLS>
static int v2_launch(const int* loc, const float* w, const float* slab,
                     float* out, int n_tiles, int ntx, int K, int W, int Cp,
                     int smem, cudaStream_t s) {
  const int Kpad = (W + 15) / 16 * 16;
  if (smem != v2_smem<COLS>(K, Kpad) || smem > SMEM_MAX) return -1;
  const int64_t nblocks = (int64_t)n_tiles * (TILE / PTS);
  if (nblocks > INT_MAX) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      ell_split_v2_kernel<COLS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  ell_split_v2_kernel<COLS><<<(unsigned)nblocks, COLS, smem, s>>>(
      loc, w, slab, out, K, W, Kpad, Cp, ntx);
  return (int)cudaGetLastError();
}

// CC: 128 or 256 columns per chunk (one or two warpgroups)
extern "C" int ell_split_v2_launch(const int* loc, const float* w,
                                   const float* slab, float* out,
                                   int n_tiles, int ntx, int K, int W, int Cp,
                                   int CC, int smem, void* stream) {
  if ((CC != 128 && CC != 256) || !args_ok(n_tiles, K, W, Cp, CC)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (CC == 128)
    return v2_launch<128>(loc, w, slab, out, n_tiles, ntx, K, W, Cp, smem,
                          s);
  return v2_launch<256>(loc, w, slab, out, n_tiles, ntx, K, W, Cp, smem, s);
}
