// One-hot-operator apply for Hopper (sm_90a) on the tensor cores: the TPU
// kernels' bf16 term sets as warpgroup matrix multiplies (wgmma), bf16
// operands, f32 accumulation.
//
// Replaces two TPU kernels of mpassit_tpu/ops/pallas_matmul.py that take a
// prestacked one-hot operator A (built by matmul_apply._build_A_T):
//   - fused_apply (bodies _kernel_split, _kernel_highest): one method, no
//     rotation, no checksum -- one range [0, Cp) here;
//   - fused_apply_packed with As= (body _kernel_packed -> _packed_core):
//     one A per method column range, the Q4 wind rotation, zeros on the
//     columns [ranges[-1][1], Cp) and the per-tile checksum.
// Per tile t it is a batched GEMM, out[t] (1024 x Cp) = sum over the term
// set of A_i[t]^T (1024 x W) . S_j[t] (W x Cp):
//
//       split_bf16:           Ah Sh + Ah Sl + Al Sh
//       split6_bf16, highest: A0 S0 + A0 S1 + A1 S0 + A0 S2 + A1 S1 + A2 S0
//
// with b0 = bf16_rn(x), b1 = bf16_rn(x - b0), b2 = bf16_rn(x - b0 - b1)
// (hi = b0, lo = b1; split_pair of bf16_terms.cuh, as matmul_apply
// ._split_hilo/_split_3way round). `highest` is the six-term set: the JAX
// package's highest is "f32 operands at Precision.HIGHEST (XLA's own
// bf16_6x, six MXU passes)" (mpassit_tpu/ops/matmul_apply.py:74-79), the
// same six terms as split6_bf16; the dropped A1S2 + A2S1 + A2S2 are about
// 2^-24 relative. Each bf16 x bf16 product is exact in f32 and the sums are
// f32, as on the MXU; only the order of the sums differs.
//
// Design. A block covers 128 target points of one tile (two consumer
// warpgroups of 64 rows, wgmma m64n128k16) x one 128-column chunk, and
// loops over K = W padded to a multiple of 16 in steps of 32 rows. Each
// step: every thread loads 2 x 8 rows of A (points contiguous) and of the
// slab (columns contiguous) into registers one step ahead, splits each f32
// value once into its bf16 parts (split_pair of bf16_terms.cuh) and writes
// them K-major into a double-buffered shared-memory ring (onehot_mma.cuh);
// rows >= W are written as zeros, never read. Both warpgroups then issue
// every term of the precision for that step, while the next step is loaded
// and split. The terms sum in two register accumulators across the whole
// K loop, added once (IEEE) in the epilogue: the leading term (A0 S0,
// Ah Sh) in one, the others in the second. The tensor cores add into an
// accumulator with truncation; with all terms in one accumulator every
// small term cost up to an ulp of the result (1.2e-6 of max|plain| at
// W = 1096 on an H100, against 3.8e-7 with two). A stays f32 in device
// memory: the TPU's prestacked 3x/6x bf16 copies would triple or sextuple
// it.
//
// Columns: a chunk runs one K pass per method whose range meets it; the
// slab columns outside that method's range are staged as zeros, and every
// pass adds into the same accumulators. A rotation window whose partner
// columns lie in another chunk is handled by a second accumulation in the
// same block: the "partner tile", whose column n is the partner of this
// chunk's column n, so every block writes exactly its own columns. The
// launch geometry (method passes per chunk, column roles and partners,
// shared-memory bytes) comes from ops/onehot_kernel.launch_plan as an int
// table on the device. The grid runs the 8 point strips of a (tile, chunk)
// fastest, then the chunks of a tile, so the blocks sharing a tile's slab
// and A run together and read them from L2.
//
// The epilogue stages the f32 tile(s) in shared memory, then writes each
// target point's 128 columns as one contiguous 512-byte span (16-byte
// stores) after the Q4 rotation (IEEE divisions, u first, then v from the
// rotated u) and the tail zeros; the checksum partial of each block is
// reduced in a fixed order, and onehot_checksum_kernel adds a tile's
// partials in (chunk, strip) order: no atomics.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s dense bf16): at the
// CONUS EDGE1 restagger (1938 tiles, W = 1096 -> K = 1104, Cp = 128) A in
// f32 is read once per column chunk, 8.7 GB, >= 2.7 ms at ~3.2 TB/s, and
// the six-term product is 3.4e12 FLOP, >= 3.4 ms at peak; at the CONUS
// pack (W = 40, Cp = 1024, 10 method passes per tile) the 8.1 GB output
// write is >= 2.6 ms (the measured write wall) against 1.5e12 FLOP. The
// design reads every operand byte once per block, splits it once, keeps
// the slab re-reads of a tile's 8 strips in L2, and overlaps the next
// step's loads and splits with the tensor cores' work on this step.
// Measured on an H100 at 700 W: 8.3 ms at EDGE1 split6 (405 TFLOP/s),
// 9.5 ms at the CONUS pack. Neither floor binds; the CUDA-core side does:
// the split, and each step's load latency, exposed because at 255
// registers a thread holds one step ahead and an SM one block.
//
// No --use_fast_math: the Q4 divisions are IEEE. Offsets are 64-bit.

#include <climits>

#include "bf16_terms.cuh"
#include "onehot_mma.cuh"

#define TY 32
#define TX 32
#define TILE 1024
#define COLS 128                  // columns per block: the wgmma N
#define PTS 128                   // target points per block: 2 x 64 rows
#define NSTRIP (TILE / PTS)       // point strips per tile
#define KS 32                     // operator rows per pipeline step
#define THREADS 256               // two warpgroups
#define PART_BYTES (PTS * KS * 2) // one bf16 part of one operand, one step
#define EPAD 136                  // row stride (floats) of a staged f32 tile
#define TILE_BYTES (PTS * EPAD * 4)
#define LBO 128                   // descriptor: core matrices adjacent in K
#define SBO (KS / 8 * 128)        // ... adjacent in M (points) or N (columns)
#define SMEM_MAX 232448
#define MAXM 8                    // methods (column ranges) per launch

struct Ops {
  const float* A[MAXM];   // (n_tiles, W, TILE) f32 per method
};

// byte offset of (row r, rows k..k+7 of the step) in one part: core
// matrix (r / 8, k / 8), row r % 8
__device__ __forceinline__ int part_off(int r, int k) {
  return ((r >> 3) * (KS / 8) + (k >> 3)) * 128 + (r & 7) * 16;
}

// 8 consecutive K values of row r -> their NP bf16 parts in the step's
// operand buffer `base` (NP parts of PART_BYTES each)
template <int NP>
__device__ __forceinline__ void store_parts(uint8_t* base, int r, int k,
                                            const float (&x)[8]) {
  uint32_t w[4][NP];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_pair<NP - 1>(x[2 * i], x[2 * i + 1], w[i]);
  const int off = part_off(r, k);
#pragma unroll
  for (int p = 0; p < NP; ++p)
    *reinterpret_cast<uint4*>(base + p * PART_BYTES + off) =
        make_uint4(w[0][p], w[1][p], w[2][p], w[3][p]);
}

// big + small (this warpgroup's 64 x 128 f32 fragments) = sum over the
// methods in `mask` of the term set of A_m^T . S_m, where S_m is the slab
// column `scol` staged by this thread (its row r of the operand tile) when
// method_of(scol) == m, zero otherwise. `big` takes the leading term (A0 S0
// or Ah Sh), `small` the rest: the tensor cores add into an accumulator
// with truncation, so the small terms go to an accumulator of their own
// magnitude (2^-8 of the leading one) rather than each costing up to an
// ulp of the result. The K loop is double-buffered (see the header note).
template <int NP>
__device__ __forceinline__ void run_tile(
    float (&big)[64], float (&small)[64], uint8_t* sm, const Ops& O,
    const float* slab_t, int64_t a_off, int W, int Kpad, int Cp,
    unsigned mask, int scol, int smeth, int r, int wg) {
#pragma unroll
  for (int i = 0; i < 64; ++i) big[i] = small[i] = 0.0f;
  const int nst = (Kpad + KS - 1) / KS;
  const int total = __popc(mask) * nst;
  if (total == 0) return;
  constexpr int STAGE = 2 * NP * PART_BYTES;
  float xa[2][8], xs[2][8];
  int cm = __ffs(mask) - 1;        // method of the step held in xa/xs
  unsigned left = mask & (mask - 1);
  int ck = 0;                      // its first row

  // rows k0 + 8 (wg + 2u) + i of A (this thread's point) and of the slab
  // (this thread's column, when it belongs to method m)
  auto load = [&](int m, int k0) {
    const bool mine = smeth == m;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kb = k0 + 8 * (wg + 2 * u);
      const float* a = O.A[m] + a_off + (int64_t)kb * TILE + r;
      const float* s = slab_t + (int64_t)kb * Cp + max(scol, 0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool in = kb + i < W;
        xa[u][i] = in ? __ldg(a + i * TILE) : 0.0f;
        xs[u][i] = (mine && in) ? __ldg(s + i * Cp) : 0.0f;
      }
    }
  };

  load(cm, ck);
  for (int s = 0; s < total; ++s) {
    const int k0 = ck;
    uint8_t* buf = sm + (s & 1) * STAGE;
    __syncthreads();   // step s-2, the last reader of buf, is done
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kk = 8 * (wg + 2 * u);
      store_parts<NP>(buf, r, kk, xa[u]);
      store_parts<NP>(buf + NP * PART_BYTES, r, kk, xs[u]);
    }
    fence_async_smem();
    __syncthreads();
    ck += KS;
    if (ck >= Kpad) {
      ck = 0;
      cm = left ? __ffs(left) - 1 : -1;
      left &= left - 1;
    }
    if (cm >= 0) load(cm, ck);

    const uint8_t* a_s = buf + wg * (64 / 8) * (KS / 8) * 128;
    const uint8_t* s_s = buf + NP * PART_BYTES;
    const int nk = min(2, (Kpad - k0) >> 4);
    wgmma_fence();
    for (int kk = 0; kk < nk; ++kk) {
      const int ko = kk * 2 * 128;
#define TERM(acc, i, j)                                                 \
  wgmma_m64n128k16(acc, smem_desc(a_s + (i) * PART_BYTES + ko, LBO, SBO), \
                   smem_desc(s_s + (j) * PART_BYTES + ko, LBO, SBO))
      TERM(big, 0, 0);
      TERM(small, 0, 1);
      TERM(small, 1, 0);
      if constexpr (NP == 3) {
        TERM(small, 0, 2);
        TERM(small, 1, 1);
        TERM(small, 2, 0);
      }
#undef TERM
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
}

// this warpgroup's fragments, big + small -> rows of the staged f32 tile E
__device__ __forceinline__ void dump(float* E, const float (&big)[64],
                                     const float (&small)[64], int wg,
                                     int lt) {
  const int row = wg * 64 + (lt >> 5) * 16 + ((lt & 31) >> 2);
  const int col = 2 * (lt & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<float2*>(E + row * EPAD + 8 * j + col) =
        make_float2(__fadd_rn(big[4 * j], small[4 * j]),
                    __fadd_rn(big[4 * j + 1], small[4 * j + 1]));
    *reinterpret_cast<float2*>(E + (row + 8) * EPAD + 8 * j + col) =
        make_float2(__fadd_rn(big[4 * j + 2], small[4 * j + 2]),
                    __fadd_rn(big[4 * j + 3], small[4 * j + 3]));
  }
}

// plan: the int table of launch_plan: method (-1 tail), role (0, 1 u,
// 2 v) and partner column of every column, then per chunk the mask of
// methods of its own passes, then per chunk the mask of its partner
// tile's passes (-1: no partner outside the chunk)
template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
onehot_mma_kernel(const float* __restrict__ slab, float* __restrict__ out,
                  const float* __restrict__ cosa,
                  const float* __restrict__ sina,
                  float* __restrict__ partial, Ops O,
                  const int* __restrict__ plan, int W, int Kpad, int Cp,
                  int ntx, int nchunk) {
  extern __shared__ __align__(128) uint8_t sm[];
  constexpr int RING = 2 * 2 * NP * PART_BYTES;
  constexpr int E1_OFF = RING > TILE_BYTES ? RING : TILE_BYTES;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, r = tid & 127;
  const int strip = blockIdx.x % NSTRIP;
  const int64_t tc = blockIdx.x / NSTRIP;
  const int chunk = (int)(tc % nchunk);
  const int64_t t = tc / nchunk;
  const int ty = (int)(t / ntx), tx = (int)(t % ntx);
  const int p0 = strip * PTS;
  const int cbase = chunk * COLS;
  const int* cmeth = plan;
  const int* crole = plan + Cp;
  const int* cpart = plan + 2 * Cp;
  const unsigned own = (unsigned)plan[3 * Cp + chunk];
  const int pmask = plan[3 * Cp + nchunk + chunk];
  const float* slab_t = slab + t * (int64_t)W * Cp;
  const int64_t a_off = t * (int64_t)W * TILE + p0;

  float big[64], small[64];
  const int c = cbase + r;   // the column this thread stages
  run_tile<NP>(big, small, sm, O, slab_t, a_off, W, Kpad, Cp, own, c,
               cmeth[c], r, wg);
  float* E1 = reinterpret_cast<float*>(sm + (pmask >= 0 ? E1_OFF : 0));
  float* E2 = reinterpret_cast<float*>(sm);
  __syncthreads();
  dump(E1, big, small, wg, r);
  if (pmask >= 0) {
    // column n of the partner tile: the partner of column cbase + n when
    // it lies outside this chunk
    const int pc = cpart[c];
    const int ext = (crole[c] != 0 && pc / COLS != chunk) ? pc : -1;
    run_tile<NP>(big, small, sm, O, slab_t, a_off, W, Kpad, Cp,
                 (unsigned)pmask, ext, ext >= 0 ? cmeth[ext] : -1, r, wg);
    __syncthreads();
    dump(E2, big, small, wg, r);
  }
  __syncthreads();

  // epilogue: lane l of warp w writes columns 4l..4l+3 of points w, w+8, ...
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = 4 * lane;
  int role[4], src[4];
  bool tail[4], any_role = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int cq = cbase + n0 + q;
    role[q] = crole[cq];
    tail[q] = cmeth[cq] < 0;
    const int pc = cpart[cq];
    // the partner's value: column of E1 when it lies in this chunk, else
    // column n0 + q of the partner tile E2 (marked -1)
    src[q] = (role[q] != 0 && pc / COLS == chunk) ? pc - cbase : -1;
    any_role |= role[q] != 0;
  }
  const int64_t nxp = (int64_t)ntx * TX;
  float cs = 0.0f;
  for (int it = 0; it < PTS / 8; ++it) {
    const int pi = it * 8 + warp;
    const int p = p0 + pi;
    const float4 x = *reinterpret_cast<const float4*>(E1 + pi * EPAD + n0);
    float v[4] = {x.x, x.y, x.z, x.w};
    if (any_role) {
      const float ca = cosa[t * TILE + p], sa = sina[t * TILE + p];
      const float tana = __fdiv_rn(sa, ca);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (role[q] == 0) continue;
        const float y = src[q] >= 0 ? E1[pi * EPAD + src[q]]
                                    : E2[pi * EPAD + n0 + q];
        const float uu = role[q] == 1 ? v[q] : y;
        const float vv = role[q] == 1 ? y : v[q];
        // quirk Q4: u first, then v from the ROTATED u
        const float un = __fdiv_rn(__fadd_rn(uu, __fmul_rn(vv, tana)),
                                   __fadd_rn(ca, __fmul_rn(sa, tana)));
        v[q] = role[q] == 1
                   ? un
                   : __fdiv_rn(__fsub_rn(vv, __fmul_rn(un, sa)), ca);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (tail[q]) v[q] = 0.0f;
      cs = __fadd_rn(cs, __fmul_rn(v[q], v[q]));
    }
    const int py = p / TX, px = p % TX;
    const int64_t orow = ((int64_t)(ty * TY + py) * nxp + (tx * TX + px)) * Cp;
    *reinterpret_cast<float4*>(out + orow + cbase + n0) =
        make_float4(v[0], v[1], v[2], v[3]);
  }

  if (partial != nullptr) {
    __syncthreads();   // E1/E2 reads are done: reuse the ring
    float* red = reinterpret_cast<float*>(sm);
    red[tid] = cs;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] = __fadd_rn(red[tid], red[tid + s]);
      __syncthreads();
    }
    if (tid == 0) partial[tc * NSTRIP + strip] = red[0];
  }
}

// per-tile checksum = the tile's block partials added in (chunk, strip)
// order
__global__ void onehot_checksum_kernel(const float* __restrict__ partial,
                                       float* __restrict__ checksum,
                                       int n_tiles, int nparts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tiles) return;
  float s = 0.0f;
  for (int j = 0; j < nparts; ++j)
    s = __fadd_rn(s, partial[(int64_t)t * nparts + j]);
  checksum[t] = s;
}

// dynamic shared memory of a launch: the ring (or one staged tile, if
// larger), plus the own tile's stage when a partner tile is computed
static int smem_bytes(int np, int partner) {
  const int ring = 2 * 2 * np * PART_BYTES;
  return (ring > TILE_BYTES ? ring : TILE_BYTES) + (partner ? TILE_BYTES : 0);
}

template <int NP>
static int launch(const float* slab, float* out, const float* cosa,
                  const float* sina, float* partial, const Ops& O,
                  const int* plan, int W, int Kpad, int Cp, int ntx,
                  int nchunk, int64_t nblocks, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      onehot_mma_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  onehot_mma_kernel<NP><<<(unsigned)nblocks, THREADS, smem, s>>>(
      slab, out, cosa, sina, partial, O, plan, W, Kpad, Cp, ntx, nchunk);
  return (int)cudaGetLastError();
}

// terms: 3 (split_bf16) or 6 (split6_bf16, highest); plan: the device int
// table of launch_plan; smem and partner as launch_plan computed them (the
// launch checks smem against its own count). Returns 0, a cudaError_t from
// the launches, or -1 for arguments the kernel does not take. Launches on
// `stream`; does not synchronise and allocates nothing (partial is
// (n_tiles, Cp/128 * 8) scratch, or null with checksum null).
extern "C" int onehot_apply_launch(
    const float* slab, float* out, const void* const* As, int nm,
    const int* plan, int partner, const float* cosa, const float* sina,
    float* partial, float* checksum, int n_tiles, int ntx, int W, int Kpad,
    int Cp, int terms, int smem, void* stream) {
  if (nm < 1 || nm > MAXM || Cp < COLS || Cp % COLS != 0 || n_tiles < 1 ||
      W < 1 || Kpad < W || Kpad % 16 != 0 || plan == nullptr ||
      (terms != 3 && terms != 6) ||
      smem != smem_bytes(terms == 3 ? 2 : 3, partner) || smem > SMEM_MAX ||
      ((partial == nullptr) != (checksum == nullptr)))
    return -1;
  const int nchunk = Cp / COLS;
  const int64_t nblocks = (int64_t)n_tiles * nchunk * NSTRIP;
  if (nblocks > INT_MAX) return -1;
  Ops O;
  for (int m = 0; m < MAXM; ++m)
    O.A[m] = static_cast<const float*>(As[m < nm ? m : 0]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = terms == 3
               ? launch<2>(slab, out, cosa, sina, partial, O, plan, W, Kpad,
                           Cp, ntx, nchunk, nblocks, smem, s)
               : launch<3>(slab, out, cosa, sina, partial, O, plan, W, Kpad,
                           Cp, ntx, nchunk, nblocks, smem, s);
  if (rc != 0) return rc;
  if (checksum != nullptr) {
    onehot_checksum_kernel<<<(n_tiles + 255) / 256, 256, 0, s>>>(
        partial, checksum, n_tiles, nchunk * NSTRIP);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
