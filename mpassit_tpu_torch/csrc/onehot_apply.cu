// One-hot-operator apply for Hopper (sm_90a), with the TPU kernels' bf16
// term sets.
//
// Replaces two TPU kernels of mpassit_tpu/ops/pallas_matmul.py that take a
// prestacked one-hot operator A (built by matmul_apply._build_A_T):
//   - fused_apply (bodies _kernel_split, _kernel_highest): one method, no
//     rotation, no checksum -- one range [0, Cp) here;
//   - fused_apply_packed with As= (body _kernel_packed -> _packed_core):
//     one A per method column range, the Q4 wind rotation, zeros on the
//     columns [ranges[-1][1], Cp) and the per-tile checksum.
// For target point p of tile t and column c of method m's range:
//
//     out[t, p, c] = sum_w  sum_(i,j) in terms(precision)  a_i[t,w,p] s_j[t,w,c]
//       highest:     a = A_m,  s = slab (f32)
//       split_bf16:  Ah Sh + Ah Sl + Al Sh
//       split6_bf16: A0 S0 + A0 S1 + A1 S0 + A0 S2 + A1 S1 + A2 S0
//     with b0 = bf16_rn(x), b1 = bf16_rn(x - b0), b2 = bf16_rn(x - b0 - b1)
//     (hi = b0, lo = b1), as matmul_apply._split_hilo/_split_3way round
//     (bf16_terms.cuh, shared with ell_split_apply.cu).
//
// The TPU streams A prestacked into 3 or 6 bf16 copies because the MXU
// reads bf16 operands; here A stays f32 in device memory (a third of the
// bytes of the split6 stack) and both operands are split in the kernel. A
// product of two bf16 values is exact in f32, so each term equals the
// MXU's term and an FMA rounds it exactly as a multiply then add would;
// only the order of the f32 sums differs from the TPU's.
//
// Layout: one block per (tile, 128-column chunk, 32 target points);
// threadIdx.x is the column, so slab reads and output writes are 512-byte
// rows. Each step stages a (32 rows x 32 points) window of one method's A,
// already split, in shared memory (float4 per entry); every thread reads it
// as a broadcast, splits its own slab value once per row and keeps its 32
// points' sums in registers. A u column of a rotation window also sums its
// v partner's column (possibly of another method), rotates both and writes
// both; the v column writes nothing.
//
// What bounds it on an H100: f32 FMA issue. The operator is dense in this
// formulation (W rows per point, of which K are nonzero), so the work is
// n_tiles * 1024 * Cp * W * terms FMAs: at the CONUS EDGE1 restagger
// (W = 1096, Cp = 128, split6) about 1.7e12. A product on the tensor cores
// (mma.sync / wgmma, bf16 in, f32 accumulate) is the natural redesign and
// later work.
//
// No --use_fast_math: subnormal residuals survive and the Q4 divisions
// are IEEE. Offsets are 64-bit. The checksum is reduced in a fixed order,
// without atomics.

#include "bf16_terms.cuh"

#define TY 32
#define TX 32
#define TILE 1024
#define COLS 128          // columns per block (threadIdx.x)
#define PB 32             // target points per block (sums in registers)
#define WB 32             // A rows staged per step
#define NPCH (TILE / PB)  // point chunks per tile
#define MAXM 8            // methods (column ranges) per launch
#define MAXR 8            // rotation windows per launch

struct Ops {
  const float* A[MAXM];   // (n_tiles, W, TILE) f32 per method
  int c0[MAXM];
  int c1[MAXM];
  int nm;
};

struct Windows {
  int cu[MAXR];
  int cv[MAXR];
  int n[MAXR];
  int nr;
};

__device__ __forceinline__ int method_of(const Ops& O, int c) {
  for (int m = 0; m < O.nm; ++m)
    if (c >= O.c0[m] && c < O.c1[m]) return m;
  return -1;
}

template <int PREC>
__global__ void __launch_bounds__(COLS)
onehot_apply_kernel(const float* __restrict__ slab, float* __restrict__ out,
                    const float* __restrict__ cosa,
                    const float* __restrict__ sina,
                    float* __restrict__ partial, Ops O, Windows R, int W,
                    int Cp, int ntx) {
  __shared__ float4 a_s[WB][PB];
  const int64_t t = blockIdx.x;
  const int c = blockIdx.y * COLS + threadIdx.x;
  const int p0 = blockIdx.z * PB;
  const int ty = (int)(t / ntx), tx = (int)(t % ntx);
  const int64_t nxp = (int64_t)ntx * TX;
  const float* slab_t = slab + t * (int64_t)W * Cp;

  // this column's role, as in ell_apply.cuh: a method column (m >= 0) or a
  // zeroed tail column (m == -1); a u column of a rotation window (role 1)
  // also sums its partner column cpart of method mpart; a v column (role
  // 2) is written by its u column
  const int m = method_of(O, c);
  int role = 0, cpart = -1, mpart = -1;
  for (int r = 0; r < R.nr; ++r) {
    if (c >= R.cu[r] && c < R.cu[r] + R.n[r]) {
      role = 1;
      cpart = R.cv[r] + (c - R.cu[r]);
      mpart = method_of(O, cpart);
    } else if (c >= R.cv[r] && c < R.cv[r] + R.n[r]) {
      role = 2;
    }
  }

  float acc[PB], acc2[PB];
#pragma unroll
  for (int pi = 0; pi < PB; ++pi) acc[pi] = acc2[pi] = 0.0f;

  for (int mm = 0; mm < O.nm; ++mm) {
    const bool own = role != 2 && m == mm;
    const bool part = role == 1 && mpart == mm;
    if (!__syncthreads_or(own || part)) continue;   // block-uniform
    const float* A_t = O.A[mm] + t * (int64_t)W * TILE + p0;
    for (int w0 = 0; w0 < W; w0 += WB) {
      const int nw = min(WB, W - w0);
      __syncthreads();          // the previous step's readers are done
      for (int i = threadIdx.x; i < WB * PB; i += COLS) {
        const int wi = i / PB, pi = i % PB;
        const float a =
            (wi < nw) ? __ldg(A_t + (int64_t)(w0 + wi) * TILE + pi) : 0.0f;
        a_s[wi][pi] = split<PREC>(a);
      }
      __syncthreads();
      const float* rows = slab_t + (int64_t)w0 * Cp;
      if (own) accumulate<PREC, PB>(acc, a_s, rows + c, nw, Cp);
      if (part) accumulate<PREC, PB>(acc2, a_s, rows + cpart, nw, Cp);
    }
  }

  float cs = 0.0f;
  if (role != 2) {
#pragma unroll
    for (int pi = 0; pi < PB; ++pi) {
      const int p = p0 + pi;
      const int py = p / TX, px = p % TX;
      const int64_t orow =
          ((int64_t)(ty * TY + py) * nxp + (tx * TX + px)) * Cp;
      float val = (m >= 0) ? acc[pi] : 0.0f;
      if (role == 1) {
        const float v = (mpart >= 0) ? acc2[pi] : 0.0f;
        const float ca = cosa[t * TILE + p], sa = sina[t * TILE + p];
        // quirk Q4: u first, then v from the ROTATED u
        const float tana = __fdiv_rn(sa, ca);
        const float un = __fdiv_rn(__fadd_rn(val, __fmul_rn(v, tana)),
                                   __fadd_rn(ca, __fmul_rn(sa, tana)));
        const float vn = __fdiv_rn(__fsub_rn(v, __fmul_rn(un, sa)), ca);
        val = un;
        out[orow + cpart] = vn;
        cs = __fadd_rn(cs, __fmul_rn(vn, vn));
      }
      out[orow + c] = val;
      cs = __fadd_rn(cs, __fmul_rn(val, val));
    }
  }

  if (partial != nullptr) {
    __shared__ float red[COLS];
    red[threadIdx.x] = cs;
    __syncthreads();
    for (int s = COLS / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s)
        red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + s]);
      __syncthreads();
    }
    if (threadIdx.x == 0)
      partial[(t * gridDim.y + blockIdx.y) * gridDim.z + blockIdx.z] = red[0];
  }
}

// per-tile checksum = the tile's block partials added in (chunk, points)
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

// precision: 0 highest, 1 split_bf16, 2 split6_bf16. Returns 0, a
// cudaError_t from the launches, or -1 for arguments the kernel does not
// take. Launches on `stream`; does not synchronise and allocates nothing
// (partial is (n_tiles, Cp/128 * 32) scratch, or null with checksum null).
extern "C" int onehot_apply_launch(
    const float* slab, float* out, const void* const* As, const int* c0s,
    const int* c1s, int nm, const int* cus, const int* cvs, const int* ns,
    int nr, const float* cosa, const float* sina, float* partial,
    float* checksum, int n_tiles, int ntx, int W, int Cp, int precision,
    void* stream) {
  if (nm < 1 || nm > MAXM || nr < 0 || nr > MAXR || Cp % COLS != 0 ||
      n_tiles < 1 || W < 1 || precision < 0 || precision > 2 ||
      (nr > 0 && (cosa == nullptr || sina == nullptr)) ||
      ((partial == nullptr) != (checksum == nullptr)))
    return -1;
  Ops O;
  O.nm = nm;
  for (int m = 0; m < nm; ++m) {
    O.A[m] = static_cast<const float*>(As[m]);
    O.c0[m] = c0s[m];
    O.c1[m] = c1s[m];
  }
  Windows R;
  R.nr = nr;
  for (int r = 0; r < nr; ++r) {
    R.cu[r] = cus[r];
    R.cv[r] = cvs[r];
    R.n[r] = ns[r];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunk = Cp / COLS;
  dim3 grid(n_tiles, nchunk, NPCH), block(COLS);
  if (precision == 0)
    onehot_apply_kernel<0><<<grid, block, 0, s>>>(slab, out, cosa, sina,
                                                  partial, O, R, W, Cp, ntx);
  else if (precision == 1)
    onehot_apply_kernel<1><<<grid, block, 0, s>>>(slab, out, cosa, sina,
                                                  partial, O, R, W, Cp, ntx);
  else
    onehot_apply_kernel<2><<<grid, block, 0, s>>>(slab, out, cosa, sina,
                                                  partial, O, R, W, Cp, ntx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (checksum != nullptr) {
    onehot_checksum_kernel<<<(n_tiles + 255) / 256, 256, 0, s>>>(
        partial, checksum, n_tiles, nchunk * NPCH);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
