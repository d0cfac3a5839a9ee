// Packed multi-method ELL apply for Hopper (sm_90a).
//
// Replaces the ELL-direct branch of the TPU kernel
// mpassit_tpu/ops/pallas_matmul.py::fused_apply_packed (locs=/ws=, body
// _kernel_packed -> _build_A_vmem -> _packed_core). For each 32x32 target
// tile t, method m with packed column range [c0, c1) and target point p:
//
//     out[t rows, c0:c1] = sum_k ws_m[t,k,p] * slab[t, locs_m[t,k,p], c0:c1]
//
// then the optional Q4 wind rotation on (cu, cv, n) column windows, zeros
// on the columns [ranges[-1][1], Cp), and an optional per-tile sum(out^2).
//
// The TPU kernel builds a one-hot A per tile and feeds the MXU bf16-split
// operands; none of that carries over. Here the sum is computed directly:
// K indexed loads and K multiply-adds per output value, in f32.
//
// What bounds it on an H100: device-memory writes. The output is
// (nty*32, ntx*32, Cp) f32 -- 8.1 GB per pass at the CONUS grid and
// Cp = 1024 -- while the slab a tile reads is ~W*Cp*4 bytes (W ~ 16-40
// rows) and is re-read from L1/L2 for each of the tile's 1024 points.
// The design therefore keeps the write stream coalesced: one block per
// (tile, 128-column chunk), threadIdx.x is the column, so every slab-row
// read and every output-row write is 512 contiguous bytes. threadIdx.y
// strides over the tile's 1024 target points; the loc/w reads of a warp are
// one broadcast address. Shared-memory staging, TMA and wgmma are not used.
//
// Rounding: products and sums use __fmul_rn/__fadd_rn (never contracted
// into an FMA) and the rotation uses IEEE divisions, in the same order as
// the plain PyTorch version (ops/packed_kernel.py::packed_apply_plain), so
// the two agree bit for bit on the output. The checksum is reduced in a
// fixed tree order per block and a fixed sequential order across blocks:
// deterministic, but summed in another order than the plain version.
//
// Offsets into slab and out are 64-bit: nyp*nxp*Cp reaches 2^31 at the
// CONUS grid.

#include <cuda_runtime.h>
#include <stdint.h>

#define TY 32
#define TX 32
#define TILE 1024
#define COLS 128   // columns per block (threadIdx.x)
#define ROWS 4     // target-point lanes per block (threadIdx.y)
#define MAXM 8     // methods (column ranges) per launch
#define MAXR 8     // rotation windows per launch

struct Methods {
  const int* loc[MAXM];    // (n_tiles, K_m, TILE) int32
  const float* w[MAXM];    // (n_tiles, K_m, TILE) f32
  int K[MAXM];
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

__device__ __forceinline__ int method_of(const Methods& M, int c) {
  for (int m = 0; m < M.nm; ++m)
    if (c >= M.c0[m] && c < M.c1[m]) return m;
  return -1;
}

__device__ __forceinline__ float ell_sum(const Methods& M, int m,
                                         const float* __restrict__ slab_t,
                                         int64_t t, int p, int c, int Cp) {
  const int K = M.K[m];
  const int* loc = M.loc[m] + (t * K) * TILE + p;
  const float* w = M.w[m] + (t * K) * TILE + p;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int64_t r = __ldg(loc + (int64_t)k * TILE);
    const float term = __fmul_rn(__ldg(w + (int64_t)k * TILE),
                                 __ldg(slab_t + r * Cp + c));
    acc = (k == 0) ? term : __fadd_rn(acc, term);
  }
  return acc;
}

__global__ void __launch_bounds__(COLS * ROWS)
packed_apply_kernel(const float* __restrict__ slab, float* __restrict__ out,
                    const float* __restrict__ cosa,
                    const float* __restrict__ sina,
                    float* __restrict__ partial, Methods M, Windows R,
                    int W, int Cp, int ntx) {
  const int64_t t = blockIdx.x;
  const int c = blockIdx.y * COLS + threadIdx.x;
  const int ty = (int)(t / ntx), tx = (int)(t % ntx);
  const int64_t nxp = (int64_t)ntx * TX;
  const float* slab_t = slab + t * (int64_t)W * Cp;

  // this column's role: a method column (m >= 0) or a zeroed tail column
  // (m == -1); inside a rotation window the u column computes and writes
  // both u' and its partner v', and the v column writes nothing
  const int m = method_of(M, c);
  int role = 0, cpart = -1, mpart = -1;
  for (int r = 0; r < R.nr; ++r) {
    if (c >= R.cu[r] && c < R.cu[r] + R.n[r]) {
      role = 1;
      cpart = R.cv[r] + (c - R.cu[r]);
      mpart = method_of(M, cpart);
    } else if (c >= R.cv[r] && c < R.cv[r] + R.n[r]) {
      role = 2;
    }
  }

  float cs = 0.0f;
  if (role != 2) {
    for (int p = threadIdx.y; p < TILE; p += ROWS) {
      const int py = p / TX, px = p % TX;
      const int64_t orow =
          ((int64_t)(ty * TY + py) * nxp + (tx * TX + px)) * Cp;
      float val = (m >= 0) ? ell_sum(M, m, slab_t, t, p, c, Cp) : 0.0f;
      if (role == 1) {
        const float v = (mpart >= 0)
                            ? ell_sum(M, mpart, slab_t, t, p, cpart, Cp)
                            : 0.0f;
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
    __shared__ float red[COLS * ROWS];
    const int tid = threadIdx.y * COLS + threadIdx.x;
    red[tid] = cs;
    __syncthreads();
    for (int s = COLS * ROWS / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] = __fadd_rn(red[tid], red[tid + s]);
      __syncthreads();
    }
    if (tid == 0) partial[t * gridDim.y + blockIdx.y] = red[0];
  }
}

// per-tile checksum = the tile's chunk partials added in chunk order
__global__ void checksum_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ checksum,
                                       int n_tiles, int nchunk) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tiles) return;
  float s = 0.0f;
  for (int j = 0; j < nchunk; ++j)
    s = __fadd_rn(s, partial[(int64_t)t * nchunk + j]);
  checksum[t] = s;
}

// Returns 0, a cudaError_t from the launches, or -1 for arguments the
// kernel does not take. Launches on `stream`; does not synchronise and
// allocates nothing (partial is (n_tiles, Cp/128) scratch, or null with
// checksum null).
extern "C" int packed_apply_launch(
    const float* slab, float* out, const void* const* locs,
    const void* const* ws, const int* Ks, const int* c0s, const int* c1s,
    int nm, const int* cus, const int* cvs, const int* ns, int nr,
    const float* cosa, const float* sina, float* partial, float* checksum,
    int n_tiles, int ntx, int W, int Cp, void* stream) {
  if (nm < 1 || nm > MAXM || nr < 0 || nr > MAXR || Cp % COLS != 0 ||
      n_tiles < 1 || (nr > 0 && (cosa == nullptr || sina == nullptr)) ||
      ((partial == nullptr) != (checksum == nullptr)))
    return -1;
  Methods M;
  M.nm = nm;
  for (int m = 0; m < nm; ++m) {
    M.loc[m] = static_cast<const int*>(locs[m]);
    M.w[m] = static_cast<const float*>(ws[m]);
    M.K[m] = Ks[m];
    M.c0[m] = c0s[m];
    M.c1[m] = c1s[m];
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
  dim3 grid(n_tiles, nchunk), block(COLS, ROWS);
  packed_apply_kernel<<<grid, block, 0, s>>>(slab, out, cosa, sina, partial,
                                             M, R, W, Cp, ntx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (checksum != nullptr) {
    checksum_reduce_kernel<<<(n_tiles + 255) / 256, 256, 0, s>>>(
        partial, checksum, n_tiles, nchunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
