// The ELL-direct packed apply shared by packed_apply.cu (slab rows from an
// (n_tiles, W, Cp) slab in device memory) and packed_gather.cu (slab rows
// fetched from the (n_src + 8, Cp) source through per-tile chunk starts).
// The K-sum and the epilogue are one template over the row source, so the
// two kernels cannot drift: on the same operator they agree bit for bit.
//
// For each 32x32 target tile t, method m with packed column range [c0, c1)
// and target point p:
//
//     out[t rows, c0:c1] = sum_k ws_m[t,k,p] * row(t, locs_m[t,k,p])[c0:c1]
//
// then the optional Q4 wind rotation on (cu, cv, n) column windows, zeros on
// the columns [ranges[-1][1], Cp), and an optional per-tile sum(out^2).
//
// Layout: one block per (tile, 128-column chunk); threadIdx.x is the column,
// so every row read and every output-row write is 512 contiguous bytes;
// threadIdx.y strides over the tile's 1024 target points, and the loc/w
// reads of a warp are one broadcast address.
//
// Rounding: products and sums use __fmul_rn/__fadd_rn (never contracted
// into an FMA) and the rotation uses IEEE divisions, in the same order as
// the plain PyTorch version (ops/packed_kernel.py::packed_apply_plain), so
// the two agree bit for bit on the output. The checksum is reduced in a
// fixed tree order per block and a fixed sequential order across blocks:
// deterministic, but summed in another order than the plain version.
//
// Offsets are 64-bit: nyp*nxp*Cp reaches 2^31 at the CONUS grid.

#pragma once

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

// `tile` is the row source of one tile: tile(r, c) = slab row r, column c
template <typename Tile>
__device__ __forceinline__ float ell_sum(const Methods& M, int m,
                                         const Tile& tile, int64_t t, int p,
                                         int c) {
  const int K = M.K[m];
  const int* loc = M.loc[m] + (t * K) * TILE + p;
  const float* w = M.w[m] + (t * K) * TILE + p;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int64_t r = __ldg(loc + (int64_t)k * TILE);
    const float term = __fmul_rn(__ldg(w + (int64_t)k * TILE), tile(r, c));
    acc = (k == 0) ? term : __fadd_rn(acc, term);
  }
  return acc;
}

// Rows::tile(t) returns the row source of tile t
template <typename Rows>
__global__ void __launch_bounds__(COLS * ROWS)
ell_apply_kernel(Rows rows, float* __restrict__ out,
                 const float* __restrict__ cosa,
                 const float* __restrict__ sina, float* __restrict__ partial,
                 Methods M, Windows R, int Cp, int ntx) {
  const int64_t t = blockIdx.x;
  const int c = blockIdx.y * COLS + threadIdx.x;
  const int ty = (int)(t / ntx), tx = (int)(t % ntx);
  const int64_t nxp = (int64_t)ntx * TX;
  const auto tile = rows.tile(t);

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
      float val = (m >= 0) ? ell_sum(M, m, tile, t, p, c) : 0.0f;
      if (role == 1) {
        const float v =
            (mpart >= 0) ? ell_sum(M, mpart, tile, t, p, cpart) : 0.0f;
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

// Fills M and R from the C arrays of a launch; false for arguments the
// kernel does not take.
inline bool ell_args(Methods& M, Windows& R, const void* const* locs,
                     const void* const* ws, const int* Ks, const int* c0s,
                     const int* c1s, int nm, const int* cus, const int* cvs,
                     const int* ns, int nr, const float* cosa,
                     const float* sina, const float* partial,
                     const float* checksum, int n_tiles, int Cp) {
  if (nm < 1 || nm > MAXM || nr < 0 || nr > MAXR || Cp % COLS != 0 ||
      n_tiles < 1 || (nr > 0 && (cosa == nullptr || sina == nullptr)) ||
      ((partial == nullptr) != (checksum == nullptr)))
    return false;
  M.nm = nm;
  for (int m = 0; m < nm; ++m) {
    M.loc[m] = static_cast<const int*>(locs[m]);
    M.w[m] = static_cast<const float*>(ws[m]);
    M.K[m] = Ks[m];
    M.c0[m] = c0s[m];
    M.c1[m] = c1s[m];
  }
  R.nr = nr;
  for (int r = 0; r < nr; ++r) {
    R.cu[r] = cus[r];
    R.cv[r] = cvs[r];
    R.n[r] = ns[r];
  }
  return true;
}

// Launches the apply (and the checksum reduction) on `stream`; returns 0 or
// the cudaError_t of a refused launch. Does not synchronise.
template <typename Rows>
int ell_launch(const Rows& rows, float* out, const float* cosa,
               const float* sina, float* partial, float* checksum,
               const Methods& M, const Windows& R, int n_tiles, int ntx,
               int Cp, cudaStream_t s) {
  const int nchunk = Cp / COLS;
  dim3 grid(n_tiles, nchunk), block(COLS, ROWS);
  ell_apply_kernel<Rows><<<grid, block, 0, s>>>(rows, out, cosa, sina,
                                                partial, M, R, Cp, ntx);
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
