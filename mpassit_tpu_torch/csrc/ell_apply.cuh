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
// What bounds it on an H100: the output write (Cp f32 per target point,
// 8.1 GB at the CONUS pack) and, where the slab is wide (the restaggers),
// the row reads. The design, whose geometry is ops/packed_kernel.ell_plan:
//
// - one block of 256 threads per (tile, BW-column block), BW = 64, 128,
//   256 or 512 (ell_plan takes 128 with staged rows: the rotation window's
//   heavier columns then spread over more, shorter blocks, which measured
//   faster than 256 at the CONUS pack; and 64 with rows from device
//   memory, faster at the restaggers); each thread owns 4 adjacent columns
//   (a float4), so a warp reads and writes 512 (BW = 64: twice 256)
//   contiguous bytes of one target point, in 16-byte stores (4-byte ones
//   only at a method edge inside a thread's columns);
// - a thread walks its points 4 at a time: one warp-uniform 16-byte load
//   each of loc and w per k gives 4 points, whose 4 row loads are then in
//   flight together;
// - where the tile's rows of the block's columns fit (ell_plan's choice
//   by W), the block first copies them into shared memory with 16-byte
//   cp.async, and the sums read them there; otherwise rows come through
//   L1/L2;
// - the per-column table (method, role, partner) replaces any search in
//   the kernel, and sends each thread down one of three paths: 4 columns
//   of one method, none rotated, take float4 sums; 4 columns of one
//   method with window columns among them, every partner of the same
//   method, take float4 sums of their own and scalar sums of the partners
//   from the same loc/w loads, then the rotation (a v column recomputes
//   its partner's u sum; a partner outside the block is read from device
//   memory); a thread with a method edge inside its 4 columns computes
//   each column alone (still 4 points at a time).
//
// Rounding: products and sums use __fmul_rn/__fadd_rn (never contracted
// into an FMA), in k order, and the rotation uses IEEE divisions, in the
// same order as the plain PyTorch version (ops/packed_kernel.py::
// packed_apply_plain), so the two agree bit for bit on the output. The
// checksum is reduced in a fixed order per thread, a fixed tree per block
// and a fixed sequential order across blocks: deterministic, but summed in
// another order than the plain version.
//
// Offsets are 64-bit: nyp*nxp*Cp reaches 2^31 at the CONUS grid.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"

#define TY 32
#define TX 32
#define TILE 1024
#define NT 256     // threads per block
#define MAXM 8     // methods (column ranges) per launch

// roles of a column in the table of ell_plan
#define ROLE_PLAIN 0
#define ROLE_U 1
#define ROLE_V 2
#define ROLE_TAIL 3

struct Methods {
  const int* loc[MAXM];    // (n_tiles, K_m, TILE) int32
  const float* w[MAXM];    // (n_tiles, K_m, TILE) f32
  int K[MAXM];
  int nm;
};

// table entry of a column: method + 1 (bits 0-3, 0 for none), role (4-5),
// partner's method + 1 (6-9), partner column (10-31)
__device__ __forceinline__ int ci_method(int e) { return (e & 15) - 1; }
__device__ __forceinline__ int ci_role(int e) { return (e >> 4) & 3; }
__device__ __forceinline__ int ci_pmethod(int e) { return ((e >> 6) & 15) - 1; }
__device__ __forceinline__ int ci_partner(int e) { return e >> 10; }

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// acc (+)= w * r in f32, element by element, never an FMA
__device__ __forceinline__ void madd4(float4& acc, float w, float4 r,
                                      bool first) {
  const float4 t = make_float4(__fmul_rn(w, r.x), __fmul_rn(w, r.y),
                               __fmul_rn(w, r.z), __fmul_rn(w, r.w));
  acc = first ? t
              : make_float4(__fadd_rn(acc.x, t.x), __fadd_rn(acc.y, t.y),
                            __fadd_rn(acc.z, t.z), __fadd_rn(acc.w, t.w));
}

// cs + x.x^2 + x.y^2 + x.z^2 + x.w^2, in that order
__device__ __forceinline__ float sq4(float cs, float4 x) {
  cs = __fadd_rn(cs, __fmul_rn(x.x, x.x));
  cs = __fadd_rn(cs, __fmul_rn(x.y, x.y));
  cs = __fadd_rn(cs, __fmul_rn(x.z, x.z));
  return __fadd_rn(cs, __fmul_rn(x.w, x.w));
}

// What a block sees of its tile's rows: the staged copy of columns
// [cb0, cb0 + BW) in shared memory where there is one, else the row source
// in device memory. Rows::row(t, r) is the address of tile t's row r.
template <typename Rows, bool STAGE>
struct View {
  Rows rows;
  const float* stage;   // (nrows, BW), STAGE only
  int64_t t;
  int cb0, BW;
  // 4 columns from c (a multiple of 4 inside the block)
  __device__ __forceinline__ float4 four(int r, int c) const {
    if (STAGE)
      return *reinterpret_cast<const float4*>(stage + r * BW + (c - cb0));
    return ldg4(rows.row(t, r) + c);
  }
  // one column c, which may lie outside the block
  __device__ __forceinline__ float one(int r, int c) const {
    if (STAGE && c >= cb0 && c < cb0 + BW) return stage[r * BW + (c - cb0)];
    return __ldg(rows.row(t, r) + c);
  }
};

// The K-sums of one method (loc/w of the tile, K terms) at the 4 points
// p0..p0+3 over the 4 columns from c, one float4 per point
template <typename V>
__device__ __forceinline__ void sums4x4(const V& v, const int* loc,
                                        const float* wt, int K, int p0,
                                        int c, float4 (&o)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const int4 l = __ldg(reinterpret_cast<const int4*>(loc + k * TILE + p0));
    const float4 w =
        __ldg(reinterpret_cast<const float4*>(wt + k * TILE + p0));
    const float4 r0 = v.four(l.x, c), r1 = v.four(l.y, c);
    const float4 r2 = v.four(l.z, c), r3 = v.four(l.w, c);
    madd4(o[0], w.x, r0, k == 0);
    madd4(o[1], w.y, r1, k == 0);
    madd4(o[2], w.z, r2, k == 0);
    madd4(o[3], w.w, r3, k == 0);
  }
}

// The K-sums of method m at the 4 points p0..p0+3, column c alone: one
// 16-byte load each of loc and w per k, then 4 independent row loads
template <typename V>
__device__ __forceinline__ float4 col_sum4(const V& v, const Methods& M,
                                           int m, int p0, int c) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (m < 0) return acc;
  const int K = M.K[m];
  const int* loc = M.loc[m] + (v.t * K) * TILE + p0;
  const float* w = M.w[m] + (v.t * K) * TILE + p0;
  for (int k = 0; k < K; ++k) {
    const int4 l = __ldg(reinterpret_cast<const int4*>(loc + k * TILE));
    const float4 wk = __ldg(reinterpret_cast<const float4*>(w + k * TILE));
    const float4 term = make_float4(
        __fmul_rn(wk.x, v.one(l.x, c)), __fmul_rn(wk.y, v.one(l.y, c)),
        __fmul_rn(wk.z, v.one(l.z, c)), __fmul_rn(wk.w, v.one(l.w, c)));
    acc = k == 0 ? term
                 : make_float4(__fadd_rn(acc.x, term.x),
                               __fadd_rn(acc.y, term.y),
                               __fadd_rn(acc.z, term.z),
                               __fadd_rn(acc.w, term.w));
  }
  return acc;
}

// The Q4 rotation of one window column at one point (quirk Q4: u first,
// then v from the ROTATED u), given the point's tana = sa / ca and
// den = ca + sa * tana: own is the column's sum, part its partner's
__device__ __forceinline__ float rotated(int role, float own, float part,
                                         float ca, float sa, float tana,
                                         float den) {
  if (role != ROLE_U && role != ROLE_V) return own;
  const float u = role == ROLE_U ? own : part;
  const float w = role == ROLE_U ? part : own;
  const float un = __fdiv_rn(__fadd_rn(u, __fmul_rn(w, tana)), den);
  if (role == ROLE_U) return un;
  return __fdiv_rn(__fsub_rn(w, __fmul_rn(un, sa)), ca);
}

// STAGED: 0 for rows read from device memory, else the blocks with staged
// rows that one SM holds (2 or 3, ell_plan's choice by the staged bytes),
// which the register budget must allow too (3 blocks of 256 threads cap a
// thread at 85 registers)
template <typename Rows, int STAGED>
__global__ void __launch_bounds__(NT, STAGED ? STAGED : 1)
ell_apply_kernel(Rows rows, float* __restrict__ out,
                 const float* __restrict__ cosa,
                 const float* __restrict__ sina, float* __restrict__ partial,
                 Methods M, const int* __restrict__ table, int Cp, int cend,
                 int ntx, int BW, int nblk) {
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  const int64_t t = blockIdx.x / nblk;
  const int j = blockIdx.x % nblk;
  const int cb0 = j * BW;
  const int cw = min(BW, Cp - cb0);
  const int CT = BW / 4, PL = NT / CT;
  const int cg = threadIdx.x % CT, lane = threadIdx.x / CT;
  const int c = cb0 + 4 * cg;

  if (STAGED && cb0 < cend) {
    const int ng = cw / 4;
    const int total = rows.nrows * ng;
    for (int i = threadIdx.x; i < total; i += NT) {
      const int r = i / ng, g = i - r * ng;
      cp_async16(stage + r * BW + 4 * g, rows.row(t, r) + cb0 + 4 * g, 16);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const View<Rows, STAGED != 0> v{rows, stage, t, cb0, BW};

  float cs = 0.0f;
  if (4 * cg < cw) {
    const int ty = (int)(t / ntx), tx = (int)(t % ntx);
    const int64_t nxp = (int64_t)ntx * TX;
    const int4 e = __ldg(reinterpret_cast<const int4*>(table + c));
    const int m = ci_method(e.x), role = ci_role(e.x);
    const int K = m >= 0 ? M.K[m] : 0;
    const int* loc = m >= 0 ? M.loc[m] + (t * K) * TILE : nullptr;
    const float* wt = m >= 0 ? M.w[m] + (t * K) * TILE : nullptr;
    // the output of point p0 + i at column c is dst(p0) + i * Cp
    auto dst = [&](int p0) {
      return out + ((int64_t)(ty * TY + p0 / TX) * nxp + (tx * TX + p0 % TX)) *
                       Cp + c;
    };
    const int es[4] = {e.x, e.y, e.z, e.w};
    bool one_method = true, rot = false;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int r = ci_role(es[jj]);
      one_method = one_method && ci_method(es[jj]) == m &&
                   ((r != ROLE_U && r != ROLE_V) || ci_pmethod(es[jj]) == m);
      rot = rot || r == ROLE_U || r == ROLE_V;
    }
    if (one_method && !rot) {
      // one method (or the tail) in all 4 columns: float4 sums
      for (int q = lane; q < TILE / 4; q += PL) {
        const int p0 = 4 * q;
        float4 o[4];
        sums4x4(v, loc, wt, K, p0, c, o);
        float* d = dst(p0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          *reinterpret_cast<float4*>(d + (int64_t)i * Cp) = o[i];
          cs = sq4(cs, o[i]);
        }
      }
    } else if (one_method) {
      // window columns among the 4, every partner of the same method:
      // float4 sums of the own columns, then scalar sums of the partners
      // (a second pass over the same loc/w, which L1 holds: fewer live
      // registers than one pass), then the rotation, with each point's
      // tana and denominator computed once. Partner rows come from the
      // staged copy when every partner lies in the block (PIN), else from
      // device memory.
      int roles[4], pcs[4];
      bool pin = STAGED != 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        roles[jj] = ci_role(es[jj]);
        pcs[jj] = ci_partner(es[jj]);
        if (roles[jj] == ROLE_U || roles[jj] == ROLE_V)
          pin = pin && pcs[jj] >= cb0 && pcs[jj] < cb0 + BW;
      }
      auto window = [&](auto pin_tag) {
        constexpr bool PIN = decltype(pin_tag)::value;
        for (int q = lane; q < TILE / 4; q += PL) {
          const int p0 = 4 * q;
          float4 o[4];
          sums4x4(v, loc, wt, K, p0, c, o);
          float pv[4][4];
          for (int k = 0; k < K; ++k) {
            const int4 l =
                __ldg(reinterpret_cast<const int4*>(loc + k * TILE + p0));
            const float4 w =
                __ldg(reinterpret_cast<const float4*>(wt + k * TILE + p0));
            const int ls[4] = {l.x, l.y, l.z, l.w};
            const float wsv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float* row =
                  PIN ? stage + ls[i] * BW - cb0 : rows.row(t, ls[i]);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                if (roles[jj] != ROLE_U && roles[jj] != ROLE_V) continue;
                const float x = PIN ? row[pcs[jj]] : __ldg(row + pcs[jj]);
                const float term = __fmul_rn(wsv[i], x);
                pv[i][jj] = k == 0 ? term : __fadd_rn(pv[i][jj], term);
              }
            }
          }
          const float4 ca4 = ldg4(cosa + t * TILE + p0);
          const float4 sa4 = ldg4(sina + t * TILE + p0);
          const float cas[4] = {ca4.x, ca4.y, ca4.z, ca4.w};
          const float sas[4] = {sa4.x, sa4.y, sa4.z, sa4.w};
          float* d = dst(p0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ca = cas[i], sa = sas[i];
            const float tana = __fdiv_rn(sa, ca);
            const float den = __fadd_rn(ca, __fmul_rn(sa, tana));
            const float4 r = make_float4(
                rotated(roles[0], o[i].x, pv[i][0], ca, sa, tana, den),
                rotated(roles[1], o[i].y, pv[i][1], ca, sa, tana, den),
                rotated(roles[2], o[i].z, pv[i][2], ca, sa, tana, den),
                rotated(roles[3], o[i].w, pv[i][3], ca, sa, tana, den));
            *reinterpret_cast<float4*>(d + (int64_t)i * Cp) = r;
            cs = sq4(cs, r);
          }
        }
      };
      if (pin)
        window(std::true_type{});
      else
        window(std::false_type{});
    } else {
      // a method edge inside the 4 columns: each column alone, its 4
      // points together, 4-byte stores
      for (int q = lane; q < TILE / 4; q += PL) {
        const int p0 = 4 * q;
        float* d = dst(p0);
#pragma unroll 1
        for (int jj = 0; jj < 4; ++jj) {
          const int ej = es[jj], role_j = ci_role(ej);
          float4 x = col_sum4(v, M, ci_method(ej), p0, c + jj);
          if (role_j == ROLE_U || role_j == ROLE_V) {
            const float4 pt =
                col_sum4(v, M, ci_pmethod(ej), p0, ci_partner(ej));
            const float4 ca = ldg4(cosa + t * TILE + p0);
            const float4 sa = ldg4(sina + t * TILE + p0);
            const float4 tana =
                make_float4(__fdiv_rn(sa.x, ca.x), __fdiv_rn(sa.y, ca.y),
                            __fdiv_rn(sa.z, ca.z), __fdiv_rn(sa.w, ca.w));
            x = make_float4(
                rotated(role_j, x.x, pt.x, ca.x, sa.x, tana.x,
                        __fadd_rn(ca.x, __fmul_rn(sa.x, tana.x))),
                rotated(role_j, x.y, pt.y, ca.y, sa.y, tana.y,
                        __fadd_rn(ca.y, __fmul_rn(sa.y, tana.y))),
                rotated(role_j, x.z, pt.z, ca.z, sa.z, tana.z,
                        __fadd_rn(ca.z, __fmul_rn(sa.z, tana.z))),
                rotated(role_j, x.w, pt.w, ca.w, sa.w, tana.w,
                        __fadd_rn(ca.w, __fmul_rn(sa.w, tana.w))));
          }
          d[jj] = x.x;
          d[(int64_t)Cp + jj] = x.y;
          d[2 * (int64_t)Cp + jj] = x.z;
          d[3 * (int64_t)Cp + jj] = x.w;
          cs = sq4(cs, x);
        }
      }
    }
  }

  if (partial != nullptr) {
    __shared__ float red[NT];
    red[threadIdx.x] = cs;
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s)
        red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + s]);
      __syncthreads();
    }
    if (threadIdx.x == 0) partial[t * nblk + j] = red[0];
  }
}

// per-tile checksum = the tile's block partials added in block order
__global__ void checksum_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ checksum,
                                       int n_tiles, int nblk) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tiles) return;
  float s = 0.0f;
  for (int j = 0; j < nblk; ++j)
    s = __fadd_rn(s, partial[(int64_t)t * nblk + j]);
  checksum[t] = s;
}

// Fills M from the C arrays of a launch; false for arguments the kernel
// does not take.
inline bool ell_args(Methods& M, const void* const* locs,
                     const void* const* ws, const int* Ks, int nm,
                     const int* table, int nr, const float* cosa,
                     const float* sina, const float* partial,
                     const float* checksum, int n_tiles, int Cp, int cend,
                     int BW) {
  if (nm < 1 || nm > MAXM || table == nullptr || Cp < 128 || Cp % 128 ||
      cend < 1 || cend > Cp ||
      !(BW == 64 || BW == 128 || BW == 256 || BW == 512) ||
      n_tiles < 1 || (nr > 0 && (cosa == nullptr || sina == nullptr)) ||
      ((partial == nullptr) != (checksum == nullptr)))
    return false;
  M.nm = nm;
  for (int m = 0; m < nm; ++m) {
    if (Ks[m] < 1) return false;
    M.loc[m] = static_cast<const int*>(locs[m]);
    M.w[m] = static_cast<const float*>(ws[m]);
    M.K[m] = Ks[m];
  }
  return true;
}

// Launches the apply (and the checksum reduction) on `stream`; stage is 0
// (rows from device memory) or the staged blocks per SM, 2 or 3. Returns
// 0, -1 for a geometry the card does not take, or the cudaError_t of a
// refused launch. Does not synchronise.
template <typename Rows>
int ell_launch(const Rows& rows, float* out, const float* cosa,
               const float* sina, float* partial, float* checksum,
               const Methods& M, const int* table, int n_tiles, int ntx,
               int Cp, int cend, int BW, int stage, cudaStream_t s) {
  const int nblk = (Cp + BW - 1) / BW;
  const int64_t nb = (int64_t)n_tiles * nblk;
  if (nb > 2147483647LL) return -1;
  const size_t smem = stage ? (size_t)rows.nrows * BW * sizeof(float) : 0;
  if (smem > 232448) return -1;
  cudaError_t err = cudaSuccess;
  switch (stage) {
    case 0:
      ell_apply_kernel<Rows, 0><<<(unsigned)nb, NT, 0, s>>>(
          rows, out, cosa, sina, partial, M, table, Cp, cend, ntx, BW, nblk);
      break;
    case 2:
      err = cudaFuncSetAttribute(ell_apply_kernel<Rows, 2>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      ell_apply_kernel<Rows, 2><<<(unsigned)nb, NT, smem, s>>>(
          rows, out, cosa, sina, partial, M, table, Cp, cend, ntx, BW, nblk);
      break;
    case 3:
      err = cudaFuncSetAttribute(ell_apply_kernel<Rows, 3>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      ell_apply_kernel<Rows, 3><<<(unsigned)nb, NT, smem, s>>>(
          rows, out, cosa, sina, partial, M, table, Cp, cend, ntx, BW, nblk);
      break;
    default:
      return -1;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (checksum != nullptr) {
    checksum_reduce_kernel<<<(n_tiles + 255) / 256, 256, 0, s>>>(
        partial, checksum, n_tiles, nblk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
