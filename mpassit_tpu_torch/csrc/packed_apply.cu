// Packed multi-method ELL apply for Hopper (sm_90a).
//
// Replaces the ELL-direct branch of the TPU kernel
// mpassit_tpu/ops/pallas_matmul.py::fused_apply_packed (locs=/ws=, body
// _kernel_packed -> _build_A_vmem -> _packed_core). For each 32x32 target
// tile t, method m with packed column range [c0, c1) and target point p:
//
//     out[t rows, c0:c1] = sum_k ws_m[t,k,p] * slab[t, locs_m[t,k,p], c0:c1]
//
// then the optional Q4 wind rotation, tail zeros and per-tile checksum of
// ell_apply.cuh, whose kernel this file instantiates with the slab as the
// row source.
//
// The TPU kernel builds a one-hot A per tile and feeds the MXU bf16-split
// operands; none of that carries over. Here the sum is computed directly:
// K indexed loads and K multiply-adds per output value, in f32.
//
// What bounds it on an H100: device-memory writes of the output, which is
// (nty*32, ntx*32, Cp) f32 -- 8.1 GB per pass at the CONUS grid and
// Cp = 1024 -- while the slab a tile reads is ~W*Cp*4 bytes (W ~ 16-40
// rows at the pack, ~1100 at the restaggers). The template (ell_apply.cuh)
// keeps the write stream in 16-byte coalesced stores, stages the slab rows
// of a block's columns in shared memory where ops/packed_kernel.ell_plan
// finds that they fit, and keeps 4 points' row loads in flight per thread.

#include "ell_apply.cuh"

struct SlabRows {
  const float* slab;   // (n_tiles, nrows, Cp)
  int nrows;
  int Cp;
  __device__ __forceinline__ const float* row(int64_t t, int r) const {
    return slab + (t * nrows + r) * (int64_t)Cp;
  }
};

// Returns 0, a cudaError_t from the launches, or -1 for arguments the
// kernel does not take. Launches on `stream`; does not synchronise and
// allocates nothing (partial is (n_tiles, ceil(Cp/BW)) scratch, or null
// with checksum null). table is ell_plan's (Cp,) int32 column table on the
// device.
extern "C" int packed_apply_launch(
    const float* slab, float* out, const void* const* locs,
    const void* const* ws, const int* Ks, int nm, const int* table, int nr,
    const float* cosa, const float* sina, float* partial, float* checksum,
    int n_tiles, int ntx, int W, int Cp, int cend, int BW, int stage,
    void* stream) {
  Methods M;
  if (W < 1 || !ell_args(M, locs, ws, Ks, nm, table, nr, cosa, sina, partial,
                         checksum, n_tiles, Cp, cend, BW))
    return -1;
  return ell_launch(SlabRows{slab, W, Cp}, out, cosa, sina, partial,
                    checksum, M, table, n_tiles, ntx, Cp, cend, BW, stage,
                    static_cast<cudaStream_t>(stream));
}
