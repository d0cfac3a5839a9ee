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
// What bounds it on an H100: device-memory writes. The output is
// (nty*32, ntx*32, Cp) f32 -- 8.1 GB per pass at the CONUS grid and
// Cp = 1024 -- while the slab a tile reads is ~W*Cp*4 bytes (W ~ 16-40
// rows) and is re-read from L1/L2 for each of the tile's 1024 points.
// The design therefore keeps the write stream coalesced (see
// ell_apply.cuh). Shared-memory staging, TMA and wgmma are not used.

#include "ell_apply.cuh"

struct SlabRows {
  const float* slab;   // (n_tiles, W, Cp)
  int W;
  int Cp;
  struct Tile {
    const float* base;
    int Cp;
    __device__ __forceinline__ float operator()(int64_t r, int c) const {
      return __ldg(base + r * Cp + c);
    }
  };
  __device__ __forceinline__ Tile tile(int64_t t) const {
    return Tile{slab + t * (int64_t)W * Cp, Cp};
  }
};

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
  Methods M;
  Windows R;
  if (!ell_args(M, R, locs, ws, Ks, c0s, c1s, nm, cus, cvs, ns, nr, cosa,
                sina, partial, checksum, n_tiles, Cp))
    return -1;
  return ell_launch(SlabRows{slab, W, Cp}, out, cosa, sina, partial,
                    checksum, M, R, n_tiles, ntx, Cp,
                    static_cast<cudaStream_t>(stream));
}
