// Packed multi-method ELL apply with the slab gather inside the kernel, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
// mpassit_tpu/ops/pallas_matmul.py::fused_apply_packed_gather (body
// _kernel_packed_gather). The slab of a tile is never formed in device
// memory: its row r (a loc8 value of the chunked-run layout,
// ops/matmul_apply.py::_chunk_slab) is source row
//
//     ch_src[t, r >> 3] * 8 + (r & 7)
//
// of src (n_src + 8, Cp), the 8 extra rows letting the last chunk of a run
// read past n_src. Everything else -- the K-sum in f32, the Q4 rotation,
// the tail zeros and the checksum -- is the kernel of ell_apply.cuh that
// packed_apply.cu instantiates, so on the same operator the two kernels
// agree bit for bit.
//
// What bounds it on an H100: device-memory writes of the output, as for
// packed_apply.cu; the row reads go to src through one more indirection
// (the chunk start, a warp-uniform broadcast load). The TPU kernel
// double-buffers each tile's chunk copies into VMEM; here, where
// ops/packed_kernel.ell_plan finds that a block's columns of the tile's
// W8 chunk rows fit in shared memory, the block copies them there with
// 16-byte cp.async before its sums; at the restaggers (W8 ~ 1300 rows)
// they do not fit, and rows are read through L1/L2.

#include "ell_apply.cuh"

struct ChunkRows {
  const float* src;   // (n_src + 8, Cp)
  const int* ch;      // (n_tiles, NC) chunk starts divided by 8
  int nrows;          // W8 = 8 * NC
  int Cp;
  __device__ __forceinline__ const float* row(int64_t t, int r) const {
    const int64_t start = __ldg(ch + t * (nrows >> 3) + (r >> 3));
    return src + (start * 8 + (r & 7)) * (int64_t)Cp;
  }
};

// Returns 0, a cudaError_t from the launches, or -1 for arguments the
// kernel does not take. Launches on `stream`; does not synchronise and
// allocates nothing (partial is (n_tiles, ceil(Cp/BW)) scratch, or null
// with checksum null).
extern "C" int packed_gather_launch(
    const float* src, const int* ch, int NC, float* out,
    const void* const* locs, const void* const* ws, const int* Ks, int nm,
    const int* table, int nr, const float* cosa, const float* sina,
    float* partial, float* checksum, int n_tiles, int ntx, int Cp, int cend,
    int BW, int stage, void* stream) {
  Methods M;
  if (NC < 1 || NC > (1 << 27) ||
      !ell_args(M, locs, ws, Ks, nm, table, nr, cosa, sina, partial,
                checksum, n_tiles, Cp, cend, BW))
    return -1;
  return ell_launch(ChunkRows{src, ch, NC * 8, Cp}, out, cosa, sina, partial,
                    checksum, M, table, n_tiles, ntx, Cp, cend, BW, stage,
                    static_cast<cudaStream_t>(stream));
}
