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
// (the chunk start, a warp-uniform broadcast load) and hit L1/L2 as the
// slab reads do. The TPU kernel double-buffers each tile's chunk copies
// into VMEM; the counterpart here (cp.async or TMA into shared memory) is
// later work: at the restagger W8 is ~1300 rows x 128 columns x 4 B, more
// than the 227 KB of shared memory a block can hold, so a staged design has
// to split the columns.

#include "ell_apply.cuh"

struct ChunkRows {
  const float* src;   // (n_src + 8, Cp)
  const int* ch;      // (n_tiles, NC) chunk starts divided by 8
  int NC;
  int Cp;
  struct Tile {
    const float* src;
    const int* ch;
    int Cp;
    __device__ __forceinline__ float operator()(int64_t r, int c) const {
      const int64_t row = (int64_t)__ldg(ch + (r >> 3)) * 8 + (r & 7);
      return __ldg(src + row * Cp + c);
    }
  };
  __device__ __forceinline__ Tile tile(int64_t t) const {
    return Tile{src, ch + t * NC, Cp};
  }
};

// Returns 0, a cudaError_t from the launches, or -1 for arguments the
// kernel does not take. Launches on `stream`; does not synchronise and
// allocates nothing (partial is (n_tiles, Cp/128) scratch, or null with
// checksum null).
extern "C" int packed_gather_launch(
    const float* src, const int* ch, int NC, float* out,
    const void* const* locs, const void* const* ws, const int* Ks,
    const int* c0s, const int* c1s, int nm, const int* cus, const int* cvs,
    const int* ns, int nr, const float* cosa, const float* sina,
    float* partial, float* checksum, int n_tiles, int ntx, int Cp,
    void* stream) {
  Methods M;
  Windows R;
  if (NC < 1 || !ell_args(M, R, locs, ws, Ks, c0s, c1s, nm, cus, cvs, ns,
                          nr, cosa, sina, partial, checksum, n_tiles, Cp))
    return -1;
  return ell_launch(ChunkRows{src, ch, NC, Cp}, out, cosa, sina, partial,
                    checksum, M, R, n_tiles, ntx, Cp,
                    static_cast<cudaStream_t>(stream));
}
