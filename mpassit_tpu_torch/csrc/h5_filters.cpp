// Decoders of two HDF5 filters whose loops run per bit or per byte: szip
// (HDF5 filter 4, the CCSDS 121.0-B adaptive Rice coder as libaec decodes it
// behind its szip interface) and LZF (filter 32000, the format of h5py's
// lzf_filter.c on liblzf). Plain C interface, loaded with ctypes by
// mpassit_tpu_torch/io/h5filters.py, which builds this file with g++.
//
// Each function writes at most n_out bytes to out and returns the bytes it
// wrote, or a negative code:
//   -1  the output does not fit in n_out bytes (LZF)
//   -2  an LZF back-reference before the start of the output
//   -3  the input ends inside an LZF literal run or back-reference
//   -4  a szip second-extension code past the table (corrupt input)
//   -5  szip parameters out of range
//   -6  the szip stream ends before the bytes asked for
//   -7  a szip zero-block run past its reference sample interval
//   -8  the decoder could not allocate its buffers

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---- LZF -----------------------------------------------------------------

int64_t lzf(const uint8_t* in, int64_t n_in, uint8_t* out, int64_t n_out) {
  const uint8_t* ip = in;
  const uint8_t* in_end = in + n_in;
  int64_t op = 0;
  while (ip < in_end) {
    unsigned ctrl = *ip++;
    if (ctrl < 32) {                      // a literal run of ctrl + 1 bytes
      int64_t len = ctrl + 1;
      if (op + len > n_out) return -1;
      if (ip + len > in_end) return -3;
      std::memcpy(out + op, ip, len);
      op += len;
      ip += len;
    } else {                              // a back-reference
      int64_t len = ctrl >> 5;
      int64_t back = ((int64_t)(ctrl & 0x1f) << 8) + 1;
      if (len == 7) {
        if (ip >= in_end) return -3;
        len += *ip++;
      }
      if (ip >= in_end) return -3;
      back += *ip++;
      len += 2;
      if (op + len > n_out) return -1;
      if (back > op) return -2;
      // the source may overlap the bytes being written: byte by byte
      for (int64_t i = 0; i < len; i++, op++) out[op] = out[op - back];
    }
  }
  return op;
}

// ---- szip (CCSDS 121.0-B) --------------------------------------------------

// MSB-first bit reader; a read past the end sets `over`
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;                              // valid bits in the low end of acc
  bool over = false;

  void fill() {
    while (n <= 56 && p < end) {
      acc = (acc << 8) | *p++;
      n += 8;
    }
  }
  uint32_t get(int k) {                   // k <= 32
    if (k == 0) return 0;
    if (n < k) fill();
    if (n < k) {
      over = true;
      return 0;
    }
    n -= k;
    return (uint32_t)((acc >> n) & ((1ull << k) - 1));
  }
  // a fundamental sequence: the count of 0 bits before the next 1 bit
  uint32_t fs() {
    uint32_t count = 0;
    for (;;) {
      if (n == 0) fill();
      if (n == 0) {
        over = true;
        return 0;
      }
      uint64_t x = n == 64 ? acc : acc & ((1ull << n) - 1);
      if (x == 0) {
        count += n;
        n = 0;
        continue;
      }
      int hb = 63 - __builtin_clzll(x);
      count += (n - 1) - hb;
      n = hb;
      return count;
    }
  }
};

int64_t szip(const uint8_t* in, int64_t n_in, uint8_t* out, int64_t n_out,
             int mask, int ppb, int bpp, int pps) {
  // SZ_BufftoBuffDecompress: 32- and 64-bit pixels are coded as byte planes
  // of 8-bit samples; a scanline that is not a whole number of blocks is
  // coded padded to one
  if (ppb <= 0 || pps <= 0 || bpp <= 0 || (bpp > 32 && bpp != 64)) return -5;
  const bool msb = mask & 16, pp = mask & 32;
  const bool interleave = bpp == 32 || bpp == 64;
  const int n = interleave ? 8 : bpp;
  const int psize = n > 16 ? 4 : (n > 8 ? 2 : 1);
  const int64_t block = ppb, rsi = (pps + ppb - 1) / ppb;
  const bool pad = pps % ppb;
  int64_t scanlines = 0, buf_size = n_out;
  if (pad || interleave) {
    scanlines = (n_out / psize + pps - 1) / pps;
    buf_size = rsi * block * psize * scanlines;
  }
  const int64_t max_samples = buf_size / psize;

  // second extension: gamma -> (beta, the gamma at which beta starts)
  int se_beta[91], se_ms[91];
  for (int i = 0, k = 0; i < 13; i++)
    for (int j = 0, ms = k; j <= i; j++, k++) {
      se_beta[k] = i;
      se_ms[k] = ms;
    }

  const int id_len = n > 16 ? 5 : (n > 8 ? 4 : 3);
  const uint32_t id_uncomp = (1u << id_len) - 1;
  const uint32_t xmax = (uint32_t)((1ull << n) - 1), med = xmax / 2 + 1;
  std::vector<uint8_t> buf(buf_size);
  std::vector<uint32_t> codes;
  codes.reserve(64 * block);
  Bits bits{in, in + n_in};
  int64_t done = 0;                       // samples written to buf
  uint32_t last = 0;                      // the preprocessor's prediction
  while (done < max_samples) {            // one reference sample interval
    int64_t used = 0;
    while (used < rsi * block && done < max_samples) {
      const bool ref = pp && used == 0;
      codes.clear();
      uint32_t id = bits.get(id_len);
      if (bits.over) break;
      if (id == 0) {                      // low entropy
        uint32_t se = bits.get(1);
        if (ref) codes.push_back(bits.get(n));
        if (se) {                         // second extension
          for (int64_t i = ref; i < block && !bits.over;) {
            uint32_t m = bits.fs();
            if (m > 90) return -4;
            uint32_t d1 = m - se_ms[m];
            if ((i & 1) == 0) {
              codes.push_back(se_beta[m] - d1);
              i++;
            }
            codes.push_back(d1);
            i++;
          }
        } else {                          // zero blocks
          int64_t z = (int64_t)bits.fs() + 1;
          if (z == 5) {                   // to the end of the segment
            int64_t b = used / block;
            z = rsi - b < 64 - b % 64 ? rsi - b : 64 - b % 64;
          } else if (z > 5) {
            z--;
          }
          // as libaec: a run never leaves its interval (this also bounds
          // the buffer a corrupt run length could ask for)
          if (z * block > rsi * block - used) return -7;
          codes.resize(codes.size() + z * block - ref, 0);
        }
      } else if (id == id_uncomp) {       // no compression
        for (int64_t i = 0; i < block; i++) codes.push_back(bits.get(n));
      } else {                            // Rice split, k = id - 1
        const int k = id - 1;
        if (ref) codes.push_back(bits.get(n));
        size_t start = codes.size();
        for (int64_t i = ref; i < block; i++)
          codes.push_back(bits.fs() << k);
        if (k)
          for (size_t i = start; i < codes.size(); i++)
            codes[i] += bits.get(k);
      }
      if (bits.over) break;               // the stream ended in this block
      for (size_t i = 0; i < codes.size() && done < max_samples; i++) {
        uint32_t d = codes[i];
        if (pp) {
          if (used + (int64_t)i == 0) {
            last = d;
          } else {                        // the unit-delay predictor
            uint32_t half = (d >> 1) + (d & 1);
            uint32_t mk = (last & med) ? xmax : 0;
            if (half <= (mk ^ last))
              last += (d >> 1) ^ (~((d & 1) - 1));
            else
              last = mk ^ d;
          }
          d = last;
        }
        uint8_t* o = buf.data() + done * psize;
        for (int b = 0; b < psize; b++)
          o[b] = (uint8_t)(d >> (8 * (msb ? psize - 1 - b : b)));
        done++;
      }
      used += codes.size();
    }
    if (bits.over) break;
  }
  // the samples that hold the last byte asked for (with padding, its
  // place in the padded scanlines): fewer, and the stream was cut short
  int64_t need = n_out / psize;
  if (pad && need)
    need = (need - 1) / pps * rsi * block + (need - 1) % pps + 1;
  if (done < need) return -6;
  int64_t total = done * psize;
  if (pad) {                              // drop each scanline's padding
    const int64_t line = (int64_t)pps * psize;
    const int64_t padded = rsi * block * psize;
    int64_t i = line;
    for (int64_t j = padded; j < total; j += padded, i += line)
      std::memmove(buf.data() + i, buf.data() + j, line);
    total = scanlines * line;
  }
  if (total > n_out) total = n_out;
  if (interleave) {                       // byte planes back into words
    const int ws = bpp / 8;
    const int64_t words = total / ws;
    for (int64_t i = 0; i < words; i++)
      for (int j = 0; j < ws; j++) out[i * ws + j] = buf[j * words + i];
  } else {
    std::memcpy(out, buf.data(), total);
  }
  return total;
}

}  // namespace

extern "C" {

// no C++ exception crosses into the caller (ctypes): a failed allocation
// is an error code

int64_t h5_lzf_decode(const uint8_t* in, int64_t n_in, uint8_t* out,
                      int64_t n_out) {
  return lzf(in, n_in, out, n_out);
}

int64_t h5_szip_decode(const uint8_t* in, int64_t n_in, uint8_t* out,
                       int64_t n_out, int mask, int ppb, int bpp, int pps) {
  try {
    return szip(in, n_in, out, n_out, mask, ppb, bpp, pps);
  } catch (...) {
    return -8;
  }
}

}  // extern "C"
