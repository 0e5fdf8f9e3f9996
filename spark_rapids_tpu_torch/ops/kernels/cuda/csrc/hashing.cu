// Spark's murmur3 string row hash (kernel family "hash").
//
// Replaces the Pallas kernel spark_rapids_tpu/ops/kernels/pallas/
// hashing.py::murmur3_bytes_rows (body _murmur3_rows_kernel). Computes,
// for each row r with byte length len = lengths[r], clipped at W bytes,
// Spark's Murmur3_x86_32.hashUnsafeBytes with per-row seed seed[r]:
//   h = seed[r]
//   for each full 4-byte little-endian block b (4b + 4 <= len, b < W/4):
//     h = mix_h1(h, mix_k1(block))
//   for each tail byte at [4 * (len / 4), min(len, W)):
//     h = mix_h1(h, mix_k1((uint32) signed byte))
//   out[r] = fmix(h ^ len)
// bit for bit as shuffle/partitioning.py::murmur3_bytes_rows (a negative
// length hashes no byte). One __device__ loop does the mixing, templated
// on where a row's bytes come from:
//
//   * srt_murmur3_rows: an int16 char matrix mat [n, W] (PAD -1 past each
//     row's end, read as 0), the Pallas kernel's input. A block is one
//     8-byte load of 4 chars.
//   * srt_murmur3_string_rows: the column's own layout, a uint8 payload
//     and int32 offsets; row r is entry codes[r] (clamped into the
//     dictionary) of a dictionary column, or entry r of a flat one. Its
//     bytes are payload[clamp(offsets[e] + i, 0, payload_len - 1)] for
//     i < min(len, W), which is what the char matrix of the column holds,
//     so both entries give the same hash. No [n, W] matrix is built.
//
// The Pallas kernel holds a [256, W] block in VMEM and folds over all W
// positions with masks. Here one thread owns one row and walks only that
// row's blocks and tail. (Four rows a thread, their codes and seeds
// loaded first, measured slower at lineitem's 8,388,608 rows.)
//
// Bound on the card: memory. Matrix entry: lengths, seed and out (12 bytes
// a row) plus the 32-byte sectors of chars each row's length needs
// (neighbouring rows lie 2 W bytes apart). Ragged entry: the code or the
// offsets, seed and out (12 bytes a row) plus the payload bytes, read
// once: a dictionary's few bytes stay in L2, a flat column's rows are
// contiguous, so a warp's byte loads fall on the same sectors.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl32(k1, 15);
  return k1 * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t len) {
  h1 ^= len;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  return h1 ^ (h1 >> 16);
}

// A char as a block byte: PAD reads as 0, anything else as its int32
// value's bits (the plain version's astype(uint32)).
__device__ __forceinline__ uint32_t block_byte(int32_t c) {
  return c == -1 ? 0u : static_cast<uint32_t>(c);
}

// A char as a tail byte: Spark reads it as a signed Java byte.
__device__ __forceinline__ uint32_t tail_byte(int32_t c) {
  int32_t s = c == -1 ? 0 : c;
  if (s > 127) s -= 256;
  return static_cast<uint32_t>(s);
}

__device__ __forceinline__ uint32_t block_of(int32_t c0, int32_t c1,
                                             int32_t c2, int32_t c3) {
  return block_byte(c0) | (block_byte(c1) << 8) | (block_byte(c2) << 16) |
         (block_byte(c3) << 24);
}

// Row r of an int16 char matrix; W % 4 == 0 and the matrix 8-byte
// aligned, so block b is one aligned 8-byte load.
struct MatrixRow {
  const int16_t* row;
  __device__ uint32_t block(int64_t b) const {
    union {
      int2 v;
      int16_t c[4];
    } ch;
    ch.v = __ldg(reinterpret_cast<const int2*>(row) + b);
    return block_of(ch.c[0], ch.c[1], ch.c[2], ch.c[3]);
  }
  __device__ uint32_t tail(int64_t p) const {
    return tail_byte(__ldg(row + p));
  }
};

// A row of a payload + offsets layout starting at byte `start`; reads
// clamp into the payload as the char matrix's gather does.
struct RaggedRow {
  const uint8_t* payload;
  int64_t payload_len;
  int64_t start;
  __device__ int32_t at(int64_t i) const {
    int64_t q = start + i;
    q = q < 0 ? 0 : (q >= payload_len ? payload_len - 1 : q);
    return __ldg(payload + q);
  }
  __device__ uint32_t block(int64_t b) const {
    return block_of(at(4 * b), at(4 * b + 1), at(4 * b + 2), at(4 * b + 3));
  }
  __device__ uint32_t tail(int64_t p) const { return tail_byte(at(p)); }
};

template <class Row>
__device__ __forceinline__ uint32_t murmur3_row(const Row& row, int32_t len,
                                                int64_t w, uint32_t h) {
  if (len > 0) {
    int64_t l = len;
    int64_t blocks = l / 4 < w / 4 ? l / 4 : w / 4;
    for (int64_t b = 0; b < blocks; ++b) h = mix_h1(h, mix_k1(row.block(b)));
    int64_t end = l < w ? l : w;
    for (int64_t p = l / 4 * 4; p < end; ++p)
      h = mix_h1(h, mix_k1(row.tail(p)));
  }
  return fmix(h, static_cast<uint32_t>(len));
}

__global__ void __launch_bounds__(kThreads)
    murmur3_rows(const int16_t* __restrict__ mat, int64_t n, int64_t w,
                 const int32_t* __restrict__ lengths,
                 const uint32_t* __restrict__ seed,
                 uint32_t* __restrict__ out) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       r < n; r += stride) {
    out[r] = murmur3_row(MatrixRow{mat + r * w}, lengths[r], w, seed[r]);
  }
}

// codes == nullptr: a flat column, row r is entry r.
__global__ void __launch_bounds__(kThreads)
    murmur3_string_rows(const uint8_t* __restrict__ payload,
                        int64_t payload_len,
                        const int32_t* __restrict__ offsets, int64_t entries,
                        const int32_t* __restrict__ codes, int64_t n,
                        int64_t w, const uint32_t* __restrict__ seed,
                        uint32_t* __restrict__ out) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       r < n; r += stride) {
    int64_t e = r;
    if (codes != nullptr) {
      int32_t c = codes[r];
      e = c < 0 ? 0 : (c >= entries ? entries - 1 : c);
    }
    int32_t start = __ldg(offsets + e);
    // int32 difference, wrapping as the plain version's does
    int32_t len = static_cast<int32_t>(static_cast<uint32_t>(
        __ldg(offsets + e + 1)) - static_cast<uint32_t>(start));
    out[r] = murmur3_row(RaggedRow{payload, payload_len, start}, len, w,
                         seed[r]);
  }
}

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;  // grid-stride loops cover the rest
  return static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" {

// Launches the matrix hash on `stream`; returns cudaGetLastError(). width
// is W in int16 chars, a positive multiple of 4; mat is 16-byte aligned;
// n >= 1.
int srt_murmur3_rows(const void* mat, int64_t n, int64_t width,
                     const int32_t* lengths, const uint32_t* seed, void* out,
                     void* stream) {
  if (n < 1 || width < 4 || width % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  murmur3_rows<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(
                                                stream)>>>(
      static_cast<const int16_t*>(mat), n, width, lengths, seed,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Launches the ragged hash on `stream`; returns cudaGetLastError().
// offsets holds entries + 1 values; codes (n of them) may be null for a
// flat column, whose n is entries; payload_len >= 1, entries >= 1 with
// codes, width >= 1, n >= 1.
int srt_murmur3_string_rows(const void* payload, int64_t payload_len,
                            const int32_t* offsets, int64_t entries,
                            const int32_t* codes, int64_t n, int64_t width,
                            const uint32_t* seed, void* out, void* stream) {
  if (n < 1 || width < 1 || payload_len < 1 || entries < 1 ||
      (codes == nullptr && n != entries))
    return static_cast<int>(cudaErrorInvalidValue);
  murmur3_string_rows<<<grid_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), payload_len, offsets, entries,
      codes, n, width, seed, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
