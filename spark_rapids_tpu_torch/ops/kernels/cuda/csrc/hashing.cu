// Spark's murmur3 string row hash (kernel family "hash").
//
// Replaces the Pallas kernel spark_rapids_tpu/ops/kernels/pallas/
// hashing.py::murmur3_bytes_rows (body _murmur3_rows_kernel). Computes,
// for each row r of an int16 char matrix mat [n, W] (PAD -1 past each
// row's end), Spark's Murmur3_x86_32.hashUnsafeBytes with per-row seed
// seed[r] and byte length len = lengths[r]:
//   h = seed[r]
//   for each full 4-byte little-endian block b (4b + 4 <= len, b < W/4):
//     h = mix_h1(h, mix_k1(block))
//   for each tail byte at [4 * (len / 4), min(len, W)):
//     h = mix_h1(h, mix_k1((uint32) signed byte))
//   out[r] = fmix(h ^ len)
// bit for bit as shuffle/partitioning.py::murmur3_bytes_rows (a PAD char
// reads as 0; a negative length hashes no byte).
//
// The Pallas kernel holds a [256, W] block in VMEM and folds over all W
// positions with masks. Here one thread owns one row and walks only that
// row's ceil(len / 8) vector loads of 8 chars (16 bytes; 4 chars, 8 bytes,
// when W % 8 != 0), so it reads nothing past the row's length rounded up
// to one load.
//
// Bound on the card: memory. The least traffic is lengths, seed and out
// (12 bytes a row) plus the sectors of chars each row's length needs
// (one 32-byte sector for a string of up to 16 bytes). Neighbouring
// threads read rows 2 W bytes apart, so every row costs its own sector:
// the design moves exactly that least traffic for short strings.

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
__device__ __forceinline__ uint32_t block_byte(int16_t c) {
  return c == -1 ? 0u : static_cast<uint32_t>(static_cast<int32_t>(c));
}

// A char as a tail byte: Spark reads it as a signed Java byte.
__device__ __forceinline__ uint32_t tail_byte(int16_t c) {
  int32_t s = c == -1 ? 0 : static_cast<int32_t>(c);
  if (s > 127) s -= 256;
  return static_cast<uint32_t>(s);
}

template <int kChars>
struct VecOf;
template <>
struct VecOf<8> {
  using type = int4;  // 16 bytes
};
template <>
struct VecOf<4> {
  using type = int2;  // 8 bytes
};

template <int kChars>
__global__ void murmur3_rows(const int16_t* __restrict__ mat, int64_t n,
                             int64_t w, const int32_t* __restrict__ lengths,
                             const uint32_t* __restrict__ seed,
                             uint32_t* __restrict__ out) {
  using Vec = typename VecOf<kChars>::type;
  union Chars {
    Vec v;
    int16_t c[kChars];
  };
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       r < n; r += stride) {
    int32_t len = lengths[r];
    uint32_t h = seed[r];
    int64_t blocks = 0, end = 0;
    if (len > 0) {
      int64_t l = len;
      blocks = l / 4 < w / 4 ? l / 4 : w / 4;
      end = l < w ? l : w;
    }
    const Vec* row = reinterpret_cast<const Vec*>(mat + r * w);
    for (int64_t base = 0; base < end; base += kChars) {
      Chars ch;
      ch.v = __ldg(row + base / kChars);
#pragma unroll
      for (int j = 0; j < kChars; j += 4) {
        int64_t pos = base + j;
        if (pos / 4 < blocks) {
          uint32_t k1 = block_byte(ch.c[j]) | (block_byte(ch.c[j + 1]) << 8) |
                        (block_byte(ch.c[j + 2]) << 16) |
                        (block_byte(ch.c[j + 3]) << 24);
          h = mix_h1(h, mix_k1(k1));
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (pos + t < end) h = mix_h1(h, mix_k1(tail_byte(ch.c[j + t])));
          }
        }
      }
    }
    out[r] = fmix(h, static_cast<uint32_t>(len));
  }
}

}  // namespace

extern "C" {

// Launches the hash on `stream`; returns cudaGetLastError(). width is W
// in int16 chars, a positive multiple of 4; mat is 16-byte aligned; n >= 1.
int srt_murmur3_rows(const void* mat, int64_t n, int64_t width,
                     const int32_t* lengths, const uint32_t* seed, void* out,
                     void* stream) {
  if (n < 1 || width < 4 || width % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;  // grid-stride loop covers the rest
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int16_t* m = static_cast<const int16_t*>(mat);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (width % 8 == 0) {
    murmur3_rows<8><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        m, n, width, lengths, seed, o);
  } else {
    murmur3_rows<4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        m, n, width, lengths, seed, o);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
