// Ragged string gather over the char matrix (kernel family "strings").
//
// Replaces the Pallas kernel spark_rapids_tpu/ops/kernels/pallas/
// strings.py::ragged_gather (body _gather_kernel). Computes
//   out[r, :] = valid[r] ? mat[clamp(idx[r], 0, n - 1), :] : PAD (-1)
// for a [n, W] int16 char matrix, int32 idx [m] and a one-byte valid [m],
// into out [m, W] int16: the flat-string branch of
// ops/kernels/rowops.py::gather_column.
//
// The Pallas kernel keeps the whole source matrix resident in VMEM and
// gathers one output block per grid step. A Hopper SM has at most 227 KB
// of shared memory, far below a [262144, 128] int16 matrix (64 MB), and
// the gather reads each source row at most a few times, so nothing is
// staged: one thread moves 16 bytes (8 chars) of one output row with one
// 16-byte load and one 16-byte store. Neighbouring threads take
// neighbouring 16-byte pieces of the same row (W = 128 gives 16 threads a
// row, two rows a warp), so a warp's loads and stores are whole 256-byte
// rows. W is a multiple of 8 by the byte ladder; the wrapper checks it and
// the 16-byte alignment of both matrices.
//
// Bound on the card: memory. The least traffic is reading idx and valid
// (5 bytes a row) and one source row per output row, and writing the
// output (2 W bytes a row each): 5 m + 4 m W bytes. Rows that are not
// valid read no source row at all.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void gather_rows(const int4* __restrict__ mat, int64_t n,
                            int64_t chunks, const int32_t* __restrict__ idx,
                            const uint8_t* __restrict__ valid, int64_t m,
                            int4* __restrict__ out) {
  const int4 pad = make_int4(-1, -1, -1, -1);  // eight int16 PADs
  int64_t total = m * chunks;
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       t < total; t += stride) {
    int64_t r = t / chunks;
    int64_t c = t - r * chunks;
    int4 v = pad;
    if (valid[r]) {
      int64_t s = idx[r];
      s = s < 0 ? 0 : (s > n - 1 ? n - 1 : s);
      v = __ldg(&mat[s * chunks + c]);
    }
    out[t] = v;
  }
}

}  // namespace

extern "C" {

// Launches the gather on `stream`; returns cudaGetLastError(). width is
// W in int16 chars and must be a multiple of 8; n >= 1 and m >= 1.
int srt_ragged_gather(const void* mat, int64_t n, int64_t width,
                      const int32_t* idx, const uint8_t* valid, int64_t m,
                      void* out, void* stream) {
  if (n < 1 || m < 1 || width < 8 || width % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t chunks = width / 8;
  int64_t total = m * chunks;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;  // grid-stride loop covers the rest
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather_rows<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const int4*>(mat), n, chunks, idx, valid, m,
      static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
