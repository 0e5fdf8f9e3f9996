// The char-matrix kernels of the "strings" family: the ragged gather and
// the rowwise compare.
//
// 1. srt_ragged_gather replaces the Pallas kernel
// spark_rapids_tpu/ops/kernels/pallas/strings.py::ragged_gather (body
// _gather_kernel). Computes
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
//
// 2. srt_row_equal replaces the Pallas kernel pallas/strings.py::
// ragged_row_equal (body _row_equal_kernel). Computes
//   out[r] = all(a[r, :] == b[r, :])
// for two [n, W] int16 char matrices, one byte a row: the string branch of
// ops/kernels/groupby.py::_equal_adjacent, where a and b are the sorted
// char matrix and the same matrix one row back (two views of one buffer,
// one row apart).
//
// The Pallas kernel compares [block, W] VMEM tiles. Here a group of L
// lanes of one warp owns a row (L the power of two at or above the row's
// vector count, at most 32) and reads it with coalesced vector loads; the
// warp's ballot gives each group its row's answer, and the group's first
// lane writes the byte. The vector is the widest of 16, 8, 4 or 2 bytes
// that both row pointers and the row pitch (2 W bytes) allow: W % 8 == 0
// and 16-byte aligned rows take 16-byte loads (W = 128: 16 lanes a row,
// two rows a warp); the view m[1:] of a W = 12 matrix sits 24 bytes in,
// so it takes 8-byte loads. The compare is on the raw bits of int16
// chars, so PAD (-1) and a byte above 127 (0x00ff) never meet. The loop
// over row groups strides by the whole grid, so any n runs on a bounded
// grid.
//
// Bound on the card: memory. Each input read once and one byte written a
// row: 4 n W + n bytes, or 2 (n + 1) W + n when a and b are the two views
// of one matrix.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 16384;

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

__device__ __forceinline__ bool same(int4 x, int4 y) {
  return x.x == y.x && x.y == y.y && x.z == y.z && x.w == y.w;
}
__device__ __forceinline__ bool same(int2 x, int2 y) {
  return x.x == y.x && x.y == y.y;
}
__device__ __forceinline__ bool same(int x, int y) { return x == y; }
__device__ __forceinline__ bool same(short x, short y) { return x == y; }

// V: the load vector; per_row: V's a row; lanes_log2: log2 of the lanes
// that share a row. blockDim.x is a multiple of 32, so every warp is whole
// and the loop condition (a function of the warp alone) is warp-uniform.
template <typename V>
__global__ void row_equal(const V* __restrict__ a, const V* __restrict__ b,
                          int64_t n, int64_t per_row, int lanes_log2,
                          uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int group = 1 << lanes_log2;
  const int rows_per_warp = 32 >> lanes_log2;
  const int sub = lane & (group - 1);
  const int slot = lane >> lanes_log2;
  const unsigned mask =
      group == 32 ? 0xffffffffu : ((1u << group) - 1u) << (slot * group);
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t first = warp * rows_per_warp; first < n;
       first += warps * rows_per_warp) {
    const int64_t row = first + slot;
    bool eq = true;
    if (row < n) {
      const V* ra = a + row * per_row;
      const V* rb = b + row * per_row;
      for (int64_t c = sub; eq && c < per_row; c += group)
        eq = same(__ldg(ra + c), __ldg(rb + c));
    }
    const unsigned votes = __ballot_sync(0xffffffffu, eq);
    if (sub == 0 && row < n) out[row] = (votes & mask) == mask;
  }
}

template <typename V>
int launch_row_equal(const void* a, const void* b, int64_t n, int64_t width,
                     uint8_t* out, cudaStream_t s) {
  const int64_t per_row = 2 * width / static_cast<int64_t>(sizeof(V));
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (int64_t{1} << lanes_log2) < per_row) ++lanes_log2;
  const int64_t rows_per_block = (kThreads / 32) * (32 >> lanes_log2);
  int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  row_equal<V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const V*>(a), static_cast<const V*>(b), n, per_row,
      lanes_log2, out);
  return static_cast<int>(cudaGetLastError());
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

// Launches the rowwise compare on `stream`; returns cudaGetLastError().
// a and b are [n, width] int16 with rows 2 * width bytes apart; vec_bytes
// (16, 8, 4 or 2) divides 2 * width and both pointers' addresses. n >= 1,
// width >= 1.
int srt_row_equal(const void* a, const void* b, int64_t n, int64_t width,
                  int vec_bytes, uint8_t* out, void* stream) {
  if (n < 1 || width < 1 || vec_bytes < 2 || (2 * width) % vec_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch_row_equal<int4>(a, b, n, width, out, s);
    case 8: return launch_row_equal<int2>(a, b, n, width, out, s);
    case 4: return launch_row_equal<int>(a, b, n, width, out, s);
    case 2: return launch_row_equal<short>(a, b, n, width, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
