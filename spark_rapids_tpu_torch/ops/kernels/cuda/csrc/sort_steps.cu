// Bitonic argsort of a packed, unique int64 key lane (kernel family
// "sortStep").
//
// Replaces the Pallas kernel spark_rapids_tpu/ops/kernels/pallas/
// sort_steps.py::packed_argsort (body _bitonic_kernel). The lane is
// ops/kernels/rowops.py::packed_sort_lane's
//   [bit 63: 0][4: dead 8 | null bucket + 4][32: key + 2^31][27: row index]
// so every lane is unique and the ascending order of the lanes is the
// stable sort order of the unpacked operands. The kernel pads the lane to
// a power of two n2 with INT64_MAX (above every packed lane), sorts it
// ascending with a bitonic network, and writes the low 27 bits of the
// first n sorted lanes: the sorting permutation, int32.
//
// The Pallas kernel keeps the whole padded lane in VMEM (8 MB) and runs
// every compare-exchange step there. A Hopper SM has at most 227 KB of
// shared memory and the port sorts up to 2^27 lanes (1 GB), so the network
// is split by stride:
//   * steps whose stride j is below kBlock (4096 lanes, 32 KB) run inside
//     one block in shared memory: local_sort runs every stage k <= kBlock
//     on each 4096-lane chunk, and local_merge finishes a larger stage k
//     (its strides kBlock/2 .. 1) on each chunk;
//   * steps with stride j >= kBlock are one global pass each
//     (global_step, one thread per compare-exchange pair).
// A stage k sorts ascending where (index & k) == 0 and descending
// elsewhere, the textbook network; unique lanes make its unstable
// exchanges give the one sorted order.
//
// Bound on the card: memory. The least traffic for the function is
// reading the lane (8 bytes a row) and writing the permutation (4 bytes):
// 12 n bytes. This design reads and writes the padded lane once per
// global step and once per shared-memory pass: for n2 = 2^23 that is
// 66 global passes and 12 shared passes of 128 MB each, about 80 times the
// bound. A stable LSD radix sort over bits 27..62 is the later redesign.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int64_t kBlock = 4096;  // lanes per shared-memory chunk (32 KB)
constexpr int kThreads = 1024;
constexpr int64_t kPad = INT64_MAX;
constexpr int64_t kIndexMask = (int64_t{1} << 27) - 1;

unsigned grid_for(int64_t threads) {
  int64_t blocks = (threads + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 65536) blocks = 65536;  // grid-stride loops cover the rest
  return static_cast<unsigned>(blocks);
}

// The first index of compare-exchange pair p at stride j (a power of two).
__device__ __forceinline__ int64_t pair_low(int64_t p, int64_t j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

__global__ void pad_copy(const int64_t* __restrict__ lane, int64_t n,
                         int64_t n2, int64_t* __restrict__ buf) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * 256;
  for (int64_t i = blockIdx.x * int64_t{256} + threadIdx.x; i < n2;
       i += stride)
    buf[i] = i < n ? lane[i] : kPad;
}

// Compare-exchange of s[i] and s[i + j] in shared memory; g is the global
// index of s[0].
__device__ __forceinline__ void exchange_shared(int64_t* s, int64_t i,
                                                int64_t j, int64_t g,
                                                int64_t k) {
  int64_t a = s[i], b = s[i + j];
  bool up = ((g + i) & k) == 0;
  if ((a > b) == up) {
    s[i] = b;
    s[i + j] = a;
  }
}

// Sorts each chunk of c lanes (c = min(n2, kBlock)) through every stage
// k <= c.
__global__ void local_sort(int64_t* __restrict__ buf, int64_t c) {
  __shared__ int64_t s[kBlock];
  int64_t base = blockIdx.x * c;
  for (int64_t i = threadIdx.x; i < c; i += kThreads) s[i] = buf[base + i];
  __syncthreads();
  for (int64_t k = 2; k <= c; k <<= 1) {
    for (int64_t j = k >> 1; j > 0; j >>= 1) {
      for (int64_t p = threadIdx.x; p < c / 2; p += kThreads)
        exchange_shared(s, pair_low(p, j), j, base, k);
      __syncthreads();
    }
  }
  for (int64_t i = threadIdx.x; i < c; i += kThreads) buf[base + i] = s[i];
}

// Finishes stage k (> kBlock) on each kBlock chunk: strides kBlock/2 .. 1.
__global__ void local_merge(int64_t* __restrict__ buf, int64_t k) {
  __shared__ int64_t s[kBlock];
  int64_t base = blockIdx.x * kBlock;
  for (int64_t i = threadIdx.x; i < kBlock; i += kThreads)
    s[i] = buf[base + i];
  __syncthreads();
  for (int64_t j = kBlock >> 1; j > 0; j >>= 1) {
    for (int64_t p = threadIdx.x; p < kBlock / 2; p += kThreads)
      exchange_shared(s, pair_low(p, j), j, base, k);
    __syncthreads();
  }
  for (int64_t i = threadIdx.x; i < kBlock; i += kThreads)
    buf[base + i] = s[i];
}

// One compare-exchange step of stage k at stride j >= kBlock.
__global__ void global_step(int64_t* __restrict__ buf, int64_t n2, int64_t k,
                            int64_t j) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * 256;
  for (int64_t p = blockIdx.x * int64_t{256} + threadIdx.x; p < n2 / 2;
       p += stride) {
    int64_t i = pair_low(p, j);
    int64_t a = buf[i], b = buf[i + j];
    bool up = (i & k) == 0;
    if ((a > b) == up) {
      buf[i] = b;
      buf[i + j] = a;
    }
  }
}

__global__ void extract(const int64_t* __restrict__ buf, int64_t n,
                        int32_t* __restrict__ out) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * 256;
  for (int64_t i = blockIdx.x * int64_t{256} + threadIdx.x; i < n;
       i += stride)
    out[i] = static_cast<int32_t>(buf[i] & kIndexMask);
}

}  // namespace

extern "C" {

// Argsort of lane[n] into out[n] on `stream`; scratch holds n2 int64, n2
// the power of two at or above n. Returns cudaGetLastError().
int srt_packed_argsort(const int64_t* lane, int64_t n, int64_t* scratch,
                       int64_t n2, int32_t* out, void* stream) {
  if (n < 1 || n2 < n || (n2 & (n2 - 1)) != 0 || n2 > (int64_t{1} << 27))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pad_copy<<<grid_for(n2), 256, 0, s>>>(lane, n, n2, scratch);
  int64_t c = n2 < kBlock ? n2 : kBlock;
  local_sort<<<static_cast<unsigned>(n2 / c), kThreads, 0, s>>>(scratch, c);
  for (int64_t k = 2 * kBlock; k <= n2; k <<= 1) {
    for (int64_t j = k >> 1; j >= kBlock; j >>= 1)
      global_step<<<grid_for(n2 / 2), 256, 0, s>>>(scratch, n2, k, j);
    local_merge<<<static_cast<unsigned>(n2 / kBlock), kThreads, 0, s>>>(
        scratch, k);
  }
  extract<<<grid_for(n), 256, 0, s>>>(scratch, n, out);
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
