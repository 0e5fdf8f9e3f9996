// Direct-address join table: build + probe (kernel family "joinProbe").
//
// Replaces the Pallas kernel spark_rapids_tpu/ops/kernels/pallas/
// join_probe.py::dense_build_probe (body _build_probe_kernel). Computes,
// for the direct-address join of ops/kernels/join.py:
//   cnt[s] = number of build rows whose slot is s         (s in [0, tbl))
//   row[s] = smallest build row index whose slot is s     (INT32_MAX if none)
//   max_out = max(cnt[0:tbl])                   (the duplicate-key flag > 1)
//   cnt_out[j] = cnt[clamp(pslot[j])], row_out[j] = row[clamp(pslot[j])]
// The reference sends dead, null and out-of-range build rows to a spare
// slot tbl (num_segments = tbl + 1) that nothing reads: the probes clamp
// into [0, tbl) and the max covers [0, tbl). Here those rows are skipped,
// which gives the same outputs without the spare slot.
//
// The Pallas kernel builds the table at grid step 0 and probes it in later
// steps, which relies on the TPU running its grid in order. Hopper runs
// blocks in no order, so the work is four passes on one stream:
//   1. fill the table (cnt = 0, row = INT32_MAX, max = 0);
//   2. build: one thread per build row, atomicAdd on the count and
//      atomicMin on the first row. Integer atomics are exact and commute,
//      so the table is the same whatever order the threads run in;
//   3. max over cnt[0:tbl): a warp/block reduction, then one atomicMax per
//      block;
//   4. probe: one thread per probe row gathers both lanes.
//
// Bound on the card: memory. The least traffic for the function is reading
// bslot and pslot (4 B a row each) and writing cnt_out and row_out (8 B a
// probe row). The table itself (8 B a slot, 8-64 MB at TPC-H SF1) is
// scratch this design fills, updates and reads in device memory; at SF1 it
// is about the size of the 50 MB L2. Skipping the unusable rows matters:
// a dense join's build side is mostly dead rows after a filter, and
// sending them all to one spare slot serialises their atomics on one
// address. Keeping the table in shared memory or L2 is later work.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 65536) blocks = 65536;  // grid-stride loops cover the rest
  return static_cast<unsigned>(blocks);
}

__global__ void fill_table(int32_t* __restrict__ cnt,
                           int32_t* __restrict__ row, int64_t slots,
                           int32_t* __restrict__ max_out) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < slots; i += stride) {
    cnt[i] = 0;
    row[i] = INT_MAX;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *max_out = 0;
}

__global__ void build_table(const int32_t* __restrict__ bslot, int64_t cap_b,
                            int32_t tbl, int32_t* __restrict__ cnt,
                            int32_t* __restrict__ row) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < cap_b; i += stride) {
    int32_t s = bslot[i];
    if (s < 0 || s >= tbl) continue;  // dead, null or out of range
    atomicAdd(&cnt[s], 1);
    atomicMin(&row[s], static_cast<int32_t>(i));
  }
}

__global__ void max_count(const int32_t* __restrict__ cnt, int64_t tbl,
                          int32_t* __restrict__ max_out) {
  __shared__ int32_t warp_max[kThreads / 32];
  int32_t m = 0;
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < tbl; i += stride) {
    m = max(m, cnt[i]);
  }
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_down_sync(0xffffffffu, m, off));
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_down_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(max_out, m);
  }
}

__global__ void probe_table(const int32_t* __restrict__ pslot, int64_t cap_p,
                            int32_t tbl, const int32_t* __restrict__ cnt,
                            const int32_t* __restrict__ row,
                            int32_t* __restrict__ cnt_out,
                            int32_t* __restrict__ row_out) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < cap_p; i += stride) {
    int32_t s = pslot[i];
    s = s < 0 ? 0 : (s > tbl - 1 ? tbl - 1 : s);
    cnt_out[i] = cnt[s];
    row_out[i] = row[s];
  }
}

}  // namespace

extern "C" {

// Launches the four passes on `stream`; returns cudaGetLastError().
// cnt_tbl and row_tbl are scratch of tbl int32 each.
int srt_dense_build_probe(const int32_t* bslot, int64_t cap_b,
                          const int32_t* pslot, int64_t cap_p, int32_t tbl,
                          int32_t* cnt_tbl, int32_t* row_tbl,
                          int32_t* cnt_out, int32_t* row_out,
                          int32_t* max_out, void* stream) {
  if (tbl < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_table<<<grid_for(tbl), kThreads, 0, s>>>(cnt_tbl, row_tbl, tbl,
                                                 max_out);
  if (cap_b > 0)
    build_table<<<grid_for(cap_b), kThreads, 0, s>>>(bslot, cap_b, tbl,
                                                      cnt_tbl, row_tbl);
  max_count<<<grid_for(tbl), kThreads, 0, s>>>(cnt_tbl, tbl, max_out);
  if (cap_p > 0)
    probe_table<<<grid_for(cap_p), kThreads, 0, s>>>(
        pslot, cap_p, tbl, cnt_tbl, row_tbl, cnt_out, row_out);
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
