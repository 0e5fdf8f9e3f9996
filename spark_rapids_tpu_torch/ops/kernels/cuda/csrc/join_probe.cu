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
// blocks in no order, so the build and the probe are two launches on one
// stream, after a cudaMemsetAsync that clears the table:
//   * the table is one int2 {cnt, enc} a slot, 8 bytes, enc = INT32_MAX -
//     row under atomicMax, so all-zero bytes mean "no row" and one memset
//     fills it. A build row's two atomics hit one sector, a probe row
//     gathers one 8-byte word;
//   * the build takes the max on the way: atomicAdd returns the old count,
//     and the largest old + 1 over the build rows is the largest final
//     count (0 when no row is live, as the memset leaves it). A warp and
//     block reduction, then one atomicMax a block into a spare entry after
//     the table, which the probe launch copies out;
//   * each thread keeps kUnroll rows in flight (the gathers and the
//     atomics' returns are latency-bound).
// A cooperative single launch (clear, grid barrier, build, grid barrier,
// probe) measured slower than the three launches at every call shape of
// the TPC-H queries, and folding the lanes of a warp that share a slot
// into one pair of atomics (__match_any_sync) gained nothing on their
// unclustered build keys, so neither is kept.
// Integer atomics are exact and commute, so the table is the same whatever
// order the threads run in.
//
// Bound on the card: memory. The function must read bslot and pslot (4 B a
// row each) and write cnt_out and row_out (8 B a probe row). Any
// direct-address design also clears its table (8 B a slot: 8-268 MB at
// TPC-H SF1, against a 50 MB L2), and each live build row and each probe
// row then touches one random 32-byte sector of it.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// Blocks for n rows, kUnroll rows a thread, at most what the card holds at
// once (grid-stride loops cover the rest).
unsigned grid_for(int64_t n, int max_blocks) {
  int64_t per = static_cast<int64_t>(kThreads) * kUnroll;
  int64_t blocks = (n + per - 1) / per;
  if (blocks < 1) blocks = 1;
  if (blocks > max_blocks) blocks = max_blocks;
  return static_cast<unsigned>(blocks);
}

// The block's largest m into *out: one atomicMax a block, skipped when
// *out already holds as much (it only grows).
__device__ void block_max_to(int32_t m, int32_t* out) {
  __shared__ int32_t warp_max[kThreads / 32];
  m = __reduce_max_sync(0xffffffffu, m);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    if (m > *reinterpret_cast<volatile int32_t*>(out)) atomicMax(out, m);
  }
}

__global__ void __launch_bounds__(kThreads)
    build_table(const int32_t* __restrict__ bslot, int64_t cap_b, int32_t tbl,
                int2* table) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int32_t m = 0;
  for (int64_t base = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
       base < cap_b; base += kUnroll * stride) {
    int32_t s[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      int64_t i = base + k * stride;
      s[k] = i < cap_b ? bslot[i] : -1;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (s[k] < 0 || s[k] >= tbl) continue;  // dead, null or out of range
      int32_t* e = reinterpret_cast<int32_t*>(table + s[k]);
      m = max(m, atomicAdd(e, 1) + 1);
      atomicMax(e + 1, INT_MAX - static_cast<int32_t>(base + k * stride));
    }
  }
  block_max_to(m, &table[tbl].x);
}

// Also copies the build's max out of the spare entry.
__global__ void __launch_bounds__(kThreads)
    probe_table(const int32_t* __restrict__ pslot, int64_t cap_p, int32_t tbl,
                const int2* table, int32_t* __restrict__ cnt_out,
                int32_t* __restrict__ row_out, int32_t* __restrict__ max_out) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *max_out = __ldcg(&table[tbl].x);
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t base = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
       base < cap_p; base += kUnroll * stride) {
    int2 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      int64_t i = base + k * stride;
      if (i < cap_p) {
        int32_t s = pslot[i];
        s = s < 0 ? 0 : (s > tbl - 1 ? tbl - 1 : s);
        v[k] = __ldcg(table + s);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      int64_t i = base + k * stride;
      if (i < cap_p) {
        cnt_out[i] = v[k].x;
        row_out[i] = INT_MAX - v[k].y;
      }
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace

extern "C" {

// Clears, builds and probes on `stream`; returns cudaGetLastError().
// table is scratch of tbl + 1 int2 (the last one holds the running max).
int srt_dense_build_probe(const int32_t* bslot, int64_t cap_b,
                          const int32_t* pslot, int64_t cap_p, int32_t tbl,
                          void* table, int32_t* cnt_out, int32_t* row_out,
                          int32_t* max_out, void* stream) {
  if (tbl < 1 || cap_b < 0 || cap_b > INT_MAX || cap_p < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* t = static_cast<int2*>(table);
  int resident = sm_count() * (2048 / kThreads);
  cudaError_t rc =
      cudaMemsetAsync(t, 0, sizeof(int2) * (tbl + int64_t{1}), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (cap_b > 0)
    build_table<<<grid_for(cap_b, resident), kThreads, 0, s>>>(bslot, cap_b,
                                                                tbl, t);
  probe_table<<<grid_for(cap_p, resident), kThreads, 0, s>>>(
      pslot, cap_p, tbl, t, cnt_out, row_out, max_out);
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
