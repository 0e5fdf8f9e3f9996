// Stable LSD radix argsort of a packed, unique int64 key lane (kernel
// family "sortStep").
//
// Replaces the Pallas kernel spark_rapids_tpu/ops/kernels/pallas/
// sort_steps.py::packed_argsort (body _bitonic_kernel). The lane is
// ops/kernels/rowops.py::packed_sort_lane's
//   [bit 63: 0][4: dead 8 | null bucket + 4][32: key + 2^31][27: row index]
// so every lane is unique and the ascending order of the lanes is the
// stable sort order of the unpacked operands. The output is the low 27
// bits of the sorted lanes: the sorting permutation, int32.
//
// Bound on the card: memory. The least traffic is reading the lane once
// (8 bytes a row) and writing the permutation (4 bytes): 12 n bytes. The
// Pallas kernel runs a bitonic network inside VMEM; on Hopper a network
// over a lane larger than shared memory costs one pass over device memory
// per stride, so this file sorts by digits instead, and only by the
// digits that vary:
//   * n <= kSmall (4096 lanes, 32 KB): one block loads the lane into
//     shared memory, pads it to a power of two, runs the bitonic network
//     there and writes the permutation. One launch, no scratch.
//   * larger n: 9 digit windows over the lane, low to high: the row index
//     in bits 0-7, 8-15, 16-23, 24-26 and the rest in bits 27-34, 35-42,
//     43-50, 51-58, 59-63 (the top window flips bit 63, so any int64 lane
//     sorts in signed order, as torch.sort does).
//       1. histogram: one pass reads the lane once and counts, in shared
//          memory, the 256 bins of the five key windows; it also sets a
//          flag when some lane's index bits differ from its position. A
//          second launch counts the index windows only when that flag is
//          set, and otherwise exits at once;
//       2. plan (one block): a window is trivial when one bin holds all n
//          lanes; the four index windows are implied when the flag is
//          clear, since stable passes over the other windows keep the
//          input's row order among equal keys. The live windows get the
//          ping-pong buffers: the first reads the caller's lane, the last
//          writes lane & (2^27 - 1) straight into the int32 output;
//       3. one scatter kernel per window, which exits at once when the
//          plan skips it. Up to 4 blocks an SM stay resident and take
//          4096-lane tiles in order from an atomic counter (so a tile's
//          predecessors are always running or done), rank each lane within
//          the tile in position order (per-warp digit counts in shared
//          memory, __match_any_sync for the peers of one step), find the
//          digit's offset over earlier tiles by a decoupled look-back over
//          per-tile status words (onesweep), reorder the tile in shared
//          memory and write each digit's run contiguously;
//       4. when no window is live (a constant lane under the flag), an
//          extract kernel writes lane & (2^27 - 1), which is then iota.
//     At the 2^23-lane l_shipdate lane of SF1 three windows are live (the
//     two low date digits and the dead/bucket field): one read for the
//     histogram, then two 16-byte and one 12-byte pass a lane.
// Stability makes the LSD passes correct and the result the plain
// version's bits. Scratch: two n-lane int64 ping-pong buffers (the second
// is needed once three windows are live and the plan runs on the card, so
// the host cannot know), the histograms and plan, and one 8-byte status
// word per (tile, digit); no power-of-two pad.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRadix = 256;
constexpr int kThreads = 256;  // histogram, plan and scatter blocks
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;     // lanes a thread holds in a scatter tile
constexpr int64_t kTile = int64_t{kThreads} * kItems;  // 4096 lanes
constexpr int kSmall = 4096;   // single-block threshold (32 KB of lanes)
constexpr int kSmallThreads = 1024;
constexpr int64_t kScatterBlocks = 4 * 132;  // persistent scatter blocks
constexpr int kWindows = 9;
constexpr int kIndexWindows = 4;
constexpr int64_t kMaxLanes = int64_t{1} << 27;
constexpr int64_t kIndexMask = kMaxLanes - 1;
constexpr unsigned kFull = 0xffffffffu;

__constant__ int kShift[kWindows] = {0, 8, 16, 24, 27, 35, 43, 51, 59};
__constant__ int kBits[kWindows] = {8, 8, 8, 3, 8, 8, 8, 8, 5};

// Histograms and plan, zeroed before every call.
struct Meta {
  uint32_t hist[kWindows][kRadix];
  uint32_t not_iota;                 // some lane's index bits != its row
  uint32_t tile_counter[kWindows];   // next tile of each window's pass
  int32_t live;                      // live scatter passes
  int32_t seq[kWindows];             // 1-based order of a live window, 0
  int32_t src[kWindows];             // 0 lane, 1 buf0, 2 buf1
  int32_t dst[kWindows];             // 1 buf0, 2 buf1, 3 out
  uint32_t goff[kWindows][kRadix];   // digit offsets over all lanes
};

constexpr int64_t align_up(int64_t v, int64_t a) {
  return (v + a - 1) / a * a;
}

int64_t meta_offset(int64_t n) { return 16 * n; }

int64_t status_offset(int64_t n) {
  return align_up(meta_offset(n) + static_cast<int64_t>(sizeof(Meta)), 256);
}

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

__device__ __forceinline__ int digit_of(int64_t v, int w) {
  const uint64_t u = static_cast<uint64_t>(v) >> kShift[w];
  const int d = static_cast<int>(u & ((1u << kBits[w]) - 1));
  return w == kWindows - 1 ? d ^ 16 : d;
}

// Exclusive sum over the block's 256 threads (all must call it).
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t v,
                                                        uint32_t* warp_tot) {
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, off);
    if (lane_id >= off) x += y;
  }
  if (lane_id == 31) warp_tot[warp] = x;
  __syncthreads();
  uint32_t before = 0;
  for (int k = 0; k < warp; ++k) before += warp_tot[k];
  __syncthreads();
  return before + x - v;
}

__global__ void __launch_bounds__(kSmallThreads)
    small_sort(const int64_t* __restrict__ lane, int n,
               int32_t* __restrict__ out) {
  __shared__ int64_t s[kSmall];
  int c = 2;
  while (c < n) c <<= 1;
  for (int i = threadIdx.x; i < c; i += kSmallThreads)
    s[i] = i < n ? lane[i] : INT64_MAX;
  __syncthreads();
  for (int k = 2; k <= c; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < c / 2; p += kSmallThreads) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int64_t a = s[i], b = s[i + j];
        if ((a > b) == ((i & k) == 0)) {
          s[i] = b;
          s[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += kSmallThreads)
    out[i] = static_cast<int32_t>(s[i] & kIndexMask);
}

// Histograms of windows [W0, W1). The key windows' pass also sets the
// not-iota flag; the index windows' pass runs after it and exits at once
// when the flag is clear (the plan then implies those windows).
template <int W0, int W1>
__global__ void __launch_bounds__(kThreads)
    histogram(const int64_t* __restrict__ lane, int64_t n,
              Meta* __restrict__ meta) {
  constexpr bool kIndexPass = W0 == 0;
  if (kIndexPass && meta->not_iota == 0) return;
  __shared__ uint32_t h[(W1 - W0) * kRadix];
  __shared__ int not_iota;
  for (int i = threadIdx.x; i < (W1 - W0) * kRadix; i += kThreads) h[i] = 0;
  if (threadIdx.x == 0) not_iota = 0;
  __syncthreads();
  const int lane_id = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t stride = (static_cast<int64_t>(gridDim.x) * kThreads);
  bool bad = false;
  // A warp walks 32 consecutive lanes at a time, all its lanes together,
  // so the warp-wide votes below see every lane.
  for (int64_t base = warp * 32; base < n; base += stride) {
    const int64_t i = base + lane_id;
    const bool valid = i < n;
    const int64_t v = valid ? lane[i] : 0;
    if (!kIndexPass) bad |= valid && (v & kIndexMask) != i;
    const unsigned vmask = __ballot_sync(kFull, valid);
#pragma unroll
    for (int w = W0; w < W1; ++w) {
      const int d = digit_of(v, w);
      const int d0 = __shfl_sync(kFull, d, 0);
      // A window that is constant over the warp (the high digits of a
      // narrow key) takes one shared atomic instead of 32 on one bin.
      if (__all_sync(kFull, !valid || d == d0)) {
        if (lane_id == 0)
          atomicAdd(&h[(w - W0) * kRadix + d0],
                    static_cast<uint32_t>(__popc(vmask)));
      } else if (valid) {
        atomicAdd(&h[(w - W0) * kRadix + d], 1u);
      }
    }
  }
  if (bad) not_iota = 1;
  __syncthreads();
  uint32_t* g = &meta->hist[W0][0];
  for (int i = threadIdx.x; i < (W1 - W0) * kRadix; i += kThreads)
    if (h[i] != 0) atomicAdd(&g[i], h[i]);
  if (threadIdx.x == 0 && not_iota) atomicOr(&meta->not_iota, 1u);
}

__global__ void __launch_bounds__(kThreads) plan(int64_t n,
                                                 Meta* __restrict__ meta) {
  __shared__ int trivial[kWindows];
  __shared__ uint32_t warp_tot[kWarps];
  const int d = threadIdx.x;
  if (d < kWindows) trivial[d] = 0;
  __syncthreads();
  for (int w = 0; w < kWindows; ++w)
    if (meta->hist[w][d] == static_cast<uint32_t>(n)) trivial[w] = 1;
  __syncthreads();
  if (d == 0) {
    const bool iota = meta->not_iota == 0;
    int live[kWindows];
    int count = 0;
    for (int w = 0; w < kWindows; ++w) {
      meta->seq[w] = 0;
      if (!trivial[w] && !(iota && w < kIndexWindows)) live[count++] = w;
    }
    for (int k = 0; k < count; ++k) {
      const int w = live[k];
      meta->seq[w] = k + 1;
      meta->src[w] = k == 0 ? 0 : 1 + ((k - 1) & 1);
      meta->dst[w] = k == count - 1 ? 3 : 1 + (k & 1);
    }
    meta->live = count;
  }
  for (int w = 0; w < kWindows; ++w)
    meta->goff[w][d] = block_exclusive_sum(meta->hist[w][d], warp_tot);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// One stable counting pass over window w (see the note at the top).
// A status word is (tag << 32) | count, tag = 4 seq + 1 for the tile's own
// count and 4 seq + 2 for its inclusive prefix; words of earlier passes
// carry smaller tags and read as not yet published.
__global__ void __launch_bounds__(kThreads)
    scatter(int w, const int64_t* __restrict__ lane, int64_t* buf0,
            int64_t* buf1, int32_t* __restrict__ out, int64_t n,
            int64_t tiles, Meta* __restrict__ meta,
            unsigned long long* status) {
  __shared__ int64_t keys[kTile];
  __shared__ uint32_t wcount[kWarps][kRadix];
  __shared__ uint32_t tile_excl[kRadix];
  __shared__ int64_t gbase[kRadix];
  __shared__ uint32_t warp_tot[kWarps];
  __shared__ uint32_t tile_id;
  const int seq = meta->seq[w];
  if (seq == 0) return;
  const int src_sel = meta->src[w], dst_sel = meta->dst[w];
  const int64_t* src = src_sel == 0 ? lane : (src_sel == 1 ? buf0 : buf1);
  int64_t* dst = dst_sel == 1 ? buf0 : buf1;
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Persistent: a block takes tiles until none is left.
  for (;;) {
    if (threadIdx.x == 0) tile_id = atomicAdd(&meta->tile_counter[w], 1u);
    for (int i = lane_id; i < kRadix; i += 32) wcount[warp][i] = 0;
    __syncthreads();
    const int64_t tile = tile_id;
    if (tile >= tiles) return;
    const int64_t tile_base = tile * kTile;
    // Warp-striped: warp k holds lanes [k * 512, (k + 1) * 512) of the tile,
    // step j lane l the lane j * 32 + l of that range, so ranking steps in
    // order and lanes in order ranks in position order.
    const int64_t wbase = tile_base + int64_t{warp} * 32 * kItems;
    int64_t v[kItems];
    int dg[kItems];
    uint32_t rank[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = wbase + j * 32 + lane_id;
      v[j] = i < n ? src[i] : 0;
      dg[j] = i < n ? digit_of(v[j], w) : kRadix;
    }
    const unsigned lt = (1u << lane_id) - 1;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int d = dg[j];
      const unsigned peers = __match_any_sync(kFull, d);
      const uint32_t before = d < kRadix ? wcount[warp][d] : 0;
      __syncwarp();
      if (d < kRadix && (peers & lt) == 0)
        wcount[warp][d] = before + __popc(peers);
      __syncwarp();
      rank[j] = before + __popc(peers & lt);
    }
    __syncthreads();
    // Thread d: the digit's count over the warps (exclusive per warp) and
    // over the tile.
    const int d = threadIdx.x;
    uint32_t cnt = 0;
    for (int k = 0; k < kWarps; ++k) {
      const uint32_t c = wcount[k][d];
      wcount[k][d] = cnt;
      cnt += c;
    }
    unsigned long long* mine = status + tile * kRadix + d;
    const unsigned long long agg_tag =
        static_cast<unsigned long long>(4 * seq + 1) << 32;
    const unsigned long long inc_tag =
        static_cast<unsigned long long>(4 * seq + 2) << 32;
    atomicExch(mine, (tile == 0 ? inc_tag : agg_tag) | cnt);
    tile_excl[d] = block_exclusive_sum(cnt, warp_tot);
    uint64_t prefix = 0;
    if (tile > 0) {
      for (int64_t p = tile - 1;;) {
        const unsigned long long s = load_status(status + p * kRadix + d);
        const uint32_t tag = static_cast<uint32_t>(s >> 32);
        if (tag < static_cast<uint32_t>(4 * seq + 1)) continue;  // not yet
        prefix += static_cast<uint32_t>(s);
        if (tag == static_cast<uint32_t>(4 * seq + 2)) break;
        --p;
      }
      atomicExch(mine, inc_tag | (prefix + cnt));
    }
    gbase[d] = static_cast<int64_t>(meta->goff[w][d]) +
               static_cast<int64_t>(prefix);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int dd = dg[j];
      if (dd < kRadix) keys[tile_excl[dd] + wcount[warp][dd] + rank[j]] = v[j];
    }
    __syncthreads();
    const int64_t left = n - tile_base;
    const int valid = static_cast<int>(left < kTile ? left : kTile);
    for (int i = threadIdx.x; i < valid; i += kThreads) {
      const int64_t key = keys[i];
      const int dd = digit_of(key, w);
      const int64_t pos = gbase[dd] + (i - static_cast<int>(tile_excl[dd]));
      if (dst_sel == 3)
        out[pos] = static_cast<int32_t>(key & kIndexMask);
      else
        dst[pos] = key;
    }
    __syncthreads();  // the tile's shared state is free again
  }
}

__global__ void extract(const int64_t* __restrict__ lane, int64_t n,
                        const Meta* __restrict__ meta,
                        int32_t* __restrict__ out) {
  if (meta->live != 0) return;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    out[i] = static_cast<int32_t>(lane[i] & kIndexMask);
}

unsigned grid_for(int64_t work, int64_t per_block, int64_t cap) {
  int64_t blocks = (work + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" {

// Scratch bytes srt_packed_argsort needs for n lanes (0 below kSmall).
int64_t srt_packed_argsort_scratch_bytes(int64_t n) {
  if (n <= kSmall) return 0;
  return status_offset(n) + tiles_of(n) * kRadix * 8;
}

// Byte offset in the scratch of the plan's count of live radix passes
// (int32), readable after the call; -1 below kSmall (no plan).
int64_t srt_packed_argsort_live_offset(int64_t n) {
  if (n <= kSmall) return -1;
  return meta_offset(n) + static_cast<int64_t>(offsetof(Meta, live));
}

// Argsort of lane[n] into out[n] on `stream`. Returns cudaGetLastError().
int srt_packed_argsort(const int64_t* lane, int64_t n, void* scratch,
                       int64_t scratch_bytes, int32_t* out, void* stream) {
  if (n < 1 || n > kMaxLanes) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kSmall) {
    small_sort<<<1, kSmallThreads, 0, s>>>(lane, static_cast<int>(n), out);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr ||
      scratch_bytes < srt_packed_argsort_scratch_bytes(n))
    return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(scratch);
  int64_t* buf0 = reinterpret_cast<int64_t*>(base);
  int64_t* buf1 = reinterpret_cast<int64_t*>(base + 8 * n);
  Meta* meta = reinterpret_cast<Meta*>(base + meta_offset(n));
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(base + status_offset(n));
  const int64_t tiles = tiles_of(n);
  cudaError_t rc = cudaMemsetAsync(
      meta, 0, static_cast<size_t>(srt_packed_argsort_scratch_bytes(n) -
                                   meta_offset(n)), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned hist_grid = grid_for(n, int64_t{kThreads} * 8, 1056);
  histogram<kIndexWindows, kWindows><<<hist_grid, kThreads, 0, s>>>(
      lane, n, meta);
  histogram<0, kIndexWindows><<<hist_grid, kThreads, 0, s>>>(lane, n, meta);
  plan<<<1, kThreads, 0, s>>>(n, meta);
  for (int w = 0; w < kWindows; ++w)
    scatter<<<grid_for(tiles, 1, kScatterBlocks), kThreads, 0, s>>>(
        w, lane, buf0, buf1, out, n, tiles, meta, status);
  extract<<<grid_for(n, 256, 1056), 256, 0, s>>>(lane, n, meta, out);
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
