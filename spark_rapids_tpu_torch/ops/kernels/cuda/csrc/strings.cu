// The kernels of the "strings" family: two gathers of flat string rows and
// the rowwise compare.
//
// 1. srt_gather_strings is the entry the path takes: every flat-string
// gather of ops/kernels/rowops.py::gather_column (joins, compaction, sort
// and top-k, the exchange's partition gather, group-key gathers). It is a
// ragged gather over the column's own layout, a uint8 payload [P] and
// int32 offsets [n + 1], and writes the gathered column's layout directly:
// for output row r with int32 idx [m] and a one-byte valid [m],
//   len[r]   = valid[r] && n > 0
//              ? clamp(offsets[s + 1] - offsets[s], 0, W) : 0,
//              s = clamp(idx[r], 0, n - 1), the difference in int64
//   out_offsets[0] = 0, out_offsets[r + 1] = (int32) sum(len[0..r])
//   out[out_offsets[r] + j] = payload[clamp(offsets[s] + j, 0, P - 1)]
//              for j < len[r]
//   out[b] = 0 for out_offsets[m] <= b < byte_cap
// which is, bit for bit, the char matrix of the column (positions past
// the row's end PAD), gathered by srt_ragged_gather, and packed back into
// offsets and payload (rowops.py::strings_from_matrix): rows longer than W
// clip to W bytes, negative lengths give 0. No [n, W] or [m, W] matrix
// is built. Lengths and byte sums run in int64, so any W >= 1 is taken;
// out_offsets keep the low 32 bits, as the route's int32 cumsum does.
//
// The design: one cudaMemsetAsync clears the output payload and a small
// scratch after it (a tile ticket and one status word a tile), then one
// launch. Rows go in tiles of 1,024 (128 threads, 8 rows each); a block
// loads its tile's idx and valid, then the two source offsets of each
// valid row (each thread issues all its loads of a kind before it uses
// one), clips the lengths, scans them in shared memory, gets the tile's
// byte prefix by a decoupled look-back (one warp reads 32 earlier tiles'
// status words at a time; tiles are taken in order from an atomic ticket,
// so a tile's predecessors are running or done, as in sort_steps.cu's
// scatter), writes its offsets, and copies its bytes: the tile's output
// is one contiguous byte range, over which threads take 16-byte output
// pieces, find each piece's first row by a binary search over the tile's
// offsets in shared memory, compute all 16 source positions, load them,
// and store whole pieces with one 16-byte store (pieces shared with a
// neighbouring tile byte by byte). Sources start at any byte, so source
// bytes are read one at a time. A call of one tile runs as one block with
// no ticket and no look-back. Blocks are persistent (at most the resident
// count) and loop over tiles. On the H100, tiles of 8,192 rows (1,024
// threads, one block for Q22's 8,192-row calls) and of 2,048 measured
// slower or no faster at every call of the queries.
//
// Bound on the card: memory. idx and valid of every row (5 m bytes); for
// the distinct source rows that valid rows take, their offsets entries
// (offsets[s] and offsets[s + 1], 4 bytes each, neighbours sharing one)
// and their S clipped bytes, read once; the output offsets (4 (m + 1))
// and the B gathered bytes, written once: 5 m + 4 |{s, s + 1}| + S +
// 4 (m + 1) + B bytes. Rows that are not valid read no source. The
// payload past B, byte_cap - B bytes, is the clear beside the bound: at
// m = 262,144 and W = 128 it is most of the call (33.5 MB).
//
// 2. srt_ragged_gather is the counterpart of the Pallas kernel
// spark_rapids_tpu/ops/kernels/pallas/strings.py::ragged_gather (body
// _gather_kernel), kept as that kernel's port; the path no longer takes
// it. Computes
//   out[r, :] = valid[r] ? mat[clamp(idx[r], 0, n - 1), :] : PAD (-1)
// for a [n, W] int16 char matrix, int32 idx [m] and a one-byte valid [m],
// into out [m, W] int16.
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
// 3. srt_row_equal replaces the Pallas kernel pallas/strings.py::
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

// ---- the ragged gather ----------------------------------------------------

constexpr int kGatherThreads = 128;
constexpr int kGatherItems = 8;  // rows a thread
constexpr int kGatherTile = kGatherThreads * kGatherItems;  // 1,024 rows
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;
constexpr unsigned long long kAggregate = 1ull << 62;  // the tile's own sum
constexpr unsigned long long kInclusive = 2ull << 62;  // sum up to the tile
constexpr unsigned kFull = 0xffffffffu;

int64_t gather_tiles(int64_t m) {
  return (m + kGatherTile - 1) / kGatherTile;
}

// Scratch after the payload: an 8-byte ticket word, then one status word a
// tile; none for a call of one tile.
int64_t gather_scratch_bytes(int64_t m) {
  const int64_t tiles = gather_tiles(m);
  return tiles > 1 ? 8 + 8 * tiles : 0;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// Exclusive sum over the block (all threads must call it); *total gets the
// block's sum.
__device__ __forceinline__ int64_t gather_block_scan(int64_t v,
                                                     int64_t* warp_tot,
                                                     int64_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int64_t y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t t = lane < kGatherWarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int64_t y = __shfl_up_sync(kFull, t, off);
      if (lane >= off) t += y;
    }
    if (lane < kGatherWarps) warp_tot[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_tot[kGatherWarps - 1];
  return (warp > 0 ? warp_tot[warp - 1] : 0) + x - v;
}

// ticket == nullptr: one tile, one block, no look-back.
__global__ void __launch_bounds__(kGatherThreads)
    gather_strings(const uint8_t* __restrict__ payload, int64_t payload_len,
                   const int32_t* __restrict__ offsets, int64_t n,
                   const int32_t* __restrict__ idx,
                   const uint8_t* __restrict__ valid, int64_t m,
                   int64_t width, int64_t tiles, uint8_t* __restrict__ out,
                   int32_t* __restrict__ out_offsets, unsigned* ticket,
                   unsigned long long* status) {
  // local inclusive byte ends, in int64: a tile of W-byte rows may pass
  // 2^31 bytes for any W
  __shared__ int64_t incl[kGatherTile];
  __shared__ int32_t start[kGatherTile];  // source starts
  __shared__ int64_t warp_tot[kGatherWarps];
  __shared__ int64_t tile_sh;
  __shared__ int64_t prefix_sh;
  const int tid = threadIdx.x;
  for (int64_t round = 0;; ++round) {
    if (tid == 0)
      tile_sh = ticket != nullptr ? static_cast<int64_t>(atomicAdd(ticket, 1u))
                                  : round;
    __syncthreads();
    const int64_t tile = tile_sh;
    if (tile >= tiles) return;
    const int64_t base = tile * kGatherTile;
    // 1. lengths and sources, rows strided over the threads (coalesced).
    // All of a thread's idx and valid loads go out before any is used,
    // then all its offset loads: two memory round trips, not sixteen.
    int64_t src_row[kGatherItems];
    bool live[kGatherItems];
#pragma unroll
    for (int j = 0; j < kGatherItems; ++j) {
      const int64_t g = base + j * kGatherThreads + tid;
      live[j] = g < m && n > 0 && valid[g] != 0;
      src_row[j] = g < m ? idx[g] : 0;
    }
    int32_t a[kGatherItems], b[kGatherItems];
#pragma unroll
    for (int j = 0; j < kGatherItems; ++j) {
      int64_t s = src_row[j];
      s = s < 0 ? 0 : (s > n - 1 ? n - 1 : s);
      a[j] = live[j] ? __ldg(offsets + s) : 0;
      b[j] = live[j] ? __ldg(offsets + s + 1) : 0;
    }
#pragma unroll
    for (int j = 0; j < kGatherItems; ++j) {
      const int r = j * kGatherThreads + tid;
      int64_t l = static_cast<int64_t>(b[j]) - a[j];
      l = l < 0 ? 0 : (l > width ? width : l);
      incl[r] = l;
      start[r] = a[j];
    }
    __syncthreads();
    // 2. scan: thread t owns rows [8 t, 8 t + 8)
    int64_t v[kGatherItems];
    int64_t run = 0;
#pragma unroll
    for (int j = 0; j < kGatherItems; ++j) {
      v[j] = incl[tid * kGatherItems + j];
      run += v[j];
    }
    int64_t total;
    int64_t acc = gather_block_scan(run, warp_tot, &total);
#pragma unroll
    for (int j = 0; j < kGatherItems; ++j) {
      acc += v[j];
      incl[tid * kGatherItems + j] = acc;
    }
    // 3. the tile's byte prefix over earlier tiles: warp 0 reads the
    // status words of the 32 tiles before a window end at once, until one
    // holds an inclusive sum
    if (tid < 32) {
      int64_t prefix = 0;
      if (ticket != nullptr) {
        unsigned long long* mine = status + tile;
        const unsigned long long agg = static_cast<unsigned long long>(total);
        if (tid == 0) atomicExch(mine, (tile == 0 ? kInclusive : kAggregate) |
                                           agg);
        for (int64_t end = tile - 1; end >= 0;) {
          const int64_t p = end - tid;
          const unsigned long long s =
              p >= 0 ? load_status(status + p) : kInclusive;
          const unsigned long long flag = s & ~kValueMask;
          if (__any_sync(kFull, flag == 0)) continue;  // not yet published
          const unsigned inclusive = __ballot_sync(kFull, flag == kInclusive);
          // the nearest inclusive word ends the walk; the words before it
          // (nearer the tile) are aggregates
          const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
          int64_t part =
              tid <= stop ? static_cast<int64_t>(s & kValueMask) : 0;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_down_sync(kFull, part, off);
          prefix += __shfl_sync(kFull, part, 0);
          if (inclusive) break;
          end -= 32;
        }
        if (tid == 0 && tile > 0)
          atomicExch(mine,
                     kInclusive | static_cast<unsigned long long>(prefix +
                                                                  total));
      }
      if (tid == 0) prefix_sh = prefix;
    }
    __syncthreads();
    const int64_t prefix = prefix_sh;
    // 4. offsets
#pragma unroll
    for (int j = 0; j < kGatherItems; ++j) {
      const int r = j * kGatherThreads + tid;
      const int64_t g = base + r;
      if (g < m) out_offsets[g + 1] = static_cast<int32_t>(prefix + incl[r]);
    }
    if (tile == 0 && tid == 0) out_offsets[0] = 0;
    // 5. bytes: 16-byte output pieces of [prefix, prefix + total)
    if (total > 0) {
      const int64_t hi = prefix + total;
      const int64_t last = (hi - 1) >> 4;
      for (int64_t c = (prefix >> 4) + tid; c <= last; c += kGatherThreads) {
        // local byte positions of the piece, and of its part in the tile
        const int64_t qb = (c << 4) - prefix;
        const int64_t q0 = qb > 0 ? qb : 0;
        const int64_t q1 = qb + 16 < total ? qb + 16 : total;
        // the first row whose inclusive end passes q0
        int lo = 0, up = kGatherTile - 1;
        while (lo < up) {
          const int mid = (lo + up) >> 1;
          if (incl[mid] > q0) up = mid; else lo = mid + 1;
        }
        int r = lo;
        int64_t row_end = incl[r];
        int64_t row_begin = r > 0 ? incl[r - 1] : 0;
        // every source position first (shared memory only), then the 16
        // loads at once. A position start + j with j < len <= offsets[s +
        // 1] - start lies below 2^31, so it fits 32 bits once clamped.
        uint32_t pos[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int64_t q = qb + k;
          pos[k] = 0;
          if (q >= q0 && q < q1) {
            while (row_end <= q) {
              row_begin = row_end;
              row_end = incl[++r];
            }
            int64_t src = static_cast<int64_t>(start[r]) + (q - row_begin);
            src = src < 0 ? 0 : (src >= payload_len ? payload_len - 1 : src);
            pos[k] = static_cast<uint32_t>(src);
          }
        }
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int64_t q = qb + k;
          if (q >= q0 && q < q1)
            w[k >> 2] |= static_cast<uint32_t>(__ldg(payload + pos[k]))
                         << (8 * (k & 3));
        }
        if (q0 == qb && q1 == qb + 16) {
          reinterpret_cast<uint4*>(out)[c] = make_uint4(w[0], w[1], w[2],
                                                        w[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const int64_t q = qb + k;
            if (q >= q0 && q < q1)
              out[(c << 4) + k] =
                  static_cast<uint8_t>(w[k >> 2] >> (8 * (k & 3)));
          }
        }
      }
    }
    __syncthreads();  // the tile's shared state is free again
  }
}

// ---- the rowwise compare -------------------------------------------------

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

// Blocks of the gather that fit on the current device at once.
int gather_resident_blocks(int* resident) {
  static int configured_device = -1;
  static int blocks = 0;
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (device != configured_device) {
    int per_sm = 0, sms = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_strings, kGatherThreads, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    blocks = per_sm * sms;
    configured_device = device;
  }
  *resident = blocks;
  return 0;
}

}  // namespace

extern "C" {

// Scratch bytes srt_gather_strings needs after the payload for m output
// rows (0 for one tile).
int64_t srt_gather_strings_scratch_bytes(int64_t m) {
  return gather_scratch_bytes(m);
}

// The ragged gather on `stream`; returns the first CUDA error. buf holds
// byte_cap payload bytes, then (at byte_cap rounded up to 16) the scratch;
// it is cleared whole, then one kernel writes the payload and out_offsets
// [m + 1]. offsets holds n + 1 values; payload_len >= 1 when n >= 1;
// m >= 1; width >= 1; byte_cap >= m * width; buf 16-byte aligned.
int srt_gather_strings(const void* payload, int64_t payload_len,
                       const int32_t* offsets, int64_t n, const int32_t* idx,
                       const uint8_t* valid, int64_t m, int64_t width,
                       void* buf, int64_t byte_cap, int32_t* out_offsets,
                       void* stream) {
  if (m < 1 || n < 0 || (n > 0 && payload_len < 1) || width < 1 ||
      byte_cap / width < m ||
      reinterpret_cast<uintptr_t>(buf) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  int rc = gather_resident_blocks(&resident);
  if (rc != 0) return rc;
  const int64_t tiles = gather_tiles(m);
  const int64_t scratch_at = (byte_cap + 15) / 16 * 16;
  uint8_t* out = static_cast<uint8_t*>(buf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(scratch_at + gather_scratch_bytes(m)), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned* ticket = nullptr;
  unsigned long long* status = nullptr;
  int64_t blocks = 1;
  if (tiles > 1) {
    ticket = reinterpret_cast<unsigned*>(out + scratch_at);
    status = reinterpret_cast<unsigned long long*>(out + scratch_at + 8);
    blocks = tiles < resident ? tiles : resident;
  }
  gather_strings<<<static_cast<unsigned>(blocks), kGatherThreads, 0, s>>>(
      static_cast<const uint8_t*>(payload), payload_len, offsets, n, idx,
      valid, m, width, tiles, out, out_offsets, ticket, status);
  return static_cast<int>(cudaGetLastError());
}

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
