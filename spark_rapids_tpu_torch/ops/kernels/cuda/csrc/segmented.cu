// Sorted-order segmented reduction (kernel family "segmented"), as a
// row-parallel reduce-by-key.
//
// Replaces the Pallas kernel spark_rapids_tpu/ops/kernels/pallas/
// segmented.py::segment_reduce_sorted (body _segment_reduce_kernel):
// sum, min or max of x [n, lanes] over a nondecreasing, prefix-dense group
// id gid [n] into a dense out [capacity, lanes]. Groups with no rows get
// the reduction's identity (0, or the type's max / min; +/-inf for
// floats), as jax.ops.segment_{sum,min,max}(..., num_segments=capacity)
// gives. Rows whose gid is outside [0, capacity) are dropped.
//
// Bound on the card: memory. The least traffic is reading x and gid once
// and writing out once. The Pallas kernel folds each row block into a
// window of the output with a read-modify-write that is safe only because
// the TPU runs its grid in order. Hopper runs blocks in no order, and a
// design that gives each group its own warp idles most of the warp on
// small groups and serializes a large one, so the work here goes by rows:
//   1. reduce_tiles: a block takes a tile of 1024 consecutive rows and up
//      to 4 lanes (a second grid dimension covers wider stacks), stages
//      x[tile, lanes] in shared memory with one contiguous load when the
//      block holds every lane of a row, and runs one segmented scan for
//      its lanes together (4 rows a thread, warp shuffles, a block
//      combine) with heads where gid[i] != gid[i-1]. A group that starts
//      and ends inside the tile is written straight to out. The tile's
//      first group, when it began in an earlier tile, and its last group,
//      when it goes on into the next tile, leave their partials in a
//      per-tile carry (an int64 accumulator and a NaN flag per lane). A
//      tile whose rows all lie outside [0, capacity) (the sort path's dead
//      tail) reads no x. The tile that holds the first in-range row, and
//      the one that holds the row after the last, record which rows of
//      out no group writes: the contract leaves no empty group between.
//   2. fix_up: the rows of out before the first and after the last
//      in-range group get the identity (a grid-stride fill), and each
//      group that crosses tiles is combined by the block of the tile where
//      it starts: usually the next tile closes it (two partials a lane);
//      else the block's threads find the tile where it ends and reduce the
//      carries in between. A call of one tile runs step 1 alone, which
//      then writes the identity rows itself: one launch.
// The cost is the same per row whatever the mix of group sizes; out gets
// no capacity-sized scratch and no clear pass.
//
// Every reduction that reaches this kernel is exact and order-free:
// integer sums wrap modulo 2^bits (int8/int16/int32 accumulate in int64
// and truncate at the end), integer min/max are exact, and float min/max
// compare on a total-order integer key (-0.0 < +0.0) with NaN
// propagating, so the result is the same bits whatever the order of the
// combines, run to run. Float sums and bool lanes never come here: a float
// sum's bits depend on the order of its additions, so the group-by sends
// them to the plain segment sum, as the reference does.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kThreads * kRowsPerThread;  // 1024
constexpr int kVec = 4;  // lanes a block scans together
constexpr unsigned kFull = 0xffffffffu;

enum Op { kSum = 0, kMin = 1, kMax = 2 };
enum Dtype { kI8 = 0, kI16 = 1, kI32 = 2, kI64 = 3, kF32 = 4, kF64 = 5 };

// Total-order integer key of a float: signed compare of the key is the
// IEEE order with -0.0 < +0.0. The map is its own inverse.
__device__ __forceinline__ int64_t key_of(double v) {
  int64_t b = __double_as_longlong(v);
  return b < 0 ? (b ^ 0x7FFFFFFFFFFFFFFFLL) : b;
}
__device__ __forceinline__ int64_t key_of(float v) {
  int32_t b = __float_as_int(v);
  return static_cast<int64_t>(b < 0 ? (b ^ 0x7FFFFFFF) : b);
}
__device__ __forceinline__ double from_key(int64_t k, bool nan, double*) {
  int64_t b = k < 0 ? (k ^ 0x7FFFFFFFFFFFFFFFLL) : k;
  return nan ? __longlong_as_double(0x7FF8000000000000LL)
             : __longlong_as_double(b);
}
__device__ __forceinline__ float from_key(int64_t k, bool nan, float*) {
  int32_t k32 = static_cast<int32_t>(k);
  int32_t b = k32 < 0 ? (k32 ^ 0x7FFFFFFF) : k32;
  return nan ? __int_as_float(0x7FC00000) : __int_as_float(b);
}

template <typename T>
struct Traits {
  static constexpr bool kFloat = false;
  __device__ static int64_t lo() {
    return sizeof(T) == 1 ? INT8_MIN
         : sizeof(T) == 2 ? INT16_MIN
         : sizeof(T) == 4 ? INT32_MIN : INT64_MIN;
  }
  __device__ static int64_t hi() {
    return sizeof(T) == 1 ? INT8_MAX
         : sizeof(T) == 2 ? INT16_MAX
         : sizeof(T) == 4 ? INT32_MAX : INT64_MAX;
  }
};

// Identities of float min/max: the keys of +inf and -inf.
template <> struct Traits<float> {
  static constexpr bool kFloat = true;
  __device__ static int64_t lo() {
    return key_of(__int_as_float(static_cast<int>(0xFF800000u)));
  }
  __device__ static int64_t hi() {
    return key_of(__int_as_float(0x7F800000));
  }
};
template <> struct Traits<double> {
  static constexpr bool kFloat = true;
  __device__ static int64_t lo() {
    return key_of(__longlong_as_double(
        static_cast<long long>(0xFFF0000000000000ull)));
  }
  __device__ static int64_t hi() {
    return key_of(__longlong_as_double(0x7FF0000000000000LL));
  }
};

// Accumulator: a 64-bit integer for every type (a wrapping sum for ints,
// the value for int min/max, the total-order key for float min/max), plus
// a NaN flag for floats.
struct Acc {
  int64_t v;
  int nan;
};

template <typename T, int OP>
__device__ __forceinline__ Acc identity() {
  return {OP == kSum ? 0 : (OP == kMin ? Traits<T>::hi() : Traits<T>::lo()),
          0};
}

template <int OP>
__device__ __forceinline__ Acc combine(Acc a, Acc b) {
  int64_t v;
  if (OP == kSum)
    v = static_cast<int64_t>(static_cast<uint64_t>(a.v) +
                             static_cast<uint64_t>(b.v));
  else if (OP == kMin)
    v = b.v < a.v ? b.v : a.v;
  else
    v = b.v > a.v ? b.v : a.v;
  return {v, a.nan | b.nan};
}

template <typename T, int OP>
__device__ __forceinline__ Acc to_acc(T x) {
  if constexpr (Traits<T>::kFloat) {
    if (x != x) return {identity<T, OP>().v, 1};
    return {key_of(x), 0};
  } else {
    return {static_cast<int64_t>(x), 0};
  }
}

template <typename T>
__device__ __forceinline__ T finalize(Acc a) {
  if constexpr (Traits<T>::kFloat)
    return from_key(a.v, a.nan != 0, static_cast<T*>(nullptr));
  else
    return static_cast<T>(a.v);
}

// Per-tile partials of the groups that cross tiles, and the identity rows.
struct Carry {
  int64_t* bounds;    // [2]: out rows [0, lo) and [hi, capacity) get the id
  int32_t* middle;    // [tiles]: the whole tile is one group, open both ways
  int32_t* cross;     // [tiles]: the in-range group that starts in the tile
                      // and goes on into the next, or -1
  int64_t* first_v;   // [tiles, lanes]: the first group, begun earlier
  int64_t* last_v;    // [tiles, lanes]: the last group, going on after
  int32_t* first_nan;
  int32_t* last_nan;
};

template <typename T, int OP>
__device__ void fill_identity(T* out, int64_t lanes, int64_t l0, int cl,
                              int64_t capacity, int64_t lo, int64_t hi,
                              int64_t first, int64_t stride) {
  const T id = finalize<T>(identity<T, OP>());
  const int64_t head = lo * cl;
  const int64_t total = head + (capacity - hi) * cl;
  if (cl == lanes) {  // whole rows: two contiguous ranges
    for (int64_t e = first; e < total; e += stride)
      out[e < head ? e : hi * lanes + (e - head)] = id;
    return;
  }
  for (int64_t e = first; e < total; e += stride) {
    const int64_t row = e < head ? e / cl : hi + (e - head) / cl;
    const int64_t c = (e < head ? e : e - head) % cl;
    out[row * lanes + l0 + c] = id;
  }
}

// Exclusive segmented scan over the block's threads of up to kVec lanes
// at once (all threads call it; cl lanes are live): on return a[c] holds
// the fold of lane c since the last head before this thread.
template <typename T, int OP>
__device__ __forceinline__ void block_exclusive_segscan(
    int flag, Acc (&a)[kVec], int cl, int64_t (*warp_v)[kVec],
    int (*warp_n)[kVec], int* warp_f) {
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int f = flag;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int fo = __shfl_up_sync(kFull, f, off);
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      if (c < cl) {
        const int64_t vo = __shfl_up_sync(kFull, a[c].v, off);
        const int no = __shfl_up_sync(kFull, a[c].nan, off);
        if (lane_id >= off && !f) a[c] = combine<OP>({vo, no}, a[c]);
      }
    }
    if (lane_id >= off) f |= fo;
  }
  if (lane_id == 31) {
    warp_f[warp] = f;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      warp_v[warp][c] = a[c].v;
      warp_n[warp][c] = a[c].nan;
    }
  }
  __syncthreads();
  int fe = __shfl_up_sync(kFull, f, 1);  // every lane shuffles
  if (lane_id == 0) fe = 0;
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    if (c >= cl) continue;
    Acc carry = identity<T, OP>();
    for (int k = 0; k < warp; ++k) {
      const Acc wk = {warp_v[k][c], warp_n[k][c]};
      carry = warp_f[k] ? wk : combine<OP>(carry, wk);
    }
    Acc e = {__shfl_up_sync(kFull, a[c].v, 1),
             __shfl_up_sync(kFull, a[c].nan, 1)};
    if (lane_id == 0) e = identity<T, OP>();
    a[c] = fe ? e : combine<OP>(carry, e);
  }
  __syncthreads();
}

// Block (tile, lane chunk): rows [tile * kTileRows, +kTileRows), lanes
// [blockIdx.y * kVec, +kVec).
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    reduce_tiles(const T* __restrict__ x, int64_t n, int64_t lanes,
                 const int32_t* __restrict__ gid, int64_t capacity,
                 int64_t tiles, int fused, T* __restrict__ out,
                 Carry carry) {
  __shared__ __align__(16) T stage[kTileRows * kVec];
  __shared__ int32_t gs[kTileRows];
  __shared__ int64_t warp_v[kWarps][kVec];
  __shared__ int warp_n[kWarps][kVec];
  __shared__ int warp_f[kWarps];
  __shared__ int64_t bounds[2];
  const int tid = threadIdx.x;
  const int64_t tile = blockIdx.x;
  const int64_t r0 = tile * kTileRows;
  const int64_t left = n - r0;
  const int rows = static_cast<int>(left < kTileRows ? left : kTileRows);
  const int64_t l0 = static_cast<int64_t>(blockIdx.y) * kVec;
  const int cl = static_cast<int>(lanes - l0 < kVec ? lanes - l0 : kVec);
  const bool lead = blockIdx.y == 0;  // writes the per-tile records
  for (int q = tid; q < rows; q += kThreads) gs[q] = gid[r0 + q];
  const bool has_prev = r0 > 0 && rows > 0;
  const bool has_next = r0 + rows < n;
  const int32_t prev = has_prev ? gid[r0 - 1] : 0;
  const int32_t next = has_next ? gid[r0 + rows] : 0;
  __syncthreads();

  // The two boundaries, at tile positions 0 .. rows - 1 (and n in the
  // last tile). Row -1 lies below [0, capacity) and row n above it, so
  // each boundary is found exactly once.
  if (fused || lead) {
    const int q_end = tile == tiles - 1 ? rows + 1 : rows;
    for (int q = tid; q < q_end; q += kThreads) {
      const int64_t r = r0 + q;
      const bool in_prev = q > 0 || has_prev;  // row r - 1 exists
      const int32_t gp = q > 0 ? gs[q - 1] : prev;
      const bool in_cur = q < rows;
      const int32_t gc = in_cur ? gs[q] : next;
      const bool below_p = !in_prev || gp < 0;
      const bool below_c = in_cur && gc < 0;
      const bool above_p = in_prev && gp >= capacity;
      const bool above_c = !in_cur || gc >= capacity;
      if (below_p && !below_c) {
        const int64_t lo = above_c ? capacity : gc;
        if (fused) bounds[0] = lo;
        else carry.bounds[0] = lo;
      }
      if (!above_p && above_c) {
        const int64_t hi = below_p ? capacity : gp + int64_t{1};
        if (fused) bounds[1] = hi;
        else carry.bounds[1] = hi;
      }
    }
  }
  if (rows > 0) {
    const int32_t g_first = gs[0], g_last = gs[rows - 1];
    const bool open_start = has_prev && prev == g_first;
    const bool open_end = has_next && next == g_last;
    if (!fused && lead && tid == 0) {
      carry.middle[tile] = open_start && open_end && g_first == g_last;
      const bool starts_here = !(open_start && g_first == g_last);
      carry.cross[tile] = open_end && starts_here && g_last >= 0 &&
                                  g_last < capacity
                              ? g_last : -1;
    }
    // A tile whose rows all lie outside [0, capacity) writes nothing.
    if (g_first < capacity && g_last >= 0) {
      if (cl == lanes) {  // the rows' lanes are one contiguous range
        const T* src = x + r0 * lanes;
        for (int e = tid; e < rows * cl; e += kThreads) stage[e] = src[e];
      } else {
        for (int e = tid; e < rows * cl; e += kThreads) {
          const int q = e / cl, c = e - q * cl;
          stage[e] = x[(r0 + q) * lanes + l0 + c];
        }
      }
      __syncthreads();
      const int q0 = tid * kRowsPerThread;
      // This thread's rows: the fold since its last head.
      int flag = 0;
      Acc run[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) run[c] = identity<T, OP>();
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int q = q0 + j;
        if (q >= rows) break;
        const bool head = q == 0 || gs[q] != gs[q - 1];
        flag |= head;
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          if (c >= cl) continue;
          const Acc a = to_acc<T, OP>(stage[q * cl + c]);
          run[c] = head ? a : combine<OP>(run[c], a);
        }
      }
      block_exclusive_segscan<T, OP>(flag, run, cl, warp_v, warp_n, warp_f);
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int q = q0 + j;
        if (q >= rows) break;
        const int32_t g = gs[q];
        const bool head = q == 0 || gs[q - 1] != g;
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          if (c >= cl) continue;
          const Acc a = to_acc<T, OP>(stage[q * cl + c]);
          run[c] = head ? a : combine<OP>(run[c], a);
        }
        if (q != rows - 1 && gs[q + 1] == g) continue;  // not a tail
        if (g < 0 || g >= capacity) continue;
        const bool first = open_start && g == g_first;
        const bool last = !first && q == rows - 1 && open_end;
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          if (c >= cl) continue;
          const int64_t at = tile * lanes + l0 + c;
          if (first) {
            carry.first_v[at] = run[c].v;
            carry.first_nan[at] = run[c].nan;
          } else if (last) {
            carry.last_v[at] = run[c].v;
            carry.last_nan[at] = run[c].nan;
          } else {
            out[g * lanes + l0 + c] = finalize<T>(run[c]);
          }
        }
      }
    }
  }
  if (fused) {
    __syncthreads();
    fill_identity<T, OP>(out, lanes, l0, cl, capacity, bounds[0], bounds[1],
                         tid, kThreads);
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    fix_up(int64_t lanes, int64_t capacity, int64_t tiles,
           T* __restrict__ out, Carry carry) {
  __shared__ int first_close;
  __shared__ int64_t warp_v[kWarps];
  __shared__ int warp_n[kWarps];
  const int tid = threadIdx.x, lane_id = tid & 31, warp = tid >> 5;
  fill_identity<T, OP>(out, lanes, 0, static_cast<int>(lanes), capacity,
                       carry.bounds[0], carry.bounds[1],
                       static_cast<int64_t>(blockIdx.x) * kThreads + tid,
                       static_cast<int64_t>(gridDim.x) * kThreads);
  for (int64_t a = blockIdx.x; a + 1 < tiles; a += gridDim.x) {
    const int32_t g = carry.cross[a];
    if (g < 0) continue;
    // Its last tile: the first after a that is not wholly inside it (the
    // last tile never is).
    int64_t b = carry.middle[a + 1] ? -1 : a + 1;
    for (int64_t base = a + 2; b < 0; base += kThreads) {
      if (tid == 0) first_close = INT_MAX;
      __syncthreads();
      const int64_t t = base + tid;
      if (t < tiles && (t == tiles - 1 || !carry.middle[t]))
        atomicMin(&first_close, static_cast<int>(t));
      __syncthreads();
      if (first_close != INT_MAX) b = first_close;
      __syncthreads();
    }
    if (b == a + 1) {  // the common case: two partials a lane
      for (int64_t l = tid; l < lanes; l += kThreads) {
        const Acc total = combine<OP>(
            {carry.last_v[a * lanes + l], carry.last_nan[a * lanes + l]},
            {carry.first_v[b * lanes + l], carry.first_nan[b * lanes + l]});
        out[g * lanes + l] = finalize<T>(total);
      }
      continue;
    }
    for (int64_t l = 0; l < lanes; ++l) {
      Acc acc = identity<T, OP>();
      for (int64_t t = a + 1 + tid; t <= b; t += kThreads)
        acc = combine<OP>(acc, {carry.first_v[t * lanes + l],
                                carry.first_nan[t * lanes + l]});
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc = combine<OP>(acc, {__shfl_down_sync(kFull, acc.v, off),
                                __shfl_down_sync(kFull, acc.nan, off)});
      if (lane_id == 0) {
        warp_v[warp] = acc.v;
        warp_n[warp] = acc.nan;
      }
      __syncthreads();
      if (tid == 0) {
        Acc total = {carry.last_v[a * lanes + l],
                     carry.last_nan[a * lanes + l]};
        for (int k = 0; k < kWarps; ++k)
          total = combine<OP>(total, {warp_v[k], warp_n[k]});
        out[g * lanes + l] = finalize<T>(total);
      }
      __syncthreads();
    }
  }
}

int64_t tiles_of(int64_t n) {
  const int64_t t = (n + kTileRows - 1) / kTileRows;
  return t < 1 ? 1 : t;
}

int64_t align8(int64_t v) { return (v + 7) / 8 * 8; }

// Scratch layout: bounds[2] | middle[tiles] | cross[tiles] | first_v |
// last_v | first_nan | last_nan ([tiles, lanes] each).
Carry carve(void* scratch, int64_t tiles, int64_t lanes) {
  char* p = static_cast<char*>(scratch);
  Carry c;
  c.bounds = reinterpret_cast<int64_t*>(p);
  p += 16;
  c.middle = reinterpret_cast<int32_t*>(p);
  p += align8(4 * tiles);
  c.cross = reinterpret_cast<int32_t*>(p);
  p += align8(4 * tiles);
  c.first_v = reinterpret_cast<int64_t*>(p);
  p += 8 * tiles * lanes;
  c.last_v = reinterpret_cast<int64_t*>(p);
  p += 8 * tiles * lanes;
  c.first_nan = reinterpret_cast<int32_t*>(p);
  p += align8(4 * tiles * lanes);
  c.last_nan = reinterpret_cast<int32_t*>(p);
  return c;
}

template <typename T, int OP>
int launch_op(const void* x, int64_t n, int64_t lanes, const int32_t* gid,
              int64_t capacity, void* scratch, void* out, cudaStream_t s) {
  const int64_t tiles = tiles_of(n);
  const bool fused = tiles == 1;
  Carry c = fused ? Carry{} : carve(scratch, tiles, lanes);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((lanes + kVec - 1) / kVec));
  reduce_tiles<T, OP><<<grid, kThreads, 0, s>>>(
      xt, n, lanes, gid, capacity, tiles, fused ? 1 : 0, ot, c);
  if (!fused) {
    // a block a tile, and enough for the identity fill at 4 rows a thread
    const int64_t fill = (capacity * lanes + 4 * kThreads - 1) / (4 * kThreads);
    int64_t blocks = tiles > fill ? tiles : fill;
    if (blocks > 65535) blocks = 65535;
    fix_up<T, OP><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        lanes, capacity, tiles, ot, c);
  }
  return cudaSuccess;
}

template <typename T>
int launch(int op, const void* x, int64_t n, int64_t lanes,
           const int32_t* gid, int64_t capacity, void* scratch, void* out,
           cudaStream_t s) {
  switch (op) {
    case kSum:
      if constexpr (Traits<T>::kFloat) return cudaErrorInvalidValue;
      else return launch_op<T, kSum>(x, n, lanes, gid, capacity, scratch,
                                     out, s);
    case kMin:
      return launch_op<T, kMin>(x, n, lanes, gid, capacity, scratch, out, s);
    case kMax:
      return launch_op<T, kMax>(x, n, lanes, gid, capacity, scratch, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Scratch bytes srt_segment_reduce_sorted needs (0 for one tile).
int64_t srt_segment_scratch_bytes(int64_t n, int64_t lanes) {
  const int64_t tiles = tiles_of(n);
  if (tiles == 1) return 0;
  return 16 + 2 * align8(4 * tiles) + 16 * tiles * lanes +
         2 * align8(4 * tiles * lanes);
}

// x: [n, lanes] contiguous of `dtype`; gid: int32 [n]; out: [capacity,
// lanes] of `dtype`; scratch: srt_segment_scratch_bytes(n, lanes) bytes.
// Returns cudaGetLastError() after the launches (or cudaErrorInvalidValue
// for an op/dtype pair the kernel does not take, or too little scratch).
int srt_segment_reduce_sorted(const void* x, int dtype, int op, int64_t n,
                              int64_t lanes, const int32_t* gid,
                              int64_t capacity, void* scratch,
                              int64_t scratch_size, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (capacity <= 0 || lanes <= 0 || n < 0 ||
      scratch_size < srt_segment_scratch_bytes(n, lanes) ||
      (srt_segment_scratch_bytes(n, lanes) > 0 && scratch == nullptr))
    return cudaErrorInvalidValue;
  int rc;
  switch (dtype) {
    case kI8: rc = launch<int8_t>(op, x, n, lanes, gid, capacity, scratch,
                                  out, s); break;
    case kI16: rc = launch<int16_t>(op, x, n, lanes, gid, capacity, scratch,
                                    out, s); break;
    case kI32: rc = launch<int32_t>(op, x, n, lanes, gid, capacity, scratch,
                                    out, s); break;
    case kI64: rc = launch<int64_t>(op, x, n, lanes, gid, capacity, scratch,
                                    out, s); break;
    case kF32: rc = launch<float>(op, x, n, lanes, gid, capacity, scratch,
                                  out, s); break;
    case kF64: rc = launch<double>(op, x, n, lanes, gid, capacity, scratch,
                                   out, s); break;
    default: rc = cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
