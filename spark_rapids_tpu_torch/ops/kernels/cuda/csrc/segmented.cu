// Sorted-order segmented reduction (kernel family "segmented").
//
// Replaces the Pallas kernel spark_rapids_tpu/ops/kernels/pallas/
// segmented.py::segment_reduce_sorted (body _segment_reduce_kernel):
// sum, min or max of x [n, lanes] over a nondecreasing, prefix-dense
// group id gid [n] into a dense out [capacity, lanes]. Groups with no rows
// get the reduction's identity (0, or the type's max / min; +/-inf for
// floats), as jax.ops.segment_{sum,min,max}(..., num_segments=capacity)
// gives. Rows whose gid is outside [0, capacity) are dropped.
//
// The Pallas kernel folds each row block into a window of the output with
// a read-modify-write that is safe only because the TPU runs its grid in
// order. Hopper runs blocks in no order, so:
//   1. clear the per-group [start, end) table;
//   2. find segment boundaries: one thread per row compares its gid with
//      its neighbours' and writes the group's start or end;
//   3. reduce: one warp per group walks the group's contiguous rows (32
//      consecutive rows per step, so loads coalesce) and combines the 32
//      partials with a fixed shuffle tree.
// Every reduction that reaches this kernel is exact and order-free:
// integer sums wrap modulo 2^bits, integer min/max are exact, and float
// min/max compare on a total-order integer key (-0.0 < +0.0) with NaN
// propagating, so the result is the same bits whatever the order, run to
// run. Float sums and bool lanes never come here: a float sum's bits
// depend on the order of its additions, so the group-by sends them to the
// plain segment sum, as the reference does.
//
// Bound on the card: memory. The least traffic is reading x and gid once
// and writing out once. Uneven group sizes cost time here: a group's warp
// walks all of its rows, so one huge group (the sort path's tail of dead
// rows joins the last group) runs on a single warp. Splitting large groups
// across blocks is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

enum Op { kSum = 0, kMin = 1, kMax = 2 };
enum Dtype { kI8 = 0, kI16 = 1, kI32 = 2, kI64 = 3, kF32 = 4, kF64 = 5 };

unsigned grid_for(int64_t threads) {
  int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 65536) blocks = 65536;
  return static_cast<unsigned>(blocks);
}

__global__ void clear_bounds(int64_t* __restrict__ start,
                             int64_t* __restrict__ end, int64_t capacity) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       g < capacity; g += stride) {
    start[g] = 0;
    end[g] = 0;
  }
}

__global__ void find_bounds(const int32_t* __restrict__ gid, int64_t n,
                            int64_t capacity, int64_t* __restrict__ start,
                            int64_t* __restrict__ end) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += stride) {
    int32_t g = gid[i];
    if (g < 0 || g >= capacity) continue;
    if (i == 0 || gid[i - 1] != g) start[g] = i;
    if (i == n - 1 || gid[i + 1] != g) end[g] = i + 1;
  }
}

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
__device__ __forceinline__ void from_key(int64_t k, bool nan, double* out) {
  int64_t b = k < 0 ? (k ^ 0x7FFFFFFFFFFFFFFFLL) : k;
  *out = nan ? __longlong_as_double(0x7FF8000000000000LL)
             : __longlong_as_double(b);
}
__device__ __forceinline__ void from_key(int64_t k, bool nan, float* out) {
  int32_t k32 = static_cast<int32_t>(k);
  int32_t b = k32 < 0 ? (k32 ^ 0x7FFFFFFF) : k32;
  *out = nan ? __int_as_float(0x7FC00000) : __int_as_float(b);
}

template <typename T>
struct IntTraits {
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

template <typename T> struct Traits : IntTraits<T> {};

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
template <typename T, int OP>
__global__ void reduce_groups(const T* __restrict__ x, int64_t lanes,
                              int64_t capacity,
                              const int64_t* __restrict__ start,
                              const int64_t* __restrict__ end,
                              T* __restrict__ out) {
  using Tr = Traits<T>;
  const int lane_id = threadIdx.x & 31;
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t g = warp; g < capacity; g += nwarps) {
    const int64_t lo = start[g], hi = end[g];
    for (int64_t l = 0; l < lanes; ++l) {
      int64_t acc = OP == kSum ? 0 : (OP == kMin ? Tr::hi() : Tr::lo());
      int nan = 0;
      for (int64_t r = lo + lane_id; r < hi; r += 32) {
        T v = x[r * lanes + l];
        int64_t k;
        if constexpr (Tr::kFloat) {
          if (v != v) {
            nan = 1;
            continue;
          }
          k = key_of(v);
        } else {
          k = static_cast<int64_t>(v);
        }
        if (OP == kSum)
          acc = static_cast<int64_t>(static_cast<uint64_t>(acc) +
                                     static_cast<uint64_t>(k));
        else if (OP == kMin)
          acc = k < acc ? k : acc;
        else
          acc = k > acc ? k : acc;
      }
      for (int off = 16; off > 0; off >>= 1) {
        int64_t o = __shfl_down_sync(0xffffffffu, acc, off);
        nan |= __shfl_down_sync(0xffffffffu, nan, off);
        if (OP == kSum)
          acc = static_cast<int64_t>(static_cast<uint64_t>(acc) +
                                     static_cast<uint64_t>(o));
        else if (OP == kMin)
          acc = o < acc ? o : acc;
        else
          acc = o > acc ? o : acc;
      }
      if (lane_id == 0) {
        if constexpr (Tr::kFloat) {
          from_key(acc, nan != 0, &out[g * lanes + l]);
        } else {
          out[g * lanes + l] = static_cast<T>(acc);
        }
      }
    }
  }
}

template <typename T>
int launch_reduce(int op, const void* x, int64_t lanes, int64_t capacity,
                  const int64_t* start, const int64_t* end, void* out,
                  cudaStream_t s) {
  // One warp per group, capped; the grid-stride loop covers the rest.
  unsigned blocks = grid_for(capacity * 32);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  switch (op) {
    case kSum:
      if constexpr (Traits<T>::kFloat) return cudaErrorInvalidValue;
      else reduce_groups<T, kSum><<<blocks, kThreads, 0, s>>>(
          xt, lanes, capacity, start, end, ot);
      break;
    case kMin:
      reduce_groups<T, kMin><<<blocks, kThreads, 0, s>>>(
          xt, lanes, capacity, start, end, ot);
      break;
    case kMax:
      reduce_groups<T, kMax><<<blocks, kThreads, 0, s>>>(
          xt, lanes, capacity, start, end, ot);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x: [n, lanes] contiguous of `dtype`; gid: int32 [n]; out: [capacity,
// lanes] of `dtype`; start/end: int64 scratch of `capacity` each.
// Returns cudaGetLastError() after the launches (or cudaErrorInvalidValue
// for an op/dtype pair the kernel does not take).
int srt_segment_reduce_sorted(const void* x, int dtype, int op, int64_t n,
                              int64_t lanes, const int32_t* gid,
                              int64_t capacity, int64_t* start, int64_t* end,
                              void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (capacity <= 0 || lanes <= 0) return cudaSuccess;
  clear_bounds<<<grid_for(capacity), kThreads, 0, s>>>(start, end, capacity);
  if (n > 0)
    find_bounds<<<grid_for(n), kThreads, 0, s>>>(gid, n, capacity, start,
                                                  end);
  int rc;
  switch (dtype) {
    case kI8: rc = launch_reduce<int8_t>(op, x, lanes, capacity, start, end,
                                         out, s); break;
    case kI16: rc = launch_reduce<int16_t>(op, x, lanes, capacity, start,
                                           end, out, s); break;
    case kI32: rc = launch_reduce<int32_t>(op, x, lanes, capacity, start,
                                           end, out, s); break;
    case kI64: rc = launch_reduce<int64_t>(op, x, lanes, capacity, start,
                                           end, out, s); break;
    case kF32: rc = launch_reduce<float>(op, x, lanes, capacity, start, end,
                                         out, s); break;
    case kF64: rc = launch_reduce<double>(op, x, lanes, capacity, start,
                                          end, out, s); break;
    default: rc = cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* srt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
