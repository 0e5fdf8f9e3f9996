// Run tables of parquet's RLE/bit-packed hybrid streams on the host: the
// C++ counterpart of `io/parquet_device.py parse_hybrid`, which the scan
// on the card calls once per stream (definition levels, dictionary
// indices) from the pipeline's worker threads. ctypes releases the GIL
// around the call, so the workers slice their row groups' streams side by
// side, as they decompress them.
//
// A host routine, not a device kernel: the run headers lie inside the
// decompressed page payloads, and the run tables are what goes to the
// card. Each run is (kind, count, value, bit start, width): kind 1 is an
// RLE run (its value repeated count times), kind 0 a bit-packed run
// (count values of `width` bits from bit `bit start` of the staging
// buffer). Counts cap at the page's value count, so a padded last
// bit-packed group never leaks positions into the next page; a stream
// that stops short ends in an RLE run of zeros when `pad_tail` is set.
// Every read is bounds-checked: malformed input returns an error code.

#include <cstdint>

namespace {

enum : int {
  kOk = 0,
  kBadVarint = 1,   // a run header runs past the buffer or 63 bits
  kPackedPast = 2,  // a bit-packed run runs past its stream
  kRlePast = 3,     // an RLE run's value runs past its stream
  kMoreRuns = 4,    // the output holds fewer runs than the stream
  kBadArgs = 5,     // bit width outside 0..32, or a bad range
};

}  // namespace

extern "C" {

const char* srt_error_string(int code) {
  switch (code) {
    case kOk: return "ok";
    case kBadVarint: return "run header runs past the stream or 63 bits";
    case kPackedPast: return "bit-packed run runs past its stream";
    case kRlePast: return "RLE run runs past its stream";
    case kMoreRuns: return "more runs than the output holds";
    case kBadArgs: return "bit width outside 0..32 or a bad stream range";
    default: return "unknown error";
  }
}

// Slice buf[pos:end] (buf holds buf_len bytes; a run header may be read
// up to buf_len) into runs. `base` is buf's byte offset in the staging
// buffer, which bit-packed runs point into. runs: 5 rows of `cap`
// int64 (kinds, counts, values, bit starts, widths); *n_runs gets the
// number written, *ones the values equal to 1 of a width-1 stream (a
// page's non-null rows, from its definition levels; 0 for other widths).
int srt_parse_hybrid(const uint8_t* buf, int64_t buf_len, int64_t pos,
                     int64_t end, int32_t bit_width, int64_t n_values,
                     int64_t base, int32_t pad_tail, int64_t* runs,
                     int64_t cap, int64_t* n_runs, int64_t* ones) {
  *n_runs = 0;
  *ones = 0;
  if (bit_width < 0 || bit_width > 32 || pos < 0 || end > buf_len ||
      n_values < 0)
    return kBadArgs;
  int64_t* kinds = runs;
  int64_t* counts = runs + cap;
  int64_t* values = runs + 2 * cap;
  int64_t* bit_starts = runs + 3 * cap;
  int64_t* widths = runs + 4 * cap;
  const int64_t byte_w = (bit_width + 7) / 8;
  int64_t produced = 0, n = 0, set = 0;
  int64_t p = pos;
  while (produced < n_values && p < end) {
    uint64_t header = 0;
    for (int shift = 0;; shift += 7) {
      if (p >= buf_len || shift > 56) return kBadVarint;
      const uint8_t b = buf[p++];
      header |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) break;
    }
    if (n >= cap) return kMoreRuns;
    const int64_t left = n_values - produced;
    int64_t count;
    if (header & 1) {  // bit-packed: (header >> 1) groups of 8 values
      const uint64_t groups = header >> 1;
      count = groups >= static_cast<uint64_t>((left + 7) / 8)
                  ? left
                  : static_cast<int64_t>(groups * 8);
      if (bit_width > 0 &&
          groups > static_cast<uint64_t>((end - p) / bit_width))
        return kPackedPast;
      const int64_t nbytes = static_cast<int64_t>(groups) * bit_width;
      kinds[n] = 0;
      counts[n] = count;
      values[n] = 0;
      bit_starts[n] = (base + p) * 8;
      widths[n] = bit_width;
      if (bit_width == 1) {
        const uint8_t* q = buf + p;
        const int64_t full = count >> 3;
        for (int64_t i = 0; i < full; ++i) set += __builtin_popcount(q[i]);
        if (count & 7)
          set += __builtin_popcount(q[full] & ((1u << (count & 7)) - 1));
      }
      p += nbytes;
    } else {
      const uint64_t rle = header >> 1;
      count = rle >= static_cast<uint64_t>(left) ? left
                                                 : static_cast<int64_t>(rle);
      if (p + byte_w > end) return kRlePast;
      int64_t v = 0;
      for (int64_t i = 0; i < byte_w; ++i)
        v |= static_cast<int64_t>(buf[p + i]) << (8 * i);
      kinds[n] = 1;
      counts[n] = count;
      values[n] = v;
      bit_starts[n] = 0;
      widths[n] = bit_width;
      if (bit_width == 1) set += count * (v & 1);
      p += byte_w;
    }
    ++n;
    produced += count;
  }
  if (pad_tail && produced < n_values) {
    if (n >= cap) return kMoreRuns;
    kinds[n] = 1;
    counts[n] = n_values - produced;
    values[n] = 0;
    bit_starts[n] = 0;
    widths[n] = bit_width;
    ++n;
  }
  *n_runs = n;
  *ones = set;
  return kOk;
}

}  // extern "C"
