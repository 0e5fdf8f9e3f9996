// Raw snappy blocks on the host: what `pa.Codec("snappy")` does for the
// reference's parquet scan and writer (spark_rapids_tpu/io/
// parquet_device.py:254-259, parquet_encode.py:266-269).
//
// A host routine, not a device kernel: parquet's hybrid run headers lie
// inside the compressed page payloads, so the scan decompresses on the
// host and slices run tables there before the upload. Bound: the host's
// memory copy rate (every output byte is written once, every input byte
// read once). One call decompresses a whole column chunk's pages, each
// into its own range of one output buffer, so the Python loop is per
// chunk and not per page; ctypes releases the GIL around the call.
//
// Format (google/snappy format_description.txt): a varint of the
// uncompressed length, then elements whose tag's low two bits say
//   00 literal: length - 1 in the upper six bits, or (60..63) in the
//      next 1-4 bytes;
//   01 copy, length 4-11 (3 bits), offset 11 bits (3 bits + 1 byte);
//   10 copy, length 1-64 (6 bits), 2-byte little-endian offset;
//   11 copy, length 1-64 (6 bits), 4-byte little-endian offset.
// A copy may overlap its own output (offset < length). Every read and
// write is bounds-checked: malformed input returns an error code.
//
// The compressor is a greedy 4-byte-hash matcher over 64 KiB blocks (the
// format's own block size, so offsets fit two bytes), with the skip
// heuristic of google/snappy (after 32 misses, step 2 bytes, ...). It is
// byte-for-byte `io/snappy.py compress_plain`.

#include <cstdint>
#include <cstring>

namespace {

enum : int {
  kOk = 0,
  kTruncated = 1,      // input ends inside a varint, tag or literal
  kLengthMismatch = 2, // preamble length != the page's expected size
  kBadOffset = 3,      // copy offset 0 or before the output's start
  kOverflow = 4,       // element would write past the output's end
  kShort = 5,          // input ends before the output is full
  kBadPage = 6,        // a page's range lies outside src or dst
  kTooSmall = 7,       // compressor output buffer too small
};

constexpr int64_t kBlock = 1 << 16;
constexpr int kHashBits = 14;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

int decompress_one(const uint8_t* src, int64_t n, uint8_t* dst,
                   int64_t expected) {
  const uint8_t* const end = src + n;
  const uint8_t* p = src;
  uint64_t len = 0;
  for (int shift = 0;; shift += 7) {
    if (p >= end || shift > 35) return kTruncated;
    uint8_t b = *p++;
    len |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
  }
  if (static_cast<int64_t>(len) != expected) return kLengthMismatch;
  int64_t out = 0;
  while (p < end) {
    const uint8_t tag = *p++;
    const int kind = tag & 3;
    if (kind == 0) {
      int64_t lit = tag >> 2;
      if (lit >= 60) {
        const int extra = static_cast<int>(lit) - 59;
        if (end - p < extra) return kTruncated;
        lit = 0;
        for (int i = 0; i < extra; ++i)
          lit |= static_cast<int64_t>(p[i]) << (8 * i);
        p += extra;
      }
      lit += 1;
      if (end - p < lit) return kTruncated;
      if (expected - out < lit) return kOverflow;
      if (lit <= 16 && end - p >= 16 && expected - out >= 16) {
        // short literal with slack on both sides: one 16-byte copy (the
        // bytes past it are rewritten by the elements that follow)
        std::memcpy(dst + out, p, 16);
      } else {
        std::memcpy(dst + out, p, static_cast<size_t>(lit));
      }
      p += lit;
      out += lit;
      continue;
    }
    int64_t copy_len, offset;
    if (kind == 1) {
      if (end - p < 1) return kTruncated;
      copy_len = 4 + ((tag >> 2) & 7);
      offset = (static_cast<int64_t>(tag >> 5) << 8) | p[0];
      p += 1;
    } else if (kind == 2) {
      if (end - p < 2) return kTruncated;
      copy_len = (tag >> 2) + 1;
      offset = p[0] | (static_cast<int64_t>(p[1]) << 8);
      p += 2;
    } else {
      if (end - p < 4) return kTruncated;
      copy_len = (tag >> 2) + 1;
      offset = static_cast<int64_t>(load32(p));
      p += 4;
    }
    if (offset == 0 || offset > out) return kBadOffset;
    if (expected - out < copy_len) return kOverflow;
    uint8_t* d = dst + out;
    const uint8_t* s = d - offset;
    if (offset >= 8 && expected - out >= copy_len + 8) {
      // 8-byte pieces never overlap their own source; the last may run
      // up to 7 bytes past the copy, inside the output
      for (int64_t i = 0; i < copy_len; i += 8) std::memcpy(d + i, s + i, 8);
    } else {
      for (int64_t i = 0; i < copy_len; ++i) d[i] = s[i];  // byte by byte
    }
    out += copy_len;
  }
  return out == expected ? kOk : kShort;
}

inline uint8_t* put_varint(uint8_t* o, uint64_t v) {
  while (v >= 0x80) {
    *o++ = static_cast<uint8_t>(v | 0x80);
    v >>= 7;
  }
  *o++ = static_cast<uint8_t>(v);
  return o;
}

inline uint8_t* put_literal(uint8_t* o, const uint8_t* s, int64_t n) {
  if (n <= 0) return o;
  const uint64_t m = static_cast<uint64_t>(n - 1);
  if (m < 60) {
    *o++ = static_cast<uint8_t>(m << 2);
  } else {
    int bytes = 1;
    while (bytes < 4 && (m >> (8 * bytes))) ++bytes;
    *o++ = static_cast<uint8_t>((59 + bytes) << 2);
    for (int i = 0; i < bytes; ++i) *o++ = static_cast<uint8_t>(m >> (8 * i));
  }
  std::memcpy(o, s, static_cast<size_t>(n));
  return o + n;
}

inline uint8_t* put_copy(uint8_t* o, int64_t offset, int64_t len) {
  while (len > 0) {
    const int64_t l = len < 64 ? len : 64;
    if (l >= 4 && l <= 11 && offset < 2048) {
      *o++ = static_cast<uint8_t>(1 | ((l - 4) << 2) | ((offset >> 8) << 5));
      *o++ = static_cast<uint8_t>(offset & 0xff);
    } else {
      *o++ = static_cast<uint8_t>(2 | ((l - 1) << 2));
      *o++ = static_cast<uint8_t>(offset & 0xff);
      *o++ = static_cast<uint8_t>(offset >> 8);
    }
    len -= l;
  }
  return o;
}

}  // namespace

extern "C" {

const char* srt_error_string(int code) {
  switch (code) {
    case kOk: return "ok";
    case kTruncated: return "snappy input ends inside an element";
    case kLengthMismatch:
      return "snappy length preamble differs from the page's size";
    case kBadOffset: return "snappy copy offset is 0 or before the start";
    case kOverflow: return "snappy element writes past the output's end";
    case kShort: return "snappy input ends before the output is full";
    case kBadPage: return "page range lies outside the buffers";
    case kTooSmall: return "compressor output buffer too small";
    default: return "unknown error";
  }
}

// Most bytes `srt_snappy_compress` writes for n input bytes.
int64_t srt_snappy_max_compressed_length(int64_t n) {
  return 32 + n + n / 6;
}

// pages: n_pages x {src offset, src bytes, dst offset, dst bytes}, each
// page one raw snappy block. On error returns its code and sets
// *bad_page to the page's index.
int srt_snappy_decompress_pages(const uint8_t* src, int64_t src_len,
                                const int64_t* pages, int64_t n_pages,
                                uint8_t* dst, int64_t dst_len,
                                int64_t* bad_page) {
  for (int64_t i = 0; i < n_pages; ++i) {
    const int64_t so = pages[4 * i], sn = pages[4 * i + 1];
    const int64_t d_o = pages[4 * i + 2], dn = pages[4 * i + 3];
    *bad_page = i;
    if (so < 0 || sn < 0 || so > src_len - sn || d_o < 0 || dn < 0 ||
        d_o > dst_len - dn)
      return kBadPage;
    const int rc = decompress_one(src + so, sn, dst + d_o, dn);
    if (rc != kOk) return rc;
  }
  *bad_page = -1;
  return kOk;
}

int srt_snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t dst_cap, int64_t* out_len) {
  if (dst_cap < srt_snappy_max_compressed_length(n)) return kTooSmall;
  uint8_t* o = put_varint(dst, static_cast<uint64_t>(n));
  static thread_local uint16_t table[1 << kHashBits];
  for (int64_t bs = 0; bs < n; bs += kBlock) {
    const int64_t be = bs + kBlock < n ? bs + kBlock : n;
    std::memset(table, 0, sizeof(table));  // positions + 1 in the block
    int64_t i = bs, lit = bs;
    uint32_t misses = 32;
    while (i + 4 <= be) {
      const uint32_t v = load32(src + i);
      const uint32_t h = (v * 0x1e35a7bdu) >> (32 - kHashBits);
      const int64_t cand = table[h] ? bs + table[h] - 1 : -1;
      table[h] = static_cast<uint16_t>(i - bs + 1);
      if (cand >= 0 && load32(src + cand) == v) {
        int64_t m = 4;
        while (i + m < be && src[cand + m] == src[i + m]) ++m;
        o = put_literal(o, src + lit, i - lit);
        o = put_copy(o, i - cand, m);
        i += m;
        lit = i;
        misses = 32;
      } else {
        i += misses++ >> 5;
      }
    }
    o = put_literal(o, src + lit, be - lit);
  }
  *out_len = o - dst;
  return kOk;
}

}  // extern "C"
