// CRC32C (Castagnoli, reflected polynomial 0x82F63B78) on the host: the
// checksum of every spill range and shuffle block
// (spark_rapids_tpu_torch/utils/checksum.py; the reference's
// utils/checksum.py takes it from google_crc32c).
//
// A host routine, not a device kernel: spill payloads are checksummed
// where they are written and read, in host memory. Where the CPU has
// SSE4.2 its `crc32` instruction takes 8 bytes a step over three
// interleaved streams (the instruction's latency is three cycles, its
// throughput one a cycle), joined by a table-driven shift of the first
// two streams' CRCs past the bytes after them; elsewhere slicing-by-8
// tables take 8 bytes a step. One thread reads memory at about the rate
// the instruction consumes it, so a buffer of at least kSplitMin bytes
// is cut into up to kMaxThreads pieces checksummed on threads of their
// own and joined by shifting each piece's CRC past the pieces after it
// (x^(8 len) mod P by squaring, as zlib's crc32_combine does).
// `srt_crc32c(p, n, value)` continues `value` as
// google_crc32c.extend(value, data) does: crc32c(a + b) ==
// srt_crc32c(b, srt_crc32c(a, 0)).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(__i386__)
#include <nmmintrin.h>
#define SRT_X86 1
#endif

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;

struct Tables {
  uint32_t t[8][256];
  // shift[k][b]: the CRC register after feeding kBlock zero bytes into a
  // register holding byte b at byte position k (k = 0 lowest).
  uint32_t shift[4][256];
};

constexpr int64_t kBlock = 4096;  // bytes of each of the three streams

uint32_t zeros_step(const Tables& tb, uint32_t reg, int64_t n) {
  for (int64_t i = 0; i < n; ++i) reg = (reg >> 8) ^ tb.t[0][reg & 0xFF];
  return reg;
}

Tables make_tables() {
  Tables tb;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
    tb.t[0][i] = c;
  }
  for (int s = 1; s < 8; ++s)
    for (int i = 0; i < 256; ++i)
      tb.t[s][i] = (tb.t[s - 1][i] >> 8) ^ tb.t[0][tb.t[s - 1][i] & 0xFF];
  // The zero-byte shift is linear in the register: image of each bit.
  uint32_t col[32];
  for (int b = 0; b < 32; ++b) col[b] = zeros_step(tb, 1u << b, kBlock);
  for (int k = 0; k < 4; ++k)
    for (int v = 0; v < 256; ++v) {
      uint32_t r = 0;
      for (int bit = 0; bit < 8; ++bit)
        if (v & (1 << bit)) r ^= col[8 * k + bit];
      tb.shift[k][v] = r;
    }
  return tb;
}

const Tables& tables() {
  static const Tables tb = make_tables();
  return tb;
}

inline uint32_t shift_block(const Tables& tb, uint32_t reg) {
  return tb.shift[0][reg & 0xFF] ^ tb.shift[1][(reg >> 8) & 0xFF] ^
         tb.shift[2][(reg >> 16) & 0xFF] ^ tb.shift[3][reg >> 24];
}

// Raw register update (no pre/post inversion), slicing-by-8.
uint32_t sw_update(uint32_t reg, const uint8_t* p, int64_t n) {
  const Tables& tb = tables();
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    const uint32_t lo = static_cast<uint32_t>(w) ^ reg;
    const uint32_t hi = static_cast<uint32_t>(w >> 32);
    reg = tb.t[7][lo & 0xFF] ^ tb.t[6][(lo >> 8) & 0xFF] ^
          tb.t[5][(lo >> 16) & 0xFF] ^ tb.t[4][lo >> 24] ^
          tb.t[3][hi & 0xFF] ^ tb.t[2][(hi >> 8) & 0xFF] ^
          tb.t[1][(hi >> 16) & 0xFF] ^ tb.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) reg = (reg >> 8) ^ tb.t[0][(reg ^ *p++) & 0xFF];
  return reg;
}

#ifdef SRT_X86
__attribute__((target("sse4.2"))) uint32_t hw_update(uint32_t reg,
                                                      const uint8_t* p,
                                                      int64_t n) {
  const Tables& tb = tables();
  uint64_t r = reg;
  while (n >= 3 * kBlock) {
    uint64_t a = r, b = 0, c = 0;
    const uint8_t* pa = p;
    const uint8_t* pb = p + kBlock;
    const uint8_t* pc = p + 2 * kBlock;
    for (int64_t i = 0; i < kBlock; i += 8) {
      uint64_t wa, wb, wc;
      std::memcpy(&wa, pa + i, 8);
      std::memcpy(&wb, pb + i, 8);
      std::memcpy(&wc, pc + i, 8);
      a = _mm_crc32_u64(a, wa);
      b = _mm_crc32_u64(b, wb);
      c = _mm_crc32_u64(c, wc);
    }
    // a covers stream 1, b stream 2, c stream 3: shift each past the
    // streams after it (the register is linear, so shifting and XOR
    // compose).
    uint32_t s = shift_block(tb, static_cast<uint32_t>(a)) ^
                 static_cast<uint32_t>(b);
    r = shift_block(tb, s) ^ static_cast<uint32_t>(c);
    p += 3 * kBlock;
    n -= 3 * kBlock;
  }
  while (n >= 8) {
    uint64_t w;
    std::memcpy(&w, p, 8);
    r = _mm_crc32_u64(r, w);
    p += 8;
    n -= 8;
  }
  uint32_t r32 = static_cast<uint32_t>(r);
  while (n-- > 0) r32 = _mm_crc32_u8(r32, *p++);
  return r32;
}
#endif

// The GF(2) 32x32 matrix (as 32 column images) of "feed n zero bytes
// into the raw register", by repeated squaring of the one-bit step.
uint32_t gf2_times(const uint32_t* mat, uint32_t vec) {
  uint32_t sum = 0;
  for (int i = 0; vec; ++i, vec >>= 1)
    if (vec & 1) sum ^= mat[i];
  return sum;
}

void gf2_square(uint32_t* square, const uint32_t* mat) {
  for (int i = 0; i < 32; ++i) square[i] = gf2_times(mat, mat[i]);
}

// The raw register `reg` advanced past `len` zero bytes.
uint32_t shift_zeros(uint32_t reg, int64_t len) {
  uint32_t odd[32], even[32];
  odd[0] = kPoly;  // one zero bit
  for (int i = 1; i < 32; ++i) odd[i] = 1u << (i - 1);
  gf2_square(even, odd);  // two zero bits
  gf2_square(odd, even);  // four zero bits
  do {
    gf2_square(even, odd);  // first: one zero byte
    if (len & 1) reg = gf2_times(even, reg);
    len >>= 1;
    if (!len) break;
    gf2_square(odd, even);
    if (len & 1) reg = gf2_times(odd, reg);
    len >>= 1;
  } while (len);
  return reg;
}

bool use_hw() {
#ifdef SRT_X86
  static const bool hw = __builtin_cpu_supports("sse4.2");
  return hw;
#else
  return false;
#endif
}

}  // namespace

extern "C" {

const char* srt_error_string(int code) {
  return code == 0 ? "ok" : "unknown error";
}

// 1 when the SSE4.2 instruction path runs on this host, else 0 (the
// slicing-by-8 tables).
int srt_crc32c_hw() { return use_hw() ? 1 : 0; }

// CRC32C of p[0, n), continuing `value` (0 to start).
uint32_t srt_crc32c(const uint8_t* p, int64_t n, uint32_t value) {
  constexpr int64_t kSplitMin = int64_t(8) << 20;
  constexpr int64_t kPiece = int64_t(4) << 20;
  constexpr int kMaxThreads = 8;
  auto update = [](uint32_t reg, const uint8_t* q, int64_t m) {
#ifdef SRT_X86
    if (use_hw()) return hw_update(reg, q, m);
#endif
    return sw_update(reg, q, m);
  };
  const uint32_t reg0 = value ^ 0xFFFFFFFFu;
  if (n < kSplitMin) return update(reg0, p, n) ^ 0xFFFFFFFFu;
  static const int hw = static_cast<int>(std::thread::hardware_concurrency());
  const int parts = static_cast<int>(std::min<int64_t>(
      std::min(kMaxThreads, std::max(hw, 1)), n / kPiece));
  if (parts < 2) return update(reg0, p, n) ^ 0xFFFFFFFFu;
  // piece i: [bounds[i], bounds[i + 1]); the first continues `value`,
  // the others start from a zero register
  std::vector<int64_t> bounds(parts + 1);
  for (int i = 0; i <= parts; ++i) bounds[i] = n * i / parts;
  std::vector<uint32_t> regs(parts);
  std::vector<std::thread> threads;
  threads.reserve(parts - 1);
  for (int i = 1; i < parts; ++i)
    threads.emplace_back([&, i] {
      regs[i] = update(0, p + bounds[i], bounds[i + 1] - bounds[i]);
    });
  regs[0] = update(reg0, p, bounds[1]);
  for (auto& t : threads) t.join();
  uint32_t reg = regs[0];
  for (int i = 1; i < parts; ++i)
    reg = shift_zeros(reg, bounds[i + 1] - bounds[i]) ^ regs[i];
  return reg ^ 0xFFFFFFFFu;
}

// CRC32C with the slicing-by-8 tables alone (the route the SSE4.2 path
// is held against).
uint32_t srt_crc32c_sw(const uint8_t* p, int64_t n, uint32_t value) {
  return sw_update(value ^ 0xFFFFFFFFu, p, n) ^ 0xFFFFFFFFu;
}

}  // extern "C"
