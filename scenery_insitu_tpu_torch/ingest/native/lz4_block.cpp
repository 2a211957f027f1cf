// LZ4 block-format codec — clean-room implementation of the PUBLIC
// block format (token / literal-run / 2-byte LE offset / match-run with
// 255-continuation lengths, 64 KB window, minmatch 4), written for the
// fast-codec role the reference gives LZ4 on its VDI wire path
// (VDICompositingTest.kt:251-304 compresses each per-rank segment before
// the all-to-all; VDICompressionBenchmarks.kt:23-372 benchmarks the LZ4
// family). Greedy single-pass compressor with a 64 Ki-entry hash table;
// the decompressor bounds-checks every read/write so corrupt input
// returns 0 instead of scribbling.
//
// Format notes (spec end conditions honored):
//   - last 5 bytes of the input are always literals;
//   - no match starts within the last 12 bytes;
//   - offsets are 1..65535 (matches beyond the window are not emitted).
// Streams produced here decode with any conformant LZ4 block decoder.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTableBits = 16;
constexpr uint32_t kTableSize = 1u << kTableBits;
constexpr size_t kMinMatch = 4;
constexpr size_t kMaxOffset = 65535;
constexpr size_t kEndLiterals = 5;   // last 5 bytes stay literal
constexpr size_t kMatchGuard = 12;   // no match starts in last 12 bytes

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t hash4(uint32_t v) {
  return (v * 2654435761u) >> (32 - kTableBits);
}

// write a 15+ length with 255-continuations; returns new op or null on
// overflow
inline uint8_t* put_len(uint8_t* op, const uint8_t* oend, size_t rest) {
  while (rest >= 255) {
    if (op >= oend) return nullptr;
    *op++ = 255;
    rest -= 255;
  }
  if (op >= oend) return nullptr;
  *op++ = static_cast<uint8_t>(rest);
  return op;
}

}  // namespace

extern "C" {

// worst case: every byte literal (+run headers) + one final token
uint64_t lz4b_bound(uint64_t n) { return n + n / 255 + 16; }

// returns compressed size, or 0 when dst_cap is too small (or n == 0 —
// the caller handles empty payloads)
uint64_t lz4b_compress(const uint8_t* src, uint64_t n, uint8_t* dst,
                       uint64_t dst_cap) {
  if (n == 0 || !src || !dst) return 0;
  if (n > 0xfffffffeull) return 0;  // positions are stored as u32 + 1
  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  const uint8_t* anchor = src;
  const uint8_t* mflimit = n > kMatchGuard ? iend - kMatchGuard : src;
  const uint8_t* matchlimit = n > kEndLiterals ? iend - kEndLiterals : src;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;

  std::vector<uint32_t> table(kTableSize, 0);  // position + 1; 0 = empty

  while (ip < mflimit) {
    const uint32_t h = hash4(read32(ip));
    const uint32_t cand = table[h];
    table[h] = static_cast<uint32_t>(ip - src) + 1;
    const uint8_t* match = src + cand - 1;
    if (!cand || static_cast<size_t>(ip - match) > kMaxOffset ||
        read32(match) != read32(ip)) {
      ++ip;
      continue;
    }
    // extend the match forward (stays clear of the end-literal zone);
    // 8-byte xor+ctz steps, byte tail
    const uint8_t* i2 = ip + kMinMatch;
    const uint8_t* m2 = match + kMinMatch;
    bool mismatch = false;
    while (i2 + 8 <= matchlimit) {
      const uint64_t x = read64(i2) ^ read64(m2);
      if (x) {
        i2 += __builtin_ctzll(x) >> 3;
        mismatch = true;
        break;
      }
      i2 += 8;
      m2 += 8;
    }
    if (!mismatch)
      while (i2 < matchlimit && *i2 == *m2) {
        ++i2;
        ++m2;
      }
    const size_t mlen = static_cast<size_t>(i2 - ip) - kMinMatch;  // extra
    const size_t lit = static_cast<size_t>(ip - anchor);

    if (op >= oend) return 0;
    uint8_t* token = op++;
    *token = static_cast<uint8_t>((lit >= 15 ? 15 : lit) << 4);
    if (lit >= 15 && !(op = put_len(op, oend, lit - 15))) return 0;
    if (op + lit + 2 > oend) return 0;
    std::memcpy(op, anchor, lit);
    op += lit;
    const size_t off = static_cast<size_t>(ip - match);
    *op++ = static_cast<uint8_t>(off & 0xff);
    *op++ = static_cast<uint8_t>(off >> 8);
    *token |= static_cast<uint8_t>(mlen >= 15 ? 15 : mlen);
    if (mlen >= 15 && !(op = put_len(op, oend, mlen - 15))) return 0;

    ip = i2;
    anchor = ip;
    if (ip < mflimit)  // seed the table inside the skipped match
      table[hash4(read32(ip - 2))] =
          static_cast<uint32_t>(ip - 2 - src) + 1;
  }

  // final run: everything left is literal
  const size_t lit = static_cast<size_t>(iend - anchor);
  if (op >= oend) return 0;
  uint8_t* token = op++;
  *token = static_cast<uint8_t>((lit >= 15 ? 15 : lit) << 4);
  if (lit >= 15 && !(op = put_len(op, oend, lit - 15))) return 0;
  if (op + lit > oend) return 0;
  std::memcpy(op, anchor, lit);
  op += lit;
  return static_cast<uint64_t>(op - dst);
}

// returns decompressed size, or 0 on corrupt input / undersized dst
uint64_t lz4b_decompress(const uint8_t* src, uint64_t n, uint8_t* dst,
                         uint64_t dst_cap) {
  if (!src || !dst) return 0;
  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;

  while (ip < iend) {
    const uint8_t token = *ip++;
    size_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return 0;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (static_cast<size_t>(iend - ip) < lit ||
        static_cast<size_t>(oend - op) < lit)
      return 0;
    std::memcpy(op, ip, lit);
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // last sequence carries no match

    if (iend - ip < 2) return 0;
    const size_t off = static_cast<size_t>(ip[0]) |
                       (static_cast<size_t>(ip[1]) << 8);
    ip += 2;
    if (off == 0 || static_cast<size_t>(op - dst) < off) return 0;
    size_t mlen = token & 15;
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return 0;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += kMinMatch;
    if (static_cast<size_t>(oend - op) < mlen) return 0;
    const uint8_t* m = op - off;
    if (off >= mlen) {
      std::memcpy(op, m, mlen);          // disjoint: straight copy
    } else {
      for (size_t i = 0; i < mlen; ++i)  // overlap is the point (RLE)
        op[i] = m[i];
    }
    op += mlen;
  }
  return static_cast<uint64_t>(op - dst);
}

}  // extern "C"
