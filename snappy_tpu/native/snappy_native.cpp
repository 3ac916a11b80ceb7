// Native C++ Snappy codec: the host-side fast path and speed/size baseline.
//
// Plays the role the benchmark-only libsnappy ccall shim plays in the
// reference (reference test/libsnappy.jl:5-30) plus serves as the production
// host codec of this framework. Implements the identical greedy LZ77
// algorithm as snappy_tpu.cpu.oracle (multiplicative-hash probe scan with the
// 32-miss skip heuristic, 64-byte copy chunking, per-64KiB-block table reset;
// behavioural contract: reference src/internal.jl:127-329 encode, :411-527
// decode) — written from the format specification, word-at-a-time.
//
// Exposed as a tiny C ABI consumed via ctypes (snappy_tpu/native/runtime.py).

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr size_t kBlockSize = 1u << 16;
constexpr size_t kInputMargin = 15;
constexpr size_t kMaxHashTableSize = 1u << 14;
constexpr uint32_t kHashMul = 0x1e35a7bd;

inline uint32_t Load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, sizeof(v));
  return v;  // little-endian hosts only (x86/ARM LE); asserted in runtime.py
}

inline uint64_t Load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, sizeof(v));
  return v;
}

inline uint32_t HashDword(uint32_t bytes, int shift) {
  return (bytes * kHashMul) >> shift;
}

// Varint32 ------------------------------------------------------------------

inline size_t VarintLength(uint64_t v) {
  size_t n = 1;
  while (v >= 0x80) { v >>= 7; ++n; }
  return n;
}

inline uint8_t* VarintEncode32(uint8_t* dst, uint32_t v) {
  while (v >= 0x80) {
    *dst++ = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  *dst++ = static_cast<uint8_t>(v);
  return dst;
}

// Returns bytes consumed (0 on failure). The 5th byte must be < 0x10
// (32-bit overflow check, reference src/varint.jl:33).
inline size_t VarintParse32(const uint8_t* p, size_t n, uint32_t* out) {
  uint32_t result = 0;
  for (size_t i = 0; i < 5; ++i) {
    if (i >= n) return 0;
    uint32_t b = p[i];
    if (i == 4) {
      if (b >= 0x10) return 0;
      *out = result | (b << 28);
      return 5;
    }
    result |= (b & 0x7f) << (7 * i);
    if (b < 0x80) {
      *out = result;
      return i + 1;
    }
  }
  return 0;
}

// Encoder -------------------------------------------------------------------

inline uint8_t* EmitLiteral(uint8_t* op, const uint8_t* literal, size_t len) {
  size_t n = len - 1;
  if (n < 60) {
    *op++ = static_cast<uint8_t>(n << 2);
  } else {
    uint8_t* base = op++;
    int count = 0;
    size_t v = n;
    while (v > 0) {
      *op++ = static_cast<uint8_t>(v);
      v >>= 8;
      ++count;
    }
    *base = static_cast<uint8_t>((59 + count) << 2);
  }
  std::memcpy(op, literal, len);
  return op + len;
}

inline uint8_t* EmitCopyUpTo64(uint8_t* op, size_t offset, size_t len) {
  if (len < 12 && offset < 2048) {
    *op++ = static_cast<uint8_t>(0x01 | ((len - 4) << 2) | ((offset >> 8) << 5));
    *op++ = static_cast<uint8_t>(offset);
  } else {
    *op++ = static_cast<uint8_t>(0x02 | ((len - 1) << 2));
    *op++ = static_cast<uint8_t>(offset);
    *op++ = static_cast<uint8_t>(offset >> 8);
  }
  return op;
}

inline uint8_t* EmitCopy(uint8_t* op, size_t offset, size_t len) {
  while (len >= 68) {
    op = EmitCopyUpTo64(op, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    op = EmitCopyUpTo64(op, offset, 60);
    len -= 60;
  }
  return EmitCopyUpTo64(op, offset, len);
}

// Longest common prefix of in[i1...] and in[i2...], reading nothing at or
// past `limit` on the i2 side; 8 bytes at a time with a ctz finish.
inline size_t FindMatchLength(const uint8_t* in, size_t i1, size_t i2, size_t limit) {
  size_t matched = 0;
  while (i2 + matched + 8 <= limit) {
    uint64_t a = Load64(in + i1 + matched);
    uint64_t b = Load64(in + i2 + matched);
    if (a == b) {
      matched += 8;
    } else {
      return matched + (__builtin_ctzll(a ^ b) >> 3);
    }
  }
  while (i2 + matched < limit && in[i1 + matched] == in[i2 + matched]) ++matched;
  return matched;
}

// Greedy-parse one block in[ip, ip_end) into op; table has (1<<table_bits)
// entries, pre-zeroed. Returns the new op.
uint8_t* CompressBlock(const uint8_t* in, size_t ip, size_t ip_end,
                       uint16_t* table, int shift, uint8_t* op) {
  const size_t base_ip = ip;
  size_t next_emit = ip;
  if (ip_end - ip >= kInputMargin) {
    const size_t ip_limit = ip_end - kInputMargin;
    ++ip;
    uint32_t next_hash = HashDword(Load32(in + ip), shift);
    for (;;) {
      // Scan for a 4-byte match; probe stride grows after 32 misses so
      // incompressible data bails out fast.
      uint32_t skip = 32;
      size_t next_ip = ip;
      size_t candidate;
      for (;;) {
        ip = next_ip;
        uint32_t h = next_hash;
        uint32_t bytes_between = skip >> 5;
        skip += bytes_between;
        next_ip = ip + bytes_between;
        if (next_ip > ip_limit) goto emit_remainder;
        next_hash = HashDword(Load32(in + next_ip), shift);
        candidate = base_ip + table[h];
        table[h] = static_cast<uint16_t>(ip - base_ip);
        if (Load32(in + candidate) == Load32(in + ip)) break;
      }
      op = EmitLiteral(op, in + next_emit, ip - next_emit);
      // Emit copies while they chain back-to-back.
      for (;;) {
        size_t matched = 4 + FindMatchLength(in, candidate + 4, ip + 4, ip_end);
        op = EmitCopy(op, ip - candidate, matched);
        ip += matched;
        next_emit = ip;
        if (ip >= ip_limit) goto emit_remainder;
        // Seed ip-1 too, then probe at ip.
        table[HashDword(Load32(in + ip - 1), shift)] =
            static_cast<uint16_t>(ip - 1 - base_ip);
        uint32_t cur = Load32(in + ip);
        uint32_t h = HashDword(cur, shift);
        candidate = base_ip + table[h];
        table[h] = static_cast<uint16_t>(ip - base_ip);
        if (cur != Load32(in + candidate)) break;
      }
      ++ip;
      next_hash = HashDword(Load32(in + ip), shift);
    }
  }
emit_remainder:
  if (next_emit < ip_end) {
    op = EmitLiteral(op, in + next_emit, ip_end - next_emit);
  }
  return op;
}

// Decoder -------------------------------------------------------------------

// LUT built at namespace scope from the tag semantics (see
// snappy_tpu/core/constants.py for the bit-layout derivation).
struct CharTable {
  uint16_t entry[256];
  constexpr CharTable() : entry() {
    for (int c = 0; c < 256; ++c) {
      const int kind = c & 3;
      const int hi6 = c >> 2;
      uint16_t e = 0;
      if (kind == 0) {
        e = (hi6 < 60) ? static_cast<uint16_t>(hi6 + 1)
                       : static_cast<uint16_t>(1 | ((hi6 - 59) << 11));
      } else if (kind == 1) {
        e = static_cast<uint16_t>((4 + (hi6 & 7)) | (((c >> 5) & 7) << 8) | (1 << 11));
      } else if (kind == 2) {
        e = static_cast<uint16_t>((hi6 + 1) | (2 << 11));
      } else {
        e = static_cast<uint16_t>((hi6 + 1) | (4 << 11));
      }
      entry[c] = e;
    }
  }
};
constexpr CharTable kCharTable;

constexpr uint32_t kWordMask[5] = {0, 0xff, 0xffff, 0xffffff, 0xffffffff};

}  // namespace

extern "C" {

// Error codes shared with runtime.py.
enum {
  SNAPPY_TPU_OK = 0,
  SNAPPY_TPU_CORRUPT = 1,
  SNAPPY_TPU_BUFFER_TOO_SMALL = 2,
  SNAPPY_TPU_TOO_LARGE = 3,
};

size_t snappy_tpu_max_compressed_length(size_t n) {
  return 32 + n + n / 6;
}

// Compress in[0,n) into out (capacity out_cap >= max_compressed_length(n)).
// Writes compressed size to *out_len.
int snappy_tpu_compress(const uint8_t* in, size_t n,
                        uint8_t* out, size_t out_cap, size_t* out_len) {
  if (n > 0xffffffffull) return SNAPPY_TPU_TOO_LARGE;
  if (out_cap < snappy_tpu_max_compressed_length(n)) return SNAPPY_TPU_BUFFER_TOO_SMALL;
  uint8_t* op = VarintEncode32(out, static_cast<uint32_t>(n));

  size_t table_size = 256;
  while (table_size < kMaxHashTableSize && table_size < n) table_size <<= 1;
  int shift = 32 - __builtin_ctzll(table_size);
  uint16_t table[kMaxHashTableSize];

  for (size_t block = 0; block < n; block += kBlockSize) {
    std::memset(table, 0, table_size * sizeof(uint16_t));
    size_t end = block + kBlockSize < n ? block + kBlockSize : n;
    op = CompressBlock(in, block, end, table, shift, op);
  }
  *out_len = static_cast<size_t>(op - out);
  return SNAPPY_TPU_OK;
}

// Batched HEADERLESS block compress for the routed encode path
// (ops/route.py): one call compresses every selected row of a (B, row_w)
// block matrix, amortizing the per-call binding cost of a per-block loop.
// idx[k] selects row k's block; lens[k] is its byte length; row k's tag
// stream lands at out + k * out_stride with its size in out_lens[k].
int snappy_tpu_compress_rows(const uint8_t* in, size_t row_w,
                             const int64_t* idx, const int32_t* lens,
                             size_t k_rows, uint8_t* out, size_t out_stride,
                             uint32_t* out_lens) {
  uint16_t table[kMaxHashTableSize];
  for (size_t k = 0; k < k_rows; ++k) {
    const uint8_t* blk = in + static_cast<size_t>(idx[k]) * row_w;
    const size_t n = static_cast<size_t>(lens[k]);
    if (snappy_tpu_max_compressed_length(n) > out_stride)
      return SNAPPY_TPU_BUFFER_TOO_SMALL;
    size_t table_size = 256;
    while (table_size < kMaxHashTableSize && table_size < n) table_size <<= 1;
    int shift = 32 - __builtin_ctzll(table_size);
    uint8_t* op = out + k * out_stride;
    uint8_t* op0 = op;
    for (size_t block = 0; block < n; block += kBlockSize) {
      std::memset(table, 0, table_size * sizeof(uint16_t));
      size_t end = block + kBlockSize < n ? block + kBlockSize : n;
      op = CompressBlock(blk, block, end, table, shift, op);
    }
    out_lens[k] = static_cast<uint32_t>(op - op0);
  }
  return SNAPPY_TPU_OK;
}

int snappy_tpu_uncompressed_length(const uint8_t* in, size_t n,
                                   uint64_t* result, size_t* header_len) {
  uint32_t v;
  size_t consumed = VarintParse32(in, n, &v);
  if (consumed == 0) return SNAPPY_TPU_CORRUPT;
  *result = v;
  *header_len = consumed;
  return SNAPPY_TPU_OK;
}

// Decode a raw stream. out_cap must be >= the header's claimed length (the
// caller allocates from snappy_tpu_uncompressed_length). Enforces the
// reference's corruption checks (offset==0, range overruns, length mismatch).
int snappy_tpu_uncompress(const uint8_t* in, size_t n,
                          uint8_t* out, size_t out_cap, size_t* out_len) {
  uint32_t ulen32;
  size_t ip = VarintParse32(in, n, &ulen32);
  if (ip == 0) return SNAPPY_TPU_CORRUPT;
  const size_t ulen = ulen32;
  if (out_cap < ulen) return SNAPPY_TPU_BUFFER_TOO_SMALL;

  size_t op = 0;
  // A tag at the final byte can never complete; loop needs >=2 bytes left.
  while (ip + 1 < n) {
    const uint8_t c = in[ip++];
    const uint16_t entry = kCharTable.entry[c];
    const size_t taglen = entry >> 11;
    uint32_t trailer;
    if (ip + 4 <= n) {
      trailer = Load32(in + ip) & kWordMask[taglen];
    } else {
      uint8_t tmp[4] = {0, 0, 0, 0};
      std::memcpy(tmp, in + ip, n - ip);
      trailer = Load32(tmp) & kWordMask[taglen];
    }
    size_t len = entry & 0xff;
    ip += taglen;
    if ((c & 3) != 0) {
      const size_t offset = (entry & 0x700) + trailer;
      if (offset == 0 || op < offset) return SNAPPY_TPU_CORRUPT;
      if (ulen - op < len) return SNAPPY_TPU_CORRUPT;
      size_t src = op - offset;
      if (offset >= 8 && len <= 16 && ulen - op >= 16) {
        // Two 8-byte word copies cover the common short non-overlapping case.
        std::memcpy(out + op, out + src, 8);
        std::memcpy(out + op + 8, out + src + 8, 8);
      } else if (offset >= len) {
        std::memcpy(out + op, out + src, len);
      } else {
        for (size_t i = 0; i < len; ++i) out[op + i] = out[src + i];
      }
      op += len;
    } else {
      const size_t lit = len + trailer;
      // ip may have run past n via a truncated multi-byte tag; check before
      // the unsigned subtraction.
      if (ip > n || n - ip < lit || ulen - op < lit) return SNAPPY_TPU_CORRUPT;
      std::memcpy(out + op, in + ip, lit);
      ip += lit;
      op += lit;
    }
  }
  if (op != ulen) return SNAPPY_TPU_CORRUPT;
  *out_len = op;
  return SNAPPY_TPU_OK;
}

// Scan a HEADERLESS tag stream (no output materialization) and segment it
// for block-parallel device decode (ops/host.py fast path): a new segment
// begins at the first TAG boundary at-or-after every 64 KiB of output
// since the previous segment start. Block-based encoders — libsnappy, the
// reference (src/Snappy.jl:29-33), this framework — yield exact 64 KiB
// segments; non-blocking encoders (e.g. the alice29.snappy fixture's
// producer) yield segments in [64 KiB, 128 KiB) wherever a tag straddles
// the mark. The one thing that defeats segmentation is a copy whose
// source reaches BEHIND its segment start (a true sequential dependency):
// then -1 is returned and the caller falls back to the sequential-capable
// decoder. The walk touches only tag bytes: memory speed, ~50x lighter
// than a decode.
//
// Returns >= 0: segment count (starts[i] = input offset of segment i's
// tags, oplens[i] = its uncompressed length); -1: not segmentable;
// -2: corrupt.
int64_t snappy_tpu_scan_blocks(const uint8_t* in, size_t n, uint64_t ulen,
                               uint32_t* starts, uint32_t* oplens,
                               size_t starts_cap) {
  size_t ip = 0, op = 0, blk = 0, seg_start = 0;
  while (ip + 1 < n) {
    if (op - seg_start >= kBlockSize || blk == 0) {
      if (op >= ulen && !(blk == 0 && ulen == 0)) return -2;
      if (blk == starts_cap) return -2;
      if (blk > 0) oplens[blk - 1] = static_cast<uint32_t>(op - seg_start);
      seg_start = op;
      starts[blk++] = static_cast<uint32_t>(ip);
    }
    const uint8_t c = in[ip++];
    const uint16_t entry = kCharTable.entry[c];
    const size_t taglen = entry >> 11;
    uint32_t trailer;
    if (ip + 4 <= n) {
      trailer = Load32(in + ip) & kWordMask[taglen];
    } else {
      uint8_t tmp[4] = {0, 0, 0, 0};
      std::memcpy(tmp, in + ip, n - ip);
      trailer = Load32(tmp) & kWordMask[taglen];
    }
    size_t len = entry & 0xff;
    ip += taglen;
    if ((c & 3) != 0) {
      const size_t offset = (entry & 0x700) + trailer;
      if (offset == 0 || op < offset || ulen - op < len) return -2;
      // A copy reaching behind its segment start is a real cross-segment
      // dependency. MERGE the segment into its predecessor(s) instead of
      // giving up: the block decoders' output window covers segments up
      // to 128 KiB of output (the cap check below declines the rest), so
      // back-references crossing one 64 KiB mark stay on the fast path.
      // oplens[blk-1] is rewritten at the merged segment's eventual
      // closure.
      while (op - offset < seg_start) {
        if (blk < 2) return -1;
        --blk;
        seg_start -= oplens[blk - 1];
      }
      op += len;
    } else {
      const size_t lit = len + trailer;
      if (ip > n || n - ip < lit || ulen - op < lit) return -2;
      ip += lit;
      op += lit;
    }
    // A tag may overshoot the 64 KiB segmentation mark by its own output;
    // the block decoders' output window (ops/host.py: 1 << 17 bytes)
    // covers exactly two marks' worth. Segments a single tag stretches
    // past 128 KiB fall back to the windowed decoder.
    if (op - seg_start > (1u << 17)) return -1;
  }
  if (op != ulen) return -2;
  if (blk > 0) oplens[blk - 1] = static_cast<uint32_t>(op - seg_start);
  return static_cast<int64_t>(blk);
}

}  // extern "C"
