// Batched Snappy block decoder for NVIDIA Hopper (sm_90a), called from JAX
// through the XLA FFI (snappy_tpu/ops/decode_cuda.py registers it).
//
// Contract: exactly that of decode_xla.decode_blocks_jit, bit for bit,
// including the bytes past each block's claimed length and the output of
// corrupt blocks:
//
//   (comp u8[B, C], clens i32[B], ulens i32[B])
//       -> (out u8[B, NU], ok pred[B], total i32[B])
//
// with C = cmax + COMP_PAD (4 zero slack bytes past every stream) and
// clens[b] <= C - 4.
//
// One thread block of two warps decodes one Snappy block. The tag walk is
// serial (each tag's length says where the next begins, reference
// src/internal.jl:411-466), so the two warps split it as producer and
// consumer:
//
//   - the walker warp parses tags (all lanes in lockstep, reading the same
//     shared-memory bytes) and writes one 16-byte record per tag into a
//     double-buffered batch of kBatch records;
//   - the writer warp moves each record's output bytes with its 32 lanes,
//     one batch behind the walker; a block barrier separates batches;
//   - the output window (NU bytes) lives in shared memory, so copies read
//     their source at shared-memory latency; the compressed row reaches
//     the walker through a kWindowBytes shared window, refilled with
//     16-byte loads whenever the walk crosses its end;
//   - copies whose offset is below their length (RLE) replicate the
//     period [o0 - off, o0) in one pass: out[o] = out[o0 - off + (o - o0) % off].
//
// Traffic per block is one read of the compressed row and one write of the
// output row; decode_xla instead materialises O(N log N) index arrays.
//
// decode_xla semantics reproduced here (see decode_xla.decode_blocks_impl):
//   - tags are walked from position 0 while p < clen - 1; the next position
//     is min(p + consumed, C - 4);
//   - a tag's trailer bytes at row index >= C & ~3 read as zero, and the
//     trailer is clamped to C - 4 + NU + 16;
//   - per tag, copies are bad if offset == 0, offset > output position, or
//     they run past ulen or their tag past clen; literals are bad if they
//     run past clen or ulen; ok = no bad tag and total == ulen;
//   - output byte o takes the last tag starting at or before o (the last
//     tag also covers every byte past the total, and with no tag at all a
//     literal at row index 1 covers the row); a literal (or a copy whose
//     offset is 0) reads comp[min(litsrc + o - opos, C - 1)], a copy takes
//     out[max(o - offset, 0)].

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 2 * kWarp;
// Compressed bytes staged in shared memory per block.
constexpr int kWindowBytes = 4096;
// Tag records per batch; two batches are in flight.
constexpr int kBatch = 32;
constexpr int kRecordBytes = 2 * kBatch * 16 + 16;
// Shared memory one block may use on Hopper (227 KiB).
constexpr int kMaxSharedBytes = 232448;

// One tag's output: bytes [o0, o1) of the window. off < 0 marks bytes taken
// from the compressed row at index litbase + o; otherwise a copy at offset off.
struct Record {
  int o0, o1, off, litbase;
};

__device__ __forceinline__ uint32_t row_byte(const uint8_t* __restrict__ g, int c, int idx) {
  return __ldg(g + min(idx, c - 1));
}

__device__ __forceinline__ void emit(uint8_t* out, const uint8_t* __restrict__ g, int c, Record r,
                                     int lane) {
  const int o0 = r.o0, o1 = r.o1, off = r.off;
  if (o0 >= o1) return;
  if (off < 0) {
#pragma unroll 4
    for (int o = o0 + lane; o < o1; o += kWarp) out[o] = row_byte(g, c, r.litbase + o);
  } else if (o0 >= off) {
    if (off >= o1 - o0) {
      for (int o = o0 + lane; o < o1; o += kWarp) out[o] = out[o - off];
    } else {
      const int src0 = o0 - off;
      for (int o = o0 + lane; o < o1; o += kWarp) out[o] = out[src0 + (o - o0) % off];
    }
  } else if (lane == 0) {
    // Source reaches before the block (a corrupt stream): byte by byte,
    // with the source clamped to 0 as decode_xla clamps it.
    for (int o = o0; o < o1; ++o) {
      const int src = max(o - off, 0);
      out[o] = src == o ? row_byte(g, c, r.litbase + o) : out[src];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
    decode_blocks_kernel(const uint8_t* __restrict__ comp, int c, const int32_t* __restrict__ clens,
                         const int32_t* __restrict__ ulens, uint8_t* __restrict__ out_g, bool* ok_g,
                         int32_t* total_g, int nu) {
  extern __shared__ uint4 smem[];
  uint8_t* win = reinterpret_cast<uint8_t*>(smem);
  Record* recs = reinterpret_cast<Record*>(win + kWindowBytes);  // [2][kBatch]
  int* counts = reinterpret_cast<int*>(recs + 2 * kBatch);       // [2]
  uint8_t* out = win + kWindowBytes + kRecordBytes;

  const int b = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const uint8_t* g = comp + static_cast<size_t>(b) * c;

  // Walker state (warp 0).
  const int nc = c - 4;
  const int c4 = c & ~3;
  const int clen = clens[b];
  const int ulen = ulens[b];
  const uint32_t limit = static_cast<uint32_t>(nc + nu + 16);
  const int stop = min(clen - 1, nc);
  int wbase = -(1 << 30);
  int p = 0;
  int topos = 0;
  bool bad = false;
  bool finished = false;
  // The last tag so far; with no tag at all, a literal at row index 1.
  Record last{0, 0, -1, 1};

  for (int k = 0;; ++k) {
    const int slot = k & 1;
    if (warp == 0) {
      int n = 0;
      while (!finished && n < kBatch) {
        if (p >= stop) {
          // The last tag also produces every byte past the total.
          last.o0 = min(topos, nu);
          last.o1 = nu;
          if (lane == 0) {
            recs[slot * kBatch + n] = last;
            ok_g[b] = !bad && topos == ulen;
            total_g[b] = topos;
          }
          ++n;
          finished = true;
          break;
        }
        if (p + 5 > wbase + kWindowBytes) {
          // Stage the row from p on; the window's first byte is 16-byte
          // aligned in global memory, so p lands in its first 16 bytes.
          const int base = p - static_cast<int>(reinterpret_cast<uintptr_t>(g + p) & 15);
          __syncwarp();
          for (int q = lane; q < kWindowBytes / 16; q += kWarp) {
            const int i = base + 16 * q;
            union {
              uint4 v;
              uint8_t bytes[16];
            } u;
            if (i >= 0 && i + 16 <= c) {
              u.v = __ldg(reinterpret_cast<const uint4*>(g + i));
            } else {
#pragma unroll
              for (int j = 0; j < 16; ++j) u.bytes[j] = (i + j >= 0 && i + j < c) ? g[i + j] : 0;
            }
            smem[q] = u.v;
          }
          wbase = base;
          __syncwarp();
        }
        // Bytes p .. p+4 lie in two aligned words of the window.
        const int w = p - wbase;
        const uint32_t* win32 = reinterpret_cast<const uint32_t*>(win);
        const uint32_t lo = win32[w >> 2];
        const uint32_t hi = win32[(w >> 2) + 1];
        const uint32_t sh = 8 * (w & 3);
        const uint32_t b0123 = __funnelshift_r(lo, hi, sh);
        const uint32_t c0 = b0123 & 0xFF;
        const uint32_t word = (b0123 >> 8) | (((hi >> sh) & 0xFF) << 24);
        const uint32_t kind = c0 & 3;
        const uint32_t hi6 = c0 >> 2;
        int length, taglen, offhi = 0;
        if (kind == 0) {
          length = hi6 < 60 ? hi6 + 1 : 1;
          taglen = hi6 < 60 ? 0 : hi6 - 59;
        } else if (kind == 1) {
          length = 4 + (hi6 & 7);
          taglen = 1;
          offhi = (c0 >> 5) << 8;
        } else {
          length = hi6 + 1;
          taglen = kind == 2 ? 2 : 4;
        }
        // Trailer bytes: taglen of them, and none at or past row index c4.
        const int nbytes = min(taglen, max(c4 - p - 1, 0));
        const uint32_t mask = nbytes >= 4 ? 0xFFFFFFFFu : (1u << (8 * nbytes)) - 1u;
        const int trailer = static_cast<int>(min(word & mask, limit));
        const bool is_copy = kind != 0;
        const int lit_len = length + trailer;
        const int out_len = is_copy ? length : lit_len;
        const int consumed = 1 + taglen + (is_copy ? 0 : lit_len);
        const int offset = offhi + trailer;
        if (is_copy) {
          bad |= offset == 0 || topos < offset || topos + out_len > ulen || p + 1 + taglen > clen;
        } else {
          bad |= p + 1 + taglen + lit_len > clen || topos + lit_len > ulen;
        }
        last = Record{min(topos, nu), min(topos + out_len, nu),
                      is_copy && offset != 0 ? offset : -1, p + 1 + taglen - topos};
        if (lane == 0) recs[slot * kBatch + n] = last;
        ++n;
        topos += out_len;
        p = min(p + consumed, nc);
      }
      if (lane == 0) counts[slot] = n;
    } else if (k > 0) {
      const int n = counts[slot ^ 1];
      for (int i = 0; i < n; ++i) emit(out, g, c, recs[(slot ^ 1) * kBatch + i], lane);
    }
    __syncthreads();
    if (counts[slot] == 0) break;
  }

  uint8_t* dst = out_g + static_cast<size_t>(b) * nu;
  if (nu % 16 == 0) {
    for (int q = threadIdx.x; q < nu / 16; q += kThreads)
      reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(out)[q];
  } else {
    for (int o = threadIdx.x; o < nu; o += kThreads) dst[o] = out[o];
  }
}

ffi::Error DecodeBlocksImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> comp,
                            ffi::Buffer<ffi::S32> clens, ffi::Buffer<ffi::S32> ulens,
                            ffi::ResultBuffer<ffi::U8> out, ffi::ResultBuffer<ffi::PRED> ok,
                            ffi::ResultBuffer<ffi::S32> total) {
  const auto cd = comp.dimensions();
  const auto od = out->dimensions();
  if (cd.size() != 2 || od.size() != 2 || cd[0] != od[0])
    return ffi::Error::InvalidArgument("expected comp u8[B, C] and out u8[B, NU]");
  const int64_t nb = cd[0];
  const int64_t c = cd[1];
  const int64_t nu = od[1];
  const int64_t smem = kWindowBytes + kRecordBytes + nu;
  if (c < 5 || nu < 1 || smem > kMaxSharedBytes || c + nu + 16 > INT32_MAX / 2)
    return ffi::Error::InvalidArgument("block shape outside the CUDA decoder's limits");
  if (nb == 0) return ffi::Error::Success();
  cudaError_t err = cudaFuncSetAttribute(decode_blocks_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  decode_blocks_kernel<<<static_cast<unsigned>(nb), kThreads, smem, stream>>>(
      comp.typed_data(), static_cast<int>(c), clens.typed_data(), ulens.typed_data(),
      out->typed_data(), ok->typed_data(), total->typed_data(), static_cast<int>(nu));
  err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SnappyDecodeBlocks, DecodeBlocksImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::PRED>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
