"""ctypes bindings for the native C++ codec.

The process-internal language boundary of this framework (host side), the
structural analogue of the reference's benchmark ccall shim
(reference test/libsnappy.jl:5-30) — but here it is a first-class backend:
the fast host codec used for framing I/O and as the speed/size baseline the
device kernels are measured against.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np

from ..core.errors import CorruptInputError, InputTooLargeError, SnappyError
from . import build as _build

_OK = 0
_CORRUPT = 1
_BUFFER_TOO_SMALL = 2
_TOO_LARGE = 3

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if sys.byteorder != "little":
        raise SnappyError("native codec requires a little-endian host")
    path = _build.build()
    lib = ctypes.CDLL(path)
    lib.snappy_tpu_max_compressed_length.restype = ctypes.c_size_t
    lib.snappy_tpu_max_compressed_length.argtypes = [ctypes.c_size_t]
    lib.snappy_tpu_compress.restype = ctypes.c_int
    lib.snappy_tpu_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.snappy_tpu_compress_rows.restype = ctypes.c_int
    lib.snappy_tpu_compress_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
    ]
    lib.snappy_tpu_uncompressed_length.restype = ctypes.c_int
    lib.snappy_tpu_uncompressed_length.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.snappy_tpu_uncompress.restype = ctypes.c_int
    lib.snappy_tpu_uncompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.snappy_tpu_scan_blocks.restype = ctypes.c_int64
    lib.snappy_tpu_scan_blocks.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
    ]
    _lib = lib
    return lib


def available() -> bool:
    """True if the native library can be (or has been) built and loaded."""
    try:
        _load()
        return True
    except Exception:
        return False


def _as_buffer(data) -> bytes:
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise TypeError(f"expected uint8 array, got {data.dtype}")
        return data.tobytes()
    if isinstance(data, str):
        return data.encode("utf-8")
    return bytes(data)


def _check(rc: int) -> None:
    if rc == _OK:
        return
    if rc == _CORRUPT:
        raise CorruptInputError("corrupt snappy stream")
    if rc == _TOO_LARGE:
        raise InputTooLargeError("input exceeds 2**32-1 bytes")
    raise SnappyError(f"native codec error {rc}")


def max_compressed_length(n: int) -> int:
    return _load().snappy_tpu_max_compressed_length(n)


def compress(data) -> bytes:
    lib = _load()
    buf = _as_buffer(data)
    n = len(buf)
    out = ctypes.create_string_buffer(max_compressed_length(n))
    out_len = ctypes.c_size_t()
    _check(lib.snappy_tpu_compress(buf, n, out, len(out), ctypes.byref(out_len)))
    return out.raw[: out_len.value]


def compress_rows(buf: np.ndarray, blens: np.ndarray, idx) -> list[bytes]:
    """Headerless tag streams for the selected rows of a (B, row_w) uint8
    block matrix — ONE native call for the whole set (the routed encode
    path's batch interface: one ctypes call instead of one per block)."""
    lib = _load()
    idx64 = np.ascontiguousarray(np.asarray(idx, np.int64))
    k = len(idx64)
    if k == 0:
        return []
    lens32 = np.ascontiguousarray(np.asarray(blens, np.int32)[idx64])
    buf = np.ascontiguousarray(buf)
    stride = int(lib.snappy_tpu_max_compressed_length(int(lens32.max())))
    out = np.empty((k, stride), np.uint8)
    out_lens = np.zeros(k, np.uint32)
    _check(
        lib.snappy_tpu_compress_rows(
            buf.ctypes.data, buf.shape[1], idx64.ctypes.data, lens32.ctypes.data,
            k, out.ctypes.data, stride, out_lens.ctypes.data,
        )
    )
    return [out[j, : out_lens[j]].tobytes() for j in range(k)]


def uncompressed_length(data) -> tuple[int, int]:
    lib = _load()
    buf = _as_buffer(data)
    result = ctypes.c_uint64()
    header_len = ctypes.c_size_t()
    _check(lib.snappy_tpu_uncompressed_length(buf, len(buf), ctypes.byref(result), ctypes.byref(header_len)))
    return int(result.value), int(header_len.value)


def uncompress(data) -> bytes:
    lib = _load()
    buf = _as_buffer(data)
    ulen, _ = uncompressed_length(buf)
    out = ctypes.create_string_buffer(max(ulen, 1))
    out_len = ctypes.c_size_t()
    _check(lib.snappy_tpu_uncompress(buf, len(buf), out, ulen, ctypes.byref(out_len)))
    return out.raw[: out_len.value]


def scan_blocks(body, ulen: int) -> tuple[np.ndarray, np.ndarray] | None:
    """Segment a HEADERLESS tag stream for block-parallel decode (the
    device fast path's prepass; tag-bytes-only walk, ~50x lighter than a
    decode). Segments start at the first tag boundary at-or-after every
    64 KiB of output: block-based encoders give exact 64 KiB segments,
    non-blocking ones give [64 KiB, 128 KiB) segments. Returns
    (starts int32[n], oplens int32[n]) — input offsets and uncompressed
    lengths — or None when a copy's source reaches behind its segment
    start (a true sequential dependency; caller falls back).

    Raises CorruptInputError on streams whose scan proves them corrupt."""
    lib = _load()
    buf = _as_buffer(body)
    cap = (-(-ulen // (1 << 16)) if ulen else 0) + 1
    starts = np.zeros(cap, np.uint32)
    oplens = np.zeros(cap, np.uint32)
    rc = lib.snappy_tpu_scan_blocks(
        buf, len(buf), ulen,
        starts.ctypes.data_as(ctypes.c_void_p),
        oplens.ctypes.data_as(ctypes.c_void_p),
        cap,
    )
    if rc == -1:
        return None
    if rc < 0:
        raise CorruptInputError("corrupt snappy stream")
    # int64: input offsets of a >= 2 GiB compressed body overflow int32
    # (ulen may legally approach 2**32), and the caller does int64 bounds
    # arithmetic on these.
    return starts[:rc].astype(np.int64), oplens[:rc].astype(np.int32)
