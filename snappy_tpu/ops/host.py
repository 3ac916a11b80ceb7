"""Host-facing wrappers around the device codec kernels.

Handles what must stay on host: varint header parsing (it determines the
output allocation), padding to jit-cached shape buckets, device transfer,
and raising typed errors from the device's ``ok`` flag. Mirrors the
structure of the reference API layer (reference src/Snappy.jl:20-52) with
the scalar core swapped for device kernels.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..core import varint
from ..core.errors import CorruptInputError, InputTooLargeError
from ..utils.profiling import trace_annotation
from . import decode_xla


def _as_np(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise TypeError(f"expected uint8 array, got {data.dtype}")
        return data
    if isinstance(data, str):
        data = data.encode("utf-8")
    return np.frombuffer(memoryview(data), dtype=np.uint8)


def _bucket(n: int, floor: int = 256) -> int:
    """Round up to a power of two so jit caches stay small."""
    b = floor
    while b < n:
        b <<= 1
    return b


def uncompress(data) -> bytes:
    """Decode a raw Snappy stream on device.

    Fast path: a native tag-walk segments the stream at its 64 KiB
    output-block boundaries (every real snappy encoder emits block-local
    streams — reference src/Snappy.jl:29-33), then the selected batched
    block decoder (ops/select.py) runs all blocks in one dispatch. Streams
    that defeat segmentation (no native lib, or exotic boundary-crossing
    tags) fall back to the sequential-capable XLA array decoder.
    """
    comp = _as_np(data)
    ulen, start = varint.parse32(comp, 0)  # raises CorruptInputError
    out = _uncompress_blocked(comp, ulen, start)
    if out is not None:
        return out
    if len(comp) > decode_xla.RAW_WHOLE_LIMIT:
        # Large raw stream without a usable segmentation: the whole-stream
        # XLA program would build O(stream) orbit intermediates; decode in
        # bounded windows with carried output instead.
        with trace_annotation("snappy.uncompress_windowed"):
            return decode_xla.decode_raw_windowed(comp, ulen, start)
    nc = _bucket(len(comp))
    nu = _bucket(max(ulen, 1))
    padded = np.zeros(nc + decode_xla.COMP_PAD, dtype=np.uint8)
    padded[: len(comp)] = comp
    fn = decode_xla.decode_padded_jit(nc + decode_xla.COMP_PAD, nu)
    with trace_annotation("snappy.uncompress"):
        out, ok, _ = fn(jnp.asarray(padded), len(comp), ulen, start)
        ok = bool(ok)
    if not ok:
        raise CorruptInputError("corrupt snappy stream")
    return np.asarray(out[:ulen]).tobytes()


def _uncompress_blocked(comp: np.ndarray, ulen: int, start: int, block_decoder=None) -> bytes | None:
    """The device fast path: segment + batched block decode. Returns None
    when it declines: no native library to segment with (scan_blocks), a
    stream that is not block-local, or a block outside the decoder's
    envelope. ``block_decoder(cmax_padded, out_size)`` defaults to the
    selector's choice (ops/select.py)."""
    from . import select

    block_decoder = block_decoder or select.block_decoder
    if ulen == 0:
        return None
    from ..native import runtime as nat

    if not nat.available():
        return None
    scan = nat.scan_blocks(comp[start:], ulen)  # raises on corrupt
    if scan is None:
        return None
    starts, oplens = scan

    body = comp[start:]
    n_blocks = len(starts)
    bounds = np.concatenate([starts, [len(body)]]).astype(np.int64)
    clens = (bounds[1:] - bounds[:-1]).astype(np.int32)
    from ..parallel.host import _bucket_cmax, pack_rows

    cmax = _bucket_cmax(int(clens.max()))
    # scan_blocks caps a segment's output below 128 KiB: both decoders take
    # out_size 1 << 17.
    out_size = 1 << 16 if int(oplens.max()) <= 1 << 16 else 1 << 17
    nb = _bucket(n_blocks, 1)
    blocks = np.zeros((nb, cmax + decode_xla.COMP_PAD), np.uint8)
    pack_rows(body, bounds[:-1], clens, blocks)
    ulens = np.zeros(nb, np.int32)
    ulens[:n_blocks] = oplens
    clens_p = np.zeros(nb, np.int32)
    clens_p[:n_blocks] = clens
    dec = block_decoder(cmax + decode_xla.COMP_PAD, out_size)
    with trace_annotation("snappy.uncompress_blocked"):
        out, ok, _ = dec(jnp.asarray(blocks), jnp.asarray(clens_p), jnp.asarray(ulens))
        ok_np = np.asarray(ok)
    if not bool(ok_np[:n_blocks].all()):
        # The scan already validated stream structure, so a kernel nak here
        # means a stream outside the kernel's representable envelope (not
        # proof of corruption): fall back to the sequential-capable XLA
        # decoder, which raises if the stream is genuinely corrupt.
        return None
    out_np = np.asarray(out[:n_blocks])
    if (oplens == out_size).all():
        return out_np.tobytes()
    # Ragged gather: one boolean-mask extraction (row-major order = block
    # concatenation) instead of a per-block join loop.
    keep = np.arange(out_size, dtype=np.int32)[None, :] < np.asarray(oplens)[:, None]
    return out_np[keep].tobytes()


def compress(data) -> bytes:
    """Compress to a raw Snappy stream with the parallel XLA encoder."""
    from . import encode_xla  # deferred: heavier trace

    inp = _as_np(data)
    if len(inp) > 0xFFFFFFFF:
        raise InputTooLargeError("input exceeds 2**32-1 bytes")
    with trace_annotation("snappy.compress"):
        return encode_xla.compress_host(inp)
