"""Host drivers for the framed codec path (single-device and mesh-sharded).

Splits streams into independent 64 KiB blocks, dispatches the batched XLA
kernels (optionally shard_map'd over a device mesh), and assembles/parses
frames. This is the production path for large streams; the raw-format API
(snappy_tpu.compress/uncompress) stays wire-compatible with libsnappy.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..core.config import DEFAULT_FRAME_CONFIG, FrameConfig
from ..core.errors import CorruptInputError
from ..utils.profiling import trace_annotation
from ..ops import decode_xla, encode_xla
from ..ops.select import block_decoder, block_encoder  # noqa: F401  (re-export)
from . import distributed, framed


def _bucket(n: int, floor: int = 1) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def _bucket_cmax(n: int) -> int:
    """Compressed-width bucket: 8 KiB granularity instead of power-of-two.
    A power-of-two bucket would send ~65.5 KiB incompressible blocks to
    131072 and double the decoder's input width; 8 KiB steps keep the
    compile-shape count small (<=10) without the 2x blowup."""
    return max(8192, -(-n // 8192) * 8192)


def pack_rows(body: np.ndarray, starts, clens, out: np.ndarray) -> None:
    """Copy the tag stream body[starts[i] : starts[i] + clens[i]] into row i
    of ``out``. One slice copy per block: a single fancy-indexed scatter
    would build two index arrays as long as the body, which is far slower
    at stream sizes (1,024 blocks of a 64 MiB stream)."""
    for i, (s, n) in enumerate(zip(np.asarray(starts).tolist(), np.asarray(clens).tolist())):
        out[i, :n] = body[s : s + n]


def _blockify(inp: np.ndarray, block_size: int, nb_padded: int) -> tuple[np.ndarray, np.ndarray]:
    buf = np.zeros((nb_padded, block_size + encode_xla.ENC_PAD), np.uint8)
    blens = np.zeros(nb_padded, np.int32)
    n = len(inp)
    n_blocks = -(-n // block_size) if n else 0
    for i in range(n_blocks):
        chunk = inp[i * block_size : (i + 1) * block_size]
        buf[i, : len(chunk)] = chunk
        blens[i] = len(chunk)
    return buf, blens


def dispatch_compress(data, config: FrameConfig = DEFAULT_FRAME_CONFIG, mesh=None):
    """Async half of compress_framed: returns an opaque ticket whose device
    work is in flight (JAX dispatch is async). Pass to assemble_compress to
    fence and build the frame — the split lets the streaming pipeline keep
    the device busy on chunk k+1 while the host assembles frame k."""
    inp = np.frombuffer(memoryview(data if not isinstance(data, str) else data.encode()), np.uint8) if not isinstance(data, np.ndarray) else data
    n = len(inp)
    bs = config.block_size
    n_blocks = -(-n // bs) if n else 0
    if n_blocks == 0:
        return ("batch", None, inp, 0, config)
    nb = _bucket(n_blocks)
    if mesh is not None:
        nb = distributed.pad_block_count(nb, mesh.devices.size)
    buf, blens = _blockify(inp, bs, nb)
    with trace_annotation("framed.dispatch_compress"):
        if mesh is not None:
            out, olens = distributed.compress_blocks(buf, blens, mesh)
            return ("batch", (out, olens), inp, n_blocks, config)
        # single-host: content-routed — incompressible blocks take the
        # host-native skip-heuristic path while the device dispatch is in
        # flight (ops/route.py; mirrors reference src/internal.jl:162-172)
        from ..ops import route

        rt = route.dispatch_routed(buf, blens, n_blocks, block_encoder)
    return ("routed", rt, inp, n_blocks, config)


def assemble_compress(ticket) -> bytes:
    """Fence the device results of dispatch_compress and build the frame."""
    kind, payload, inp, n_blocks, config = ticket
    if n_blocks == 0:
        return framed.build_frame([], [], 0, config)
    n = len(inp)
    bs = config.block_size
    if kind == "routed":
        from ..ops import route

        streams = route.assemble_routed(payload)
    else:
        out, olens = payload
        out = np.asarray(out)
        olens = np.asarray(olens)
        streams = [out[i, : olens[i]].tobytes() for i in range(n_blocks)]
    raws = [inp[i * bs : min((i + 1) * bs, n)].tobytes() for i in range(n_blocks)] if config.checksum else None
    return framed.build_frame(streams, raws, n, config)


def compress_framed(data, config: FrameConfig = DEFAULT_FRAME_CONFIG, mesh=None) -> bytes:
    """Compress into the framed container (parallel-decodable, checksummed)."""
    return assemble_compress(dispatch_compress(data, config, mesh))


def dispatch_uncompress(frame: bytes, mesh=None):
    """Async half of uncompress_framed (see dispatch_compress)."""
    idx = framed.parse_index(frame)
    if idx.n_blocks == 0:
        return (idx, None, None)
    ranges = idx.block_ranges()
    cmax = _bucket_cmax(max(int(e - s) for s, e in ranges))
    nb = _bucket(idx.n_blocks)
    if mesh is not None:
        nb = distributed.pad_block_count(nb, mesh.devices.size)
    comp = np.zeros((nb, cmax + decode_xla.COMP_PAD), np.uint8)
    clens = np.zeros(nb, np.int32)
    ulens = np.zeros(nb, np.int32)
    fbuf = np.frombuffer(frame, np.uint8)
    n = idx.n_blocks
    starts = np.array([s for s, _ in ranges], np.int64)
    clens[:n] = np.array([e - s for s, e in ranges], np.int64)
    pack_rows(fbuf, starts, clens[:n], comp)
    ulens[:n] = idx.block_size
    ulens[n - 1] = idx.block_ulen(n - 1)
    out_size = _bucket(int(idx.block_size), 64)
    with trace_annotation("framed.dispatch_uncompress"):
        if mesh is not None:
            out, ok, total = distributed.decompress_blocks(comp, clens, ulens, mesh, out_size)
        else:
            out, ok, total = block_decoder(cmax + decode_xla.COMP_PAD, out_size)(
                jnp.asarray(comp), jnp.asarray(clens), jnp.asarray(ulens)
            )
    return (idx, out, ok)


def assemble_uncompress(ticket) -> bytes:
    """Fence, validate, and join the blocks of dispatch_uncompress."""
    idx, out, ok = ticket
    if idx.n_blocks == 0:
        return b""
    ok = np.asarray(ok)
    if not bool(ok[: idx.n_blocks].all()):
        bad = int(np.flatnonzero(~ok[: idx.n_blocks])[0])
        raise CorruptInputError(f"corrupt framed block {bad}")
    out = np.asarray(out)
    bs = int(idx.block_size)
    # One contiguous slice+reshape instead of a per-block join loop; crc
    # verification runs over zero-copy views into the same buffer.
    body = out[: idx.n_blocks, :bs].reshape(-1)[: idx.total_len]
    framed.verify_crcs(
        idx, [body[i * bs : i * bs + idx.block_ulen(i)] for i in range(idx.n_blocks)]
    )
    return body.tobytes()


def uncompress_framed(frame: bytes, mesh=None) -> bytes:
    """Decode a framed stream block-parallel (optionally mesh-sharded)."""
    return assemble_uncompress(dispatch_uncompress(frame, mesh))
