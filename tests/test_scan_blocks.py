"""Segmentation prepass for raw streams (native scan_blocks): the device
fast path's host half. Reference decode semantics: src/internal.jl:411-466;
block independence: src/Snappy.jl:29-33."""

import numpy as np
import pytest

from snappy_tpu.core import varint
from snappy_tpu.core.errors import CorruptInputError
from snappy_tpu.cpu import oracle

from conftest import read_testdata

nat = pytest.importorskip("snappy_tpu.native.runtime")
if not nat.available():
    pytest.skip("native library unavailable", allow_module_level=True)


def split_decode(stream: bytes) -> bytes:
    """Decode via scan_blocks segmentation + per-segment oracle decode —
    exactly the structure of the raw fast path, minus the device."""
    ulen, hdr = nat.uncompressed_length(stream)
    body = stream[hdr:]
    scan = nat.scan_blocks(body, ulen)
    assert scan is not None
    starts, oplens = scan
    assert int(oplens.sum()) == ulen
    bounds = list(starts) + [len(body)]
    out = b""
    for i in range(len(starts)):
        out += oracle.uncompress(
            varint.encode32(int(oplens[i])) + body[bounds[i] : bounds[i + 1]]
        )
    return out


@pytest.mark.parametrize("name", ["alice29.txt", "html_x_4", "urls.10K"])
def test_scan_splits_native_streams_bit_exact(name):
    raw = read_testdata(name)
    s = nat.compress(raw)
    assert split_decode(s) == raw


def test_scan_splits_foreign_fixture():
    # alice29.snappy: produced by a foreign snappy implementation.
    s = read_testdata("alice29.snappy")
    assert split_decode(s) == read_testdata("alice29.txt")


def test_scan_block_count_and_offsets_monotonic():
    raw = (read_testdata("alice29.txt") * 3)[: 5 * (1 << 16) + 1234]
    s = nat.compress(raw)
    ulen, hdr = nat.uncompressed_length(s)
    starts, oplens = nat.scan_blocks(s[hdr:], ulen)
    # block-based encoder -> exact 64 KiB segments
    assert len(starts) == 6 and starts[0] == 0
    assert (np.diff(starts) > 0).all()
    assert (oplens[:-1] == 1 << 16).all() and int(oplens[-1]) == 1234


def test_boundary_crossing_literal_makes_long_segment():
    # A VALID stream whose literal spans a 64 KiB output boundary (a
    # non-blocking encoder's stream): the segmenter extends the segment to
    # the next tag boundary instead of declining. The literal stays within
    # the kernel's 65536-byte length field; longer ones must DECLINE (see
    # test_long_literal_declines_not_corrupt).
    big = bytes(range(256)) * 512  # 128 KiB
    cuts = [2000, 67000]  # literal 2 spans op 2000..67000, crossing 65536
    bounds = [0] + cuts + [len(big)]
    body = b""
    for a, b in zip(bounds, bounds[1:]):
        body += bytes([62 << 2]) + (b - a - 1).to_bytes(3, "little") + big[a:b]
    stream = varint.encode32(len(big)) + body
    assert oracle.uncompress(stream) == big
    starts, oplens = nat.scan_blocks(body, len(big))
    assert list(oplens) == [67000, len(big) - 67000]
    assert split_decode(stream) == big


def test_block_crossing_copy_merges_segments():
    # Copy whose source reaches behind its segment start: the scan MERGES
    # the segment into its predecessor (the decoders' 128 KiB output
    # window covers it) instead of declining.
    blk = bytes([1]) * (1 << 16)
    body = bytes([62 << 2]) + ((1 << 16) - 1).to_bytes(3, "little") + blk
    # 4-byte copy at offset 100 — source is inside block 0, dst in block 1
    body += bytes([0x01 | (0 << 2)]) + bytes([100])  # COPY_1 len=4 off=100
    lit2 = bytes([3 << 2]) + b"abcd"
    body += lit2
    ulen = (1 << 16) + 8
    stream = varint.encode32(ulen) + body
    out_ref = blk + blk[-100 : -100 + 4] + b"abcd"
    assert oracle.uncompress(stream) == out_ref
    starts, oplens = nat.scan_blocks(body, ulen)
    # merged segment covering the cross-boundary copy, then the tail
    assert list(oplens) == [(1 << 16) + 4, 4]
    assert split_decode(stream) == out_ref


def test_corrupt_scan_raises():
    raw = read_testdata("html")
    s = nat.compress(raw)
    ulen, hdr = nat.uncompressed_length(s)
    with pytest.raises(CorruptInputError):
        nat.scan_blocks(s[hdr : hdr + (len(s) - hdr) // 2], ulen)


def _long_literal_stream(n: int, seed: int = 7) -> tuple[bytes, bytes]:
    """Raw stream whose single literal is n bytes (n-1 needs a 3-byte
    trailer) — valid snappy (the format allows 4 GiB literals,
    reference src/internal.jl:435-463) that no blocking encoder emits."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, n).astype(np.uint8).tobytes()
    body = bytes([62 << 2]) + (n - 1).to_bytes(3, "little") + big
    return varint.encode32(n) + body, big


def test_long_literal_segments_up_to_128k_declines_past():
    """Literals that fit the decoders' 128 KiB output window SEGMENT and
    ride the fast path; longer ones decline — and never report corrupt
    (such streams once raised CorruptInputError)."""
    for n, fast in ((70_000, True), (120_000, True), (200_000, False)):
        stream, big = _long_literal_stream(n)
        ulen, hdr = nat.uncompressed_length(stream)
        scan = nat.scan_blocks(stream[hdr:], ulen)
        assert (scan is not None) == fast, n
        if fast:
            assert list(scan[1]) == [n]
            assert split_decode(stream) == big
        assert oracle.uncompress(stream) == big


def test_long_literal_uncompress_bit_exact():
    """The same streams decode bit-exact through the public host decode
    (fast path declines -> sequential XLA fallback)."""
    from snappy_tpu.ops import host as xh

    for n in (70_000, 200_000):
        stream, big = _long_literal_stream(n)
        assert xh.uncompress(stream) == big


def test_wide_offset_copy4_merges_and_decodes():
    """COPY_4 with offset > 65535: valid for foreign encoders; the scan
    merges it into its source's segment and the public host decode stays
    bit-exact."""
    from snappy_tpu.ops import host as xh

    stream, big = _long_literal_stream(70_000)
    ulen, hdr = nat.uncompressed_length(stream)
    body = stream[hdr:]
    # COPY_4 len=64 offset=69000 (reaches back past 65535)
    body += bytes([(63 << 2) | 3]) + (69_000).to_bytes(4, "little")
    out_ref = big + big[70_000 - 69_000 : 70_000 - 69_000 + 64]
    stream2 = varint.encode32(len(out_ref)) + body
    assert oracle.uncompress(stream2) == out_ref
    scan = nat.scan_blocks(body, len(out_ref))
    assert scan is not None and list(scan[1]) == [len(out_ref)]
    assert split_decode(stream2) == out_ref
    assert xh.uncompress(stream2) == out_ref


def test_scan_starts_int64():
    raw = read_testdata("html")
    s = nat.compress(raw)
    ulen, hdr = nat.uncompressed_length(s)
    starts, _ = nat.scan_blocks(s[hdr:], ulen)
    assert starts.dtype == np.int64
