"""XLA parallel decoder tests: differential vs oracle + corruption battery.

The decoder must accept any conformant stream (including foreign ones) and
reject exactly what the reference rejects — but via a branch-free ok flag
instead of exceptions mid-loop.
"""

import numpy as np
import pytest

from snappy_tpu.core import varint
from snappy_tpu.core.errors import CorruptInputError
from snappy_tpu.cpu import oracle
from snappy_tpu.ops import decode_xla, host as xh

from conftest import CORPUS_FILES, read_testdata


def encoder(raw):
    # Streams to decode come from the fast native encoder when available
    # (byte-identical to the oracle; proven in test_native).
    try:
        from snappy_tpu.native import runtime as nat

        if nat.available():
            return nat.compress(raw)
    except Exception:
        pass
    return oracle.compress(raw)


@pytest.mark.parametrize("name", CORPUS_FILES)
def test_corpus_decode_bit_exact(name):
    raw = read_testdata(name)
    assert xh.uncompress(encoder(raw)) == raw


def test_foreign_stream_bit_exact():
    assert xh.uncompress(read_testdata("alice29.snappy")) == read_testdata("alice29.txt")


@pytest.mark.parametrize(
    "raw",
    [
        b"",
        b"a",
        b"ab",
        b"abc",
        b"hello hello hello hello world world",
        b"x" * 1000,
        b"ab" * 5000,
        b"aaaaaaa" + b"b" * 2047 + b"aaaaa" + b"abc",
        b"aaaaaaa" + b"b" * 65536 + b"aaaaa" + b"abc",  # crosses block boundary
    ],
    ids=[str(i) for i in range(9)],
)
def test_simple_decode(raw):
    assert xh.uncompress(encoder(raw)) == raw


def test_rle_deep_chains():
    # offset-1 RLE: the source chain is maximally deep; pointer doubling
    # must resolve it fully.
    for n in [1, 2, 63, 64, 65, 4095, 70000]:
        raw = b"q" * n
        assert xh.uncompress(encoder(raw)) == raw


def test_copy4_decode():
    # The encoder never emits COPY_4, but the decoder must accept it
    # (reference src/internal.jl:24-31). Hand-build: 4 literals + copy4.
    stream = bytes(
        [8, 0x0C, 97, 98, 99, 100]  # header=8; literal len4 'abcd'
        + [0x0F, 4, 0, 0, 0]  # copy4: len 4, offset 4 (LE32)
    )
    assert xh.uncompress(stream) == b"abcdabcd"


@pytest.mark.parametrize(
    "raw",
    [
        bytes([0x40, 0x12, 0x00, 0x00]),  # offset==0 copy
        bytes([0x05, 0x12, 0x00, 0x00]),
        bytes([0x10, 0x00, 0x61, 0x09, 0x20, 0x00]),  # copy reaches before start
        bytes([0x30, 39 << 2, 0x61, 0x62]),  # literal overruns input
        bytes([0x10, 0xF8]),  # truncated 4-byte-length literal tag
    ],
)
def test_corrupt_streams_raise(raw):
    with pytest.raises(CorruptInputError):
        xh.uncompress(raw)


@pytest.mark.parametrize("name", ["baddata1.snappy", "baddata2.snappy", "baddata3.snappy"])
def test_baddata_raises(name):
    with pytest.raises(CorruptInputError):
        xh.uncompress(read_testdata(name))


def test_header_lies():
    comp = bytearray(encoder(b"A" * 100000))
    comp[0] = comp[1] = comp[2] = comp[3] = 0
    with pytest.raises(CorruptInputError):
        xh.uncompress(bytes(comp))
    comp[0] = comp[1] = comp[2] = 0xFF
    comp[3] = 0x00
    with pytest.raises(CorruptInputError):
        xh.uncompress(bytes(comp))


def test_corrupt_varint_raises():
    for raw in [bytes([0xF0]), bytes([0x80] * 5 + [0x0A]), bytes([0xFB, 0xFF, 0xFF, 0xFF, 0x7F])]:
        with pytest.raises(CorruptInputError):
            xh.uncompress(raw)


def test_block_batched_decode():
    import jax.numpy as jnp

    from snappy_tpu.ops import decode_xla

    # Build 4 independent headerless block streams from the oracle by
    # compressing block-sized inputs and stripping the varint header.
    blocks_raw = [b"hello world " * 100, b"z" * 5000, bytes(range(256)) * 8, b"ab" * 700]
    streams = []
    for raw in blocks_raw:
        comp = encoder(raw)
        _, start = oracle.uncompressed_length(comp)
        streams.append(np.frombuffer(comp, np.uint8)[start:])
    cmax = max(len(s) for s in streams)
    buf = np.zeros((4, cmax + decode_xla.COMP_PAD), np.uint8)
    for i, s in enumerate(streams):
        buf[i, : len(s)] = s
    clens = np.array([len(s) for s in streams], np.int32)
    ulens = np.array([len(r) for r in blocks_raw], np.int32)
    out, ok, total = decode_xla.decode_blocks_jit(buf.shape[1], 8192)(
        jnp.asarray(buf), jnp.asarray(clens), jnp.asarray(ulens)
    )
    assert bool(ok.all())
    for i, raw in enumerate(blocks_raw):
        assert bytes(np.asarray(out[i, : len(raw)])) == raw


class TestWindowedRawFallback:
    """decode_raw_windowed: bounded-memory sequential decode of large raw
    streams (the no-native-lib fallback)."""

    @pytest.fixture(autouse=True)
    def small_windows(self, monkeypatch):
        # force many windows on small fixtures
        monkeypatch.setattr(decode_xla, "WINDOW_C", 1 << 14)
        monkeypatch.setattr(decode_xla, "WINDOW_U", (1 << 14) + (1 << 17))
        decode_xla._window_pass_jit.cache_clear()
        yield
        decode_xla._window_pass_jit.cache_clear()

    def _decode(self, stream: bytes) -> bytes:
        comp = np.frombuffer(stream, np.uint8)
        ulen, hdr = varint.parse32(comp, 0)
        return decode_xla.decode_raw_windowed(comp, ulen, hdr)

    def test_native_stream_bit_exact(self):
        raw = read_testdata("alice29.txt")
        nat = pytest.importorskip("snappy_tpu.native.runtime")
        s = nat.compress(raw) if nat.available() else oracle.compress(raw)
        assert self._decode(s) == raw

    def test_foreign_fixture_bit_exact(self):
        assert self._decode(read_testdata("alice29.snappy")) == read_testdata("alice29.txt")

    def test_giant_literal_streams_host_side(self):
        big = np.random.RandomState(5).randint(0, 256, 100_000).astype(np.uint8).tobytes()
        body = bytes([62 << 2]) + (len(big) - 1).to_bytes(3, "little") + big
        assert self._decode(varint.encode32(len(big)) + body) == big

    def test_cross_window_copy(self):
        big = np.random.RandomState(5).randint(0, 256, 100_000).astype(np.uint8).tobytes()
        body = bytes([62 << 2]) + (len(big) - 1).to_bytes(3, "little") + big
        body += bytes([(63 << 2) | 3]) + (90_000).to_bytes(4, "little")
        exp = big + big[10_000:10_064]
        assert self._decode(varint.encode32(len(exp)) + body) == exp

    def test_rle_chain_across_windows(self):
        raw = b"a" * 200_000 + bytes(range(256)) * 64
        s = oracle.compress(raw)
        assert self._decode(s) == raw

    def test_corrupt_raises(self):
        raw = read_testdata("html")
        s = oracle.compress(raw)
        comp = np.frombuffer(s, np.uint8)
        ulen, hdr = varint.parse32(comp, 0)
        with pytest.raises(CorruptInputError):
            decode_xla.decode_raw_windowed(comp[: len(comp) // 2], ulen, hdr)


@pytest.mark.slow
def test_windowed_64mb_stream_bounded_memory():
    """64 MB raw stream decodes CPU-only through the public path within
    bounded memory (production windows; the whole-stream program would
    build multi-GB orbit intermediates)."""
    from bench import corpus_stream
    from snappy_tpu.native import runtime as nat
    from snappy_tpu.ops import host as xh

    raw = corpus_stream(64 << 20)
    s = nat.compress(raw) if nat.available() else oracle.compress(raw)
    comp = np.frombuffer(s, np.uint8)
    ulen, hdr = varint.parse32(comp, 0)
    assert decode_xla.decode_raw_windowed(comp, ulen, hdr) == raw
