"""The CUDA block decoder on the card, against decode_xla (``-m gpu``).

These tests need an NVIDIA GPU and skip elsewhere. Run them on the card:

    SNAPPY_TEST_GPU=1 python -m pytest -m gpu -p no:xdist tests/test_gpu_kernels.py

Every comparison is exact: ``out`` (all bytes, including those past each
block's length), ``ok`` and ``total`` must equal decode_xla's on the
corrupt battery, fuzzed and mutated streams, RLE-deep blocks, corpus
blocks, the 1<<17 merged-segment bucket and the raw fast path.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from snappy_tpu.core import varint
from snappy_tpu.core.constants import BLOCK_SIZE
from snappy_tpu.cpu import oracle
from snappy_tpu.ops import decode_cuda, decode_xla, encode_xla, select

from conftest import CORPUS_FILES, read_testdata

pytestmark = pytest.mark.gpu


def both(bodies, ulens, out_size, cmax_padded=None):
    """Decode with the CUDA kernel and decode_xla; assert identical results."""
    cmax_padded = cmax_padded or max(len(b) for b in bodies) + decode_xla.COMP_PAD
    comp = np.zeros((len(bodies), cmax_padded), np.uint8)
    for i, b in enumerate(bodies):
        comp[i, : len(b)] = np.frombuffer(bytes(b), np.uint8)
    args = (
        jnp.asarray(comp),
        jnp.asarray(np.array([len(b) for b in bodies], np.int32)),
        jnp.asarray(np.asarray(ulens, np.int32)),
    )
    got = [np.asarray(a) for a in decode_cuda.decode_blocks_jit(cmax_padded, out_size)(*args)]
    ref = [np.asarray(a) for a in decode_xla.decode_blocks_jit(cmax_padded, out_size)(*args)]
    for name, g, r in zip(("out", "ok", "total"), got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
        bad = np.flatnonzero((g != r).reshape(len(bodies), -1).any(axis=1))
        assert not len(bad), f"{name} differs from decode_xla in rows {bad[:8]}"
    return got


def test_selector_names_cuda_on_the_card(gpu_platform):
    assert select.decoder_name() == "cuda"
    assert select.block_decoder(8196, BLOCK_SIZE) is decode_cuda.decode_blocks_jit(8196, BLOCK_SIZE)


def test_corrupt_battery(gpu_platform):
    corrupt = [
        bytes([0x12, 0x00, 0x00]),  # copy offset==0
        bytes([0x61, 0x09, 0x20, 0x00]),  # copy reaches before output start
        bytes([39 << 2, 0x61, 0x62]),  # literal overruns input
        bytes([0xF8]),  # truncated long-form literal tag
        bytes([0x01]),  # truncated copy tag
        bytes([0x0C, 97, 98, 99, 100, 0x0F, 4, 0, 255, 255]),  # COPY_4 wild offset
        bytes([0x00, 97]) + bytes([0x02 | (63 << 2), 1]),  # copy tag truncated at the end
    ]
    good = oracle.compress(b"hello world " * 40)
    _, hdr = oracle.uncompressed_length(np.frombuffer(good, np.uint8))
    ulens = [64] * (len(corrupt) - 1) + [65, 480]  # the truncated copy claims its full length
    out, ok, _ = both(corrupt + [good[hdr:]], ulens, 1 << 13, 8192 + 4)
    assert not ok[: len(corrupt)].any()
    assert ok[-1] and bytes(out[-1, :480]) == b"hello world " * 40


def test_wrong_claimed_length(gpu_platform):
    comp = oracle.compress(b"A" * 1000)
    _, hdr = oracle.uncompressed_length(np.frombuffer(comp, np.uint8))
    _, ok, total = both([comp[hdr:]] * 3, [999, 1000, 1001], 1024)
    assert list(ok) == [False, True, False] and list(total) == [1000] * 3


@pytest.mark.parametrize("width_extra", [0, 1, 2, 3])
def test_fuzzed_streams(gpu_platform, width_extra):
    rng = np.random.default_rng(width_extra)
    bodies = [rng.integers(0, 256, int(rng.integers(1, 60))).astype(np.uint8).tobytes() for _ in range(256)]
    both(bodies, list(rng.integers(0, 300, len(bodies))), 256, 64 + width_extra)


def test_mutated_streams(gpu_platform):
    rng = np.random.default_rng(11)
    raw = read_testdata("html")[:3000]
    s = oracle.compress(raw)
    _, hdr = oracle.uncompressed_length(np.frombuffer(s, np.uint8))
    bodies = []
    for _ in range(256):
        b = bytearray(s[hdr:])
        for _ in range(3):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        bodies.append(bytes(b))
    both(bodies, [3000] * len(bodies), 4096)


def test_rle_deep_blocks(gpu_platform):
    raws = [b"\x00" * 8000, b"ab" * 4000, (b"x" * 100 + bytes(range(200))) * 26, b"abcdefg" * 9362]
    bodies, ulens = [], []
    for raw in raws:
        s = oracle.compress(raw)
        _, hdr = oracle.uncompressed_length(np.frombuffer(s, np.uint8))
        bodies.append(s[hdr:])
        ulens.append(len(raw))
    out, ok, _ = both(bodies, ulens, BLOCK_SIZE)
    assert ok.all()
    for i, raw in enumerate(raws):
        assert bytes(out[i, : len(raw)]) == raw


def test_full_corpus_blocks(gpu_platform):
    from snappy_tpu.native import runtime as nat

    bodies, ulens, raws = [], [], []
    for name in CORPUS_FILES:
        raw = read_testdata(name)
        for i in range(0, len(raw), BLOCK_SIZE):
            chunk = raw[i : i + BLOCK_SIZE]
            s = nat.compress(chunk)
            _, hdr = nat.uncompressed_length(s)
            bodies.append(s[hdr:])
            ulens.append(len(chunk))
            raws.append(chunk)
    cmax = -(-max(len(b) for b in bodies) // 8192) * 8192
    out, ok, _ = both(bodies, ulens, BLOCK_SIZE, cmax + decode_xla.COMP_PAD)
    assert ok.all()
    for i, raw in enumerate(raws):
        assert bytes(out[i, : len(raw)]) == raw


def test_merged_segment_1_17(gpu_platform):
    rng = np.random.default_rng(3)
    big = rng.integers(0, 256, 70_000).astype(np.uint8).tobytes()
    body = bytes([62 << 2]) + (len(big) - 1).to_bytes(3, "little") + big
    body += bytes([(63 << 2) | 3]) + (66_000).to_bytes(4, "little") + bytes([3 << 2]) + b"tail"
    expect = big + big[4000:4064] + b"tail"
    out, ok, _ = both([body], [len(expect)], 1 << 17, -(-(len(body) + 4) // 512) * 512)
    assert ok.all() and bytes(out[0, : len(expect)]) == expect


def test_raw_fast_path_foreign_fixture(gpu_platform):
    """alice29.snappy (a non-blocking foreign encoder) through the raw fast
    path: native segmentation + the CUDA block decoder."""
    from snappy_tpu.ops import host as xh

    comp = np.frombuffer(read_testdata("alice29.snappy"), np.uint8)
    ulen, start = varint.parse32(comp, 0)
    out = xh._uncompress_blocked(comp, ulen, start)
    assert out is not None, "fast path declined a segmentable stream"
    assert out == read_testdata("alice29.txt")


def test_encode_xla_batch_invariant(gpu_platform):
    """encode_xla's output for a block must not depend on the batch it is
    encoded in (XLA:GPU once miscompiled a reversed cummax at 32+ blocks)."""
    from bench import corpus_stream

    nb = 64
    raw = corpus_stream(nb * BLOCK_SIZE)
    buf = np.zeros((nb, BLOCK_SIZE + encode_xla.ENC_PAD), np.uint8)
    buf[:, :BLOCK_SIZE] = np.frombuffer(raw, np.uint8).reshape(nb, BLOCK_SIZE)
    lens = np.full(nb, BLOCK_SIZE, np.int32)
    out, olens = (np.asarray(a) for a in encode_xla.encode_blocks_jit(nb)(buf, lens))
    small = encode_xla.encode_blocks_jit(4)
    for s in range(0, nb, 4):
        o4, l4 = (np.asarray(a) for a in small(buf[s : s + 4], lens[s : s + 4]))
        assert (l4 == olens[s : s + 4]).all() and (o4 == out[s : s + 4]).all(), f"blocks {s}..{s + 3}"
    from snappy_tpu.native import runtime as nat

    for i in range(nb):
        stream = varint.encode32(BLOCK_SIZE) + out[i, : olens[i]].tobytes()
        assert nat.uncompress(stream) == raw[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE]
