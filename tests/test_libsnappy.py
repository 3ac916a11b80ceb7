"""Gates against the REAL google/snappy library (ctypes binding).

The reference's ground truth is a ccall into libsnappy
(reference test/libsnappy.jl:5-30). These tests hold our streams to the
genuine article: bit-exact decode both directions on the corpus, and
compressed size <= real libsnappy per file for the exact-candidate device
parse (BASELINE.md:29-30). Skipped wholesale when libsnappy is absent.
"""

import numpy as np
import pytest

from snappy_tpu.core.constants import BLOCK_SIZE
from snappy_tpu.cpu import oracle
from snappy_tpu.native import libsnappy as ls

from conftest import read_testdata

pytestmark = pytest.mark.skipif(not ls.available(), reason="libsnappy not installed")

CORPUS = [
    "alice29.txt",
    "asyoulik.txt",
    "html",
    "html_x_4",
    "kppkn.gtb",
    "lcet10.txt",
    "fireworks.jpeg",
    "geo.protodata",
    "paper-100k.pdf",
    "plrabn12.txt",
    "urls.10K",
    "sample-tweet.json",
]


def encoder(raw: bytes) -> bytes:
    try:
        from snappy_tpu.native import runtime as nat

        if nat.available():
            return nat.compress(raw)
    except Exception:
        pass
    return oracle.compress(raw)


@pytest.mark.parametrize("name", CORPUS)
def test_our_streams_decode_under_real_libsnappy(name):
    raw = read_testdata(name)
    assert ls.uncompress(encoder(raw)) == raw


@pytest.mark.parametrize("name", CORPUS)
def test_libsnappy_streams_decode_under_ours(name):
    raw = read_testdata(name)
    comp = ls.compress(raw)
    assert oracle.uncompress(np.frombuffer(comp, np.uint8)) == raw


@pytest.mark.parametrize("name", CORPUS)
def test_native_size_tracks_real_libsnappy(name):
    # The host greedy mirrors libsnappy's parse; sizes should track within
    # 1% per file (the reference concedes +-a few bytes, README.md:29).
    raw = read_testdata(name)
    ours = len(encoder(raw))
    theirs = len(ls.compress(raw))
    assert ours <= theirs * 1.01 + 16


@pytest.mark.parametrize("name", ["html", "urls.10K", "geo.protodata", "sample-tweet.json"])
def test_device_parse_beats_real_libsnappy_size(name):
    # The exact-candidate device parse (the selector's block encoder) must
    # beat the genuine article on compressible files (BASELINE.md:30).
    import jax.numpy as jnp

    from snappy_tpu.core import varint
    from snappy_tpu.ops import encode_xla, select

    raw = read_testdata(name)[:BLOCK_SIZE]
    buf = np.zeros((1, BLOCK_SIZE + encode_xla.ENC_PAD), np.uint8)
    buf[0, : len(raw)] = np.frombuffer(raw, np.uint8)
    out, olens = select.block_encoder(1)(jnp.asarray(buf), jnp.asarray([len(raw)], np.int32))
    ours = int(np.asarray(olens)[0])
    theirs = len(ls.compress(raw)) - len(varint.encode32(len(raw)))
    assert ours <= theirs, f"{name}: device {ours} > libsnappy {theirs}"
    # and the stream decodes under the real thing
    stream = varint.encode32(len(raw)) + np.asarray(out)[0, :ours].tobytes()
    assert ls.uncompress(stream) == raw
