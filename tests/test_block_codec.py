"""Block codec batteries through the kernel selector (ops/select.py).

On the CPU test platform the selector returns decode_xla and encode_xla;
the same batteries run against the CUDA decoder on the card in
tests/test_gpu_kernels.py. Also covers the selector itself, the CUDA
wrapper's shape logic (traced, never run here), the raw-stream fast path
and the compile-cache helper.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from snappy_tpu.core import varint
from snappy_tpu.core.constants import BLOCK_SIZE
from snappy_tpu.cpu import oracle
from snappy_tpu.ops import decode_cuda, decode_xla, encode_xla, select

from conftest import read_testdata


def encoder(raw: bytes) -> bytes:
    from snappy_tpu.native import runtime as nat

    return nat.compress(raw) if nat.available() else oracle.compress(raw)


def block_streams(raw: bytes):
    """Per-64KiB-block headerless tag streams + uncompressed lengths."""
    streams, ulens = [], []
    for i in range(0, max(len(raw), 1), BLOCK_SIZE):
        chunk = raw[i : i + BLOCK_SIZE]
        comp = encoder(chunk)
        _, start = oracle.uncompressed_length(np.frombuffer(comp, np.uint8))
        streams.append(np.frombuffer(comp, np.uint8)[start:])
        ulens.append(len(chunk))
    return streams, ulens


def run_decode(streams, ulens, out_size=BLOCK_SIZE):
    cmax = max(len(s) for s in streams) + decode_xla.COMP_PAD
    buf = np.zeros((len(streams), cmax), np.uint8)
    for i, s in enumerate(streams):
        buf[i, : len(s)] = np.frombuffer(bytes(s), np.uint8)
    clens = np.array([len(s) for s in streams], np.int32)
    fn = select.block_decoder(cmax, out_size)
    out, ok, total = fn(jnp.asarray(buf), jnp.asarray(clens), jnp.asarray(np.array(ulens, np.int32)))
    return np.asarray(out), np.asarray(ok), np.asarray(total)


# ---------------------------------------------------------------- decoder


@pytest.mark.parametrize("name", ["html", "fireworks.jpeg", "paper-100k.pdf", "urls.10K"])
def test_corpus_blocks_bit_exact(name):
    raw = read_testdata(name)[: 4 * BLOCK_SIZE]
    streams, ulens = block_streams(raw)
    out, ok, total = run_decode(streams, ulens)
    assert ok.all(), f"decode flagged corrupt on {name}"
    assert (total == np.array(ulens)).all()
    got = b"".join(bytes(out[i, : ulens[i]]) for i in range(len(streams)))
    assert got == raw


@pytest.mark.parametrize(
    "raw",
    [
        b"",
        b"a",
        b"hello hello hello hello world world",
        b"x" * 1000,
        b"ab" * 5000,
        b"q" * 65536,  # full-block offset-1 RLE
        bytes(range(256)) * 16,
        b"abcdefg" * 9363,  # period-7 RLE
    ],
    ids=[str(i) for i in range(8)],
)
def test_simple_blocks(raw):
    streams, ulens = block_streams(raw)
    out, ok, total = run_decode(streams, ulens)
    assert ok.all()
    got = b"".join(bytes(out[i, : ulens[i]]) for i in range(len(streams)))
    assert got == raw


def test_copy4_and_long_offsets():
    # COPY_4 decode support (reference src/internal.jl:24-31): 4 literals
    # then a COPY_4 of len 4 offset 4. Headerless stream.
    stream = np.frombuffer(bytes([0x0C, 97, 98, 99, 100, 0x0F, 4, 0, 0, 0]), np.uint8)
    out, ok, total = run_decode([stream], [8], out_size=128)
    assert ok.all() and bytes(out[0, :8]) == b"abcdabcd"


CORRUPT_BODIES = [
    bytes([0x12, 0x00, 0x00]),  # copy offset==0
    bytes([0x61, 0x09, 0x20, 0x00]),  # copy reaches before output start
    bytes([39 << 2, 0x61, 0x62]),  # literal overruns input
    bytes([0xF8]),  # truncated long-form literal tag
    bytes([0x01]),  # truncated copy tag (missing offset byte)
]


@pytest.mark.parametrize("body", CORRUPT_BODIES)
def test_corrupt_blocks_flagged(body):
    stream = np.frombuffer(body, np.uint8)
    out, ok, total = run_decode([stream], [64], out_size=128)
    assert not ok.any()


def test_wrong_claimed_length_flagged():
    comp = encoder(b"A" * 1000)
    _, start = oracle.uncompressed_length(np.frombuffer(comp, np.uint8))
    stream = np.frombuffer(comp, np.uint8)[start:]
    out, ok, total = run_decode([stream], [999], out_size=1024)
    assert not ok.any()
    out, ok, total = run_decode([stream], [1024], out_size=1024)
    assert not ok.any() and int(total[0]) == 1000


def test_batched_mixed_blocks():
    blocks = [b"hello world " * 100, b"z" * 5000, bytes(range(256)) * 8, b"ab" * 700]
    streams, ulens = [], []
    for raw in blocks:
        s, u = block_streams(raw)
        streams += s
        ulens += u
    out, ok, total = run_decode(streams, ulens, out_size=8192)
    assert ok.all()
    for i, raw in enumerate(blocks):
        assert bytes(out[i, : len(raw)]) == raw


class TestChainFold:
    """Chains of same-offset copies (the chunks emit_copy splits long
    matches into, reference src/internal.jl:316-326), RLE and mixed-offset
    chains: every shape must decode to the sequential semantics."""

    @staticmethod
    def _copy2(length, off):
        return bytes([0x02 | ((length - 1) << 2), off & 0xFF, off >> 8])

    @staticmethod
    def _copy1(length, off):
        assert 4 <= length <= 11 and off < 2048
        return bytes([0x01 | ((length - 4) << 2) | ((off >> 8) << 5), off & 0xFF])

    @staticmethod
    def _lit(data):
        n = len(data)
        assert n <= 60
        return bytes([(n - 1) << 2]) + data

    def _check(self, body: bytes, expect: bytes):
        out, ok, total = run_decode([np.frombuffer(body, np.uint8)], [len(expect)], out_size=BLOCK_SIZE)
        assert ok.all() and int(total[0]) == len(expect)
        assert bytes(out[0, : len(expect)]) == expect

    def test_emit_style_chain_64_64_60_rem(self):
        base = bytes(range(37)) * 2  # 74-byte seed
        body = self._lit(base[:60]) + self._lit(base[60:])
        body += self._copy2(64, 74) + self._copy2(64, 74) + self._copy2(60, 74) + self._copy2(14, 74)
        exp = bytearray(base)
        for _ in range(202):
            exp.append(exp[-74])
        self._check(body, bytes(exp))

    def test_chain_with_copy1_tail(self):
        base = b"abcdefghij" * 2
        body = self._lit(base) + self._copy2(64, 20) + self._copy1(8, 20)
        exp = bytearray(base)
        for _ in range(72):
            exp.append(exp[-20])
        self._check(body, bytes(exp))

    def test_different_offset_chain_does_not_merge_wrong(self):
        base = bytes(range(60))
        body = self._lit(base) + self._copy2(64, 30) + self._copy2(64, 29)
        exp = bytearray(base)
        for _ in range(64):
            exp.append(exp[-30])
        for _ in range(64):
            exp.append(exp[-29])
        self._check(body, bytes(exp))

    def test_rle_folded_chain(self):
        body = self._lit(b"x") + self._copy2(64, 1) + self._copy2(64, 1) + self._copy2(64, 1) + self._copy2(33, 1)
        self._check(body, b"x" * (1 + 64 * 3 + 33))

    def test_odd_chain_lengths(self):
        for k in (1, 2, 3, 5, 8):
            base = bytes((i * 7) & 0xFF for i in range(70))
            body = self._lit(base[:60]) + self._lit(base[60:])
            body += b"".join(self._copy2(64, 70) for _ in range(k)) + self._copy2(7, 70)
            exp = bytearray(base)
            for _ in range(64 * k + 7):
                exp.append(exp[-70])
            self._check(body, bytes(exp))

    def test_corrupt_mid_chain_truncation_flagged(self):
        base = bytes(range(60))
        body = self._lit(base) + self._copy2(64, 30) + self._copy2(64, 30)
        out, ok, total = run_decode([np.frombuffer(body[:-1], np.uint8)], [60 + 128], out_size=BLOCK_SIZE)
        assert not ok.all()


def test_merged_segments_decode_at_1_17():
    """Merged (>64 KiB output, wide-offset) segments from scan_blocks decode
    bit-exact at the 1<<17 output bucket — the shape the raw fast path
    uses for them."""
    from snappy_tpu.native import runtime as nat

    if not nat.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(3)
    big = rng.integers(0, 256, 70_000).astype(np.uint8).tobytes()
    body = bytes([62 << 2]) + (len(big) - 1).to_bytes(3, "little") + big
    body += bytes([(63 << 2) | 3]) + (66_000).to_bytes(4, "little")  # wide copy
    out_ref = big + big[70_000 - 66_000 : 70_000 - 66_000 + 64]
    body += bytes([3 << 2]) + b"tail"
    out_ref += b"tail"
    stream = varint.encode32(len(out_ref)) + body
    assert oracle.uncompress(stream) == out_ref
    ulen, hdr = nat.uncompressed_length(stream)
    starts, oplens = nat.scan_blocks(stream[hdr:], ulen)
    bodyb = stream[hdr:]
    bounds = list(starts) + [len(bodyb)]
    segs = [np.frombuffer(bodyb[bounds[i] : bounds[i + 1]], np.uint8) for i in range(len(starts))]
    out, ok, _ = run_decode(segs, list(oplens), out_size=1 << 17)
    assert ok.all()
    got = b"".join(out[i, : oplens[i]].tobytes() for i in range(len(segs)))
    assert got == out_ref


# ---------------------------------------------------------------- encoder


def encode_blocks(raw: bytes):
    n = len(raw)
    nb = max(-(-n // BLOCK_SIZE), 1)
    buf = np.zeros((nb, BLOCK_SIZE + encode_xla.ENC_PAD), np.uint8)
    blens = np.zeros(nb, np.int32)
    for i in range(nb):
        chunk = raw[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE]
        buf[i, : len(chunk)] = np.frombuffer(chunk, np.uint8)
        blens[i] = len(chunk)
    out, olens = select.block_encoder(nb)(jnp.asarray(buf), jnp.asarray(blens))
    out, olens = np.asarray(out), np.asarray(olens)
    return [out[i, : olens[i]].tobytes() for i in range(nb)]


def roundtrip(raw: bytes) -> bytes:
    streams = encode_blocks(raw)
    full = varint.encode32(len(raw)) + b"".join(streams)
    return oracle.uncompress(np.frombuffer(full, np.uint8))


@pytest.mark.parametrize(
    "raw",
    [
        b"",
        b"a",
        b"abc",
        b"hello hello hello hello world world",
        b"x" * 1000,
        b"ab" * 5000,
        bytes(range(256)) * 8,
        b"abcdefg" * 1000,
        np.random.default_rng(7).integers(0, 256, 3000).astype(np.uint8).tobytes(),
    ],
    ids=[str(i) for i in range(9)],
)
def test_roundtrip_simple(raw):
    assert roundtrip(raw) == raw


@pytest.mark.parametrize("name", ["html", "sample-tweet.json", "fireworks.jpeg"])
def test_roundtrip_corpus(name):
    raw = read_testdata(name)[: 2 * BLOCK_SIZE]
    assert roundtrip(raw) == raw


def test_block_boundary():
    raw = (b"q" * 70000) + b"tail" * 10
    assert roundtrip(raw) == raw


@pytest.mark.parametrize("name", ["html", "sample-tweet.json"])
def test_density_vs_native(name):
    """Compressed size must not exceed the libsnappy-equivalent native
    encoder's (exact match-finding with a dual parse)."""
    from snappy_tpu.native import runtime as nat

    if not nat.available():
        pytest.skip("native codec unavailable")
    raw = read_testdata(name)[: 2 * BLOCK_SIZE]
    ours = sum(len(s) for s in encode_blocks(raw))
    ref = len(nat.compress(raw)) - len(varint.encode32(len(raw)))
    assert ours <= ref, f"{name}: encode_xla {ours} vs native {ref}"


# ---------------------------------------------------------------- selector


def test_selector_cpu_takes_xla():
    assert select.platform() == "cpu"
    assert select.decoder_name() == "xla"
    assert select.encoder_name() == "xla"
    assert select.block_decoder(8196, BLOCK_SIZE) is decode_xla.decode_blocks_jit(8196, BLOCK_SIZE)
    assert select.block_encoder(4) is encode_xla.encode_blocks_jit(4)


@pytest.mark.parametrize("out_size", [128, 1 << 16, 1 << 17, 1 << 18])
def test_selector_gpu_names_cuda(out_size, monkeypatch):
    """On the GPU every shape goes to the CUDA decoder (its FFI handler
    rejects an output window past its shared memory); nothing is built or
    called here."""
    assert select.decoder_name("gpu") == "cuda"
    assert select.encoder_name("gpu") == "xla"
    monkeypatch.setattr(select, "platform", lambda: "gpu")
    monkeypatch.setattr(decode_cuda, "decode_blocks_jit", lambda c, o: ("cuda", c, o))
    assert select.block_decoder(8196, out_size) == ("cuda", 8196, out_size)


@pytest.mark.parametrize("plat", ["rocm", "metal", "interpreter"])
def test_selector_unknown_platform_raises(plat):
    with pytest.raises(RuntimeError, match="no codec kernels"):
        select.decoder_name(plat)
    with pytest.raises(RuntimeError, match="no codec kernels"):
        select.encoder_name(plat)


# ---------------------------------------------------------- CUDA wrapper


@pytest.mark.parametrize("out_size", [128, 8192, 1 << 16, 1 << 17])
def test_cuda_wrapper_shapes(out_size):
    comp = jax.ShapeDtypeStruct((6, 8196), jnp.uint8)
    lens = jax.ShapeDtypeStruct((6,), jnp.int32)
    out, ok, total = jax.eval_shape(lambda c, a, b: decode_cuda.decode_blocks(c, a, b, out_size), comp, lens, lens)
    assert (out.shape, out.dtype) == ((6, out_size), jnp.uint8)
    assert (ok.shape, ok.dtype) == ((6,), jnp.bool_)
    assert (total.shape, total.dtype) == ((6,), jnp.int32)


def test_cuda_wrapper_lowers_to_ffi_target():
    comp = jnp.zeros((2, 68), jnp.uint8)
    lens = jnp.zeros((2,), jnp.int32)
    text = jax.jit(lambda c, a, b: decode_cuda.decode_blocks(c, a, b, 256)).lower(comp, lens, lens).as_text()
    assert decode_cuda.TARGET in text


def test_cuda_wrapper_rejects_bad_shapes():
    lens = jnp.zeros((2,), jnp.int32)
    with pytest.raises(TypeError):
        jax.eval_shape(lambda c: decode_cuda.decode_blocks(c, lens, lens, 256), jnp.zeros((2, 68), jnp.int32))
    with pytest.raises(TypeError):
        jax.eval_shape(lambda c: decode_cuda.decode_blocks(c, lens, lens, 256), jnp.zeros((2, 4, 17), jnp.uint8))


def test_cuda_call_traces_under_shard_map_with_vma_checks():
    """Each shard calls the FFI target on its local blocks; shard_map's
    replication checks (check_vma) accept the call."""
    from jax.sharding import PartitionSpec as P

    from snappy_tpu.parallel import distributed

    mesh = distributed.mesh_1d(jax.devices()[:4])

    def local(comp, clens, ulens):
        return decode_cuda.decode_blocks(comp, clens, ulens, 1024)

    spec = P(distributed.AXIS)
    fn = jax.shard_map(local, mesh=mesh, in_specs=(spec,) * 3, out_specs=(spec,) * 3, check_vma=True)
    comp = jax.ShapeDtypeStruct((8, 260), jnp.uint8)
    lens = jax.ShapeDtypeStruct((8,), jnp.int32)
    out, ok, total = jax.eval_shape(fn, comp, lens, lens)
    assert out.shape == (8, 1024) and ok.shape == (8,)


# ------------------------------------------------------- raw-stream path


def test_raw_stream_takes_batched_block_decoder():
    """With scan_blocks available, raw streams decode through the batched
    block decoder on every platform (no platform gate)."""
    from snappy_tpu.native import runtime as nat
    from snappy_tpu.ops import host as xh

    if not nat.available():
        pytest.skip("native library unavailable")
    raw = (read_testdata("html") * 2)[: 2 * BLOCK_SIZE + 999]
    comp = np.frombuffer(nat.compress(raw), np.uint8)
    ulen, start = varint.parse32(comp, 0)
    calls = []

    def spy(cmax_padded, out_size):
        calls.append((cmax_padded, out_size))
        return select.block_decoder(cmax_padded, out_size)

    assert xh._uncompress_blocked(comp, ulen, start, spy) == raw
    assert calls and calls[0][1] == BLOCK_SIZE
    assert xh.uncompress(comp) == raw


def _dispatch_rows(comp, ulen, start):
    """Row counts of every block-decoder dispatch of the raw fast path."""
    from snappy_tpu.ops import host as xh

    rows = []

    def spy(cmax_padded, out_size):
        dec = select.block_decoder(cmax_padded, out_size)

        def run(c, a, b):
            rows.append(c.shape[0])
            return dec(c, a, b)

        return run

    return xh._uncompress_blocked(comp, ulen, start, spy), rows


def test_raw_stream_one_block_dispatches_one_row():
    """A one-block stream decodes as a batch of one row, not a padded
    batch of hundreds."""
    from snappy_tpu.native import runtime as nat

    if not nat.available():
        pytest.skip("native library unavailable")
    raw = read_testdata("html")[:5000]
    comp = np.frombuffer(nat.compress(raw), np.uint8)
    ulen, start = varint.parse32(comp, 0)
    out, rows = _dispatch_rows(comp, ulen, start)
    assert out == raw and rows == [1]


def _xla_temp_bytes(n_blocks, cmax_padded):
    args = (
        jax.ShapeDtypeStruct((n_blocks, cmax_padded), jnp.uint8),
        jax.ShapeDtypeStruct((n_blocks,), jnp.int32),
        jax.ShapeDtypeStruct((n_blocks,), jnp.int32),
    )
    fn = decode_xla.decode_blocks_jit(cmax_padded, BLOCK_SIZE)
    return fn.lower(*args).compile().memory_analysis().temp_size_in_bytes


def test_raw_multi_mib_stream_decodes_in_bounded_memory():
    """A stream of more blocks than decode_xla.MAX_BATCH_BLOCKS decodes
    bit-exact, and the decoder's temporaries stay those of one step: at
    eight steps' worth of blocks they are under twice one step's."""
    from snappy_tpu.native import runtime as nat
    from snappy_tpu.parallel.host import _bucket_cmax

    if not nat.available():
        pytest.skip("native library unavailable")
    m = decode_xla.MAX_BATCH_BLOCKS
    mix = b"".join(read_testdata(n) for n in ("html", "urls.10K", "alice29.txt", "fireworks.jpeg"))
    raw = (mix * (-(-(m + 5) * BLOCK_SIZE // len(mix))))[: (m + 5) * BLOCK_SIZE - 777]
    comp = np.frombuffer(nat.compress(raw), np.uint8)
    ulen, start = varint.parse32(comp, 0)
    out, rows = _dispatch_rows(comp, ulen, start)
    assert out == raw and rows == [2 * m]
    cmax = _bucket_cmax(8192) + decode_xla.COMP_PAD
    one_step = _xla_temp_bytes(m, cmax)
    assert _xla_temp_bytes(8 * m, cmax) < 2 * one_step


@pytest.mark.parametrize("extra", [1, 3, decode_xla.MAX_BATCH_BLOCKS, 2 * decode_xla.MAX_BATCH_BLOCKS + 5])
def test_decode_xla_steps_match_one_batch(extra):
    """Batches past MAX_BATCH_BLOCKS run as a loop of steps (padded to whole
    steps); out, ok and total equal one vectorized batch's, row for row."""
    rng = np.random.default_rng(extra)
    b = decode_xla.MAX_BATCH_BLOCKS + extra
    texts = [rng.choice([b"ab", b"xyz ", b"q"]) * int(rng.integers(1, 60)) for _ in range(b)]
    # Every third row is random bytes: mostly corrupt streams.
    streams = [
        oracle.compress(t)[len(varint.encode32(len(t))) :] if i % 3 else rng.integers(0, 256, 40).astype(np.uint8).tobytes()
        for i, t in enumerate(texts)
    ]
    comp = np.zeros((b, 160 + decode_xla.COMP_PAD), np.uint8)
    for i, s in enumerate(streams):
        comp[i, : len(s)] = np.frombuffer(s, np.uint8)
    clens = np.array([len(s) for s in streams], np.int32)
    ulens = np.array([len(t) if i % 3 else 50 for i, t in enumerate(texts)], np.int32)
    args = (jnp.asarray(comp), jnp.asarray(clens), jnp.asarray(ulens))
    got = decode_xla.decode_blocks(*args, 256)
    want = decode_xla.decode_blocks_impl(*args, jnp.zeros_like(args[1]), 256)
    for g, w in zip(got, want):
        assert g.shape == w.shape and (np.asarray(g) == np.asarray(w)).all()
    ok = np.asarray(got[1])
    assert ok[[i for i in range(b) if i % 3]].all()


# ------------------------------------------------------------ compile cache


def test_cache_helper_defaults_to_repo_dir(monkeypatch):
    from snappy_tpu.utils import cache

    monkeypatch.delenv(cache.ENV, raising=False)
    assert cache.cache_dir() == os.path.join(cache.REPO, ".jax_cache")
    assert os.path.isdir(os.path.join(cache.REPO, "snappy_tpu"))
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    assert cache.enable() == cache.DEFAULT_DIR
    assert calls == [("jax_compilation_cache_dir", cache.DEFAULT_DIR)]


def test_cache_helper_leaves_env_setting(monkeypatch, tmp_path):
    from snappy_tpu.utils import cache

    monkeypatch.setenv(cache.ENV, str(tmp_path))
    assert cache.cache_dir() is None
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    assert cache.enable() == str(tmp_path)
    assert calls == []
