"""Benchmark harness: device codec throughput on the snappy corpus, on the GPU.

    python bench.py

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

Headline: device decompress throughput (GB/s of uncompressed bytes) on a
corpus-mix batch, vs the reference's published large-stream uncompress rate
(247 MB/s, reference README.md:45 / BASELINE.md). Like the reference
benchmark (reference test/benchmarks.jl:27-69), decode times the codec's
OWN compressed output — the routed device encoder's (ops/route.py) — and
that output is gated before timing:
  1. device round-trip must be bit-exact and flag ok,
  2. REAL libsnappy (ctypes, snappy_tpu/native/libsnappy.py) must decode
     sampled streams bit-exact, where it is installed,
  3. total device compressed size must not exceed real libsnappy's.
Every kernel comes from the selector (ops/select.py). Times are medians of
calls ending in ``block_until_ready``; the device arrays are put on the
card before timing. Full results land in benchmarks/report_last.json.
It needs a GPU: on any other platform it exits non-zero.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax

from snappy_tpu.core import varint
from snappy_tpu.core.constants import BLOCK_SIZE
from snappy_tpu.ops import decode_xla, encode_xla, select
from snappy_tpu.utils import cache
from snappy_tpu.utils.metrics import Metrics, time_fn

# Reference baseline: Snappy.jl uncompress on the 644MB stream (README.md:45).
BASELINE_DECODE_GBPS = 0.247
BATCH = 128  # blocks per dispatch (8 MiB uncompressed)
CORPUS_MIX = [
    "alice29.txt", "html", "urls.10K", "fireworks.jpeg", "paper-100k.pdf",
    "lcet10.txt", "plrabn12.txt", "geo.protodata", "kppkn.gtb", "sample-tweet.json",
]


def corpus_stream(target_bytes: int) -> bytes:
    """The corpus mix, repeated to ``target_bytes``."""
    td = os.path.join(REPO, "testdata")
    bufs = [open(os.path.join(td, n), "rb").read() for n in CORPUS_MIX]
    out = []
    total = 0
    i = 0
    while total < target_bytes:
        out.append(bufs[i % len(bufs)])
        total += len(bufs[i % len(bufs)])
        i += 1
    return b"".join(out)[:target_bytes]


def pack_streams(streams, pad: int):
    cmax = -(-(max(len(s) for s in streams) + pad) // 512) * 512
    comp_np = np.zeros((len(streams), cmax), np.uint8)
    for i, s in enumerate(streams):
        comp_np[i, : len(s)] = np.frombuffer(s, np.uint8) if isinstance(s, bytes) else s
    clens = np.array([len(s) for s in streams], np.int32)
    return cmax, comp_np, clens


def time_decode(streams, raw: bytes, label: str, metrics) -> float:
    """Gate bit-exactness, then time the device decode of ``streams``."""
    cmax, comp_np, clens_np = pack_streams(streams, decode_xla.COMP_PAD)
    dec = select.block_decoder(cmax, BLOCK_SIZE)
    args = (
        jax.device_put(comp_np),
        jax.device_put(clens_np),
        jax.device_put(np.full(len(streams), BLOCK_SIZE, np.int32)),
    )
    out, ok, _ = dec(*args)
    assert bool(np.asarray(ok).all()), f"bench decode flagged corrupt ({label})"
    assert np.asarray(out).tobytes() == raw[: len(streams) * BLOCK_SIZE], f"decode mismatch ({label})"
    st = time_fn(dec, args)
    gbps = len(streams) * BLOCK_SIZE / st["median"] / 1e9
    metrics.add(
        stage=f"decode_{label}",
        gbps=gbps,
        seconds_per_batch=st["median"],
        timing=st,
        kernel=select.decoder_name(),
    )
    return gbps


def main() -> None:
    cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    metrics = Metrics()
    metrics.run = {"device": device, "batch": BATCH}

    from snappy_tpu.native import libsnappy as ls
    from snappy_tpu.ops import route

    stream_bytes = int(os.environ.get("BENCH_BYTES", BATCH * BLOCK_SIZE))
    raw = corpus_stream(stream_bytes)
    inp = np.frombuffer(raw, np.uint8)
    assert len(raw) // BLOCK_SIZE >= BATCH, "BENCH_BYTES too small for one batch"

    # ---- real-libsnappy baseline sizes (the genuine article, not our C++).
    ls_total = None
    if ls.available():
        ls_total = sum(
            len(ls.compress(raw[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE])) - len(varint.encode32(BLOCK_SIZE))
            for i in range(BATCH)
        )
        metrics.add(stage="ratio_libsnappy", compressed_ratio=ls_total / (BATCH * BLOCK_SIZE))

    # ---- device encode through the production routed path (ops/route.py):
    # incompressible blocks take the host-native encoder while the device
    # dispatch is in flight.
    buf0 = np.zeros((BATCH, BLOCK_SIZE + encode_xla.ENC_PAD), np.uint8)
    buf0[:, :BLOCK_SIZE] = inp[: BATCH * BLOCK_SIZE].reshape(BATCH, BLOCK_SIZE)
    lens0 = np.full(BATCH, BLOCK_SIZE, np.int32)
    enc_streams = route.compress_blocks_routed(buf0, lens0, BATCH, select.block_encoder)
    host_idx0 = np.flatnonzero(route.dup_ratios(buf0, lens0, BATCH) < route.DUP_THRESHOLD)
    dev_idx0 = np.setdiff1d(np.arange(BATCH), host_idx0)
    dev_total = sum(len(s) for s in enc_streams)
    metrics.add(stage="ratio_device", compressed_ratio=dev_total / (BATCH * BLOCK_SIZE), blocks_host_routed=len(host_idx0))
    if ls.available():
        for i in range(0, BATCH, 8):
            stream = varint.encode32(BLOCK_SIZE) + enc_streams[i]
            assert ls.uncompress(stream) == raw[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE], (
                f"device-encoded block {i} not decodable by real libsnappy"
            )
        assert dev_total <= ls_total, f"device ratio {dev_total} > libsnappy {ls_total}"

    # Timed routed dispatch with the device subset put on the card first:
    # the detector and the host-native encodes are timed (real per-batch work).
    nbd = max(len(dev_idx0), 1)
    enc = select.block_encoder(nbd)
    sub = np.zeros((nbd,) + buf0.shape[1:], np.uint8)
    sub[: len(dev_idx0)] = buf0[dev_idx0]
    sublens = np.zeros(nbd, np.int32)
    sublens[: len(dev_idx0)] = lens0[dev_idx0]
    dsub, dsublens = jax.device_put(sub), jax.device_put(sublens)

    def routed_dispatch():
        route.dup_ratios(buf0, lens0, BATCH)  # detector (host)
        out_d = enc(dsub, dsublens)  # async device dispatch
        route.native_streams_for(buf0, lens0, host_idx0)  # overlapped
        return out_d

    enc_st = time_fn(routed_dispatch, iters=5)
    metrics.add(
        stage="encode",
        gbps=BATCH * BLOCK_SIZE / enc_st["median"] / 1e9,
        seconds_per_batch=enc_st["median"],
        timing=enc_st,
        kernel=select.encoder_name() + "+routed_native",
    )

    # ---- headline: decode the framework's own streams.
    dec_gbps = time_decode(enc_streams, raw, "own", metrics)
    print(
        json.dumps(
            {
                "metric": "device_decompress_throughput",
                "value": round(dec_gbps, 4),
                "unit": "GB/s",
                "vs_baseline": round(dec_gbps / BASELINE_DECODE_GBPS, 2),
                "device": device,
            }
        ),
        flush=True,
    )

    # ---- decode of a FOREIGN raw stream (native host greedy encoder, ONE
    # stream over the whole batch), segmented the way the raw fast path
    # does it (native scan_blocks finds the 64 KiB-output tag boundaries).
    if os.environ.get("BENCH_FOREIGN", "1") != "0":
        from snappy_tpu.native import runtime as nat

        stream = nat.compress(raw[: BATCH * BLOCK_SIZE])
        ulen, hdr = nat.uncompressed_length(stream)
        body = stream[hdr:]
        starts, oplens = nat.scan_blocks(body, ulen)
        assert len(starts) == BATCH and (np.asarray(oplens) == BLOCK_SIZE).all()
        bounds = list(starts) + [len(body)]
        foreign = [body[bounds[i] : bounds[i + 1]] for i in range(len(starts))]
        time_decode(foreign, raw, "foreign", metrics)

    # ---- fallback cliff: the windowed XLA decoder on a hostile-but-valid
    # stream that defeats segmentation (one >128 KiB literal up front, then
    # far back-references). Small stream: the windowed path is slow by
    # design and the number is the point.
    if os.environ.get("BENCH_WINDOWED", "1") != "0":
        big_lit = np.frombuffer(corpus_stream(200_000), np.uint8)
        parts = [bytes([62 << 2]) + (len(big_lit) - 1).to_bytes(3, "little") + big_lit.tobytes()]
        out_len = len(big_lit)
        ncopies = ((2 << 20) - out_len) // 64
        # COPY_4 len 64, offset 150000: far back-references after a >128 KiB
        # literal — the segmenter (correctly) refuses this shape
        parts.append(bytes([(63 << 2) | 3] + list((150_000).to_bytes(4, "little"))) * ncopies)
        out_len += 64 * ncopies
        hostile = varint.encode32(out_len) + b"".join(parts)
        exp = np.empty(out_len, np.uint8)
        exp[: len(big_lit)] = big_lit
        o = len(big_lit)
        while o < out_len:
            n = min(64, out_len - o)
            exp[o : o + n] = exp[o - 150_000 : o - 150_000 + n]
            o += n
        hdr_len = len(varint.encode32(out_len))
        t0 = time.perf_counter()
        out_h = decode_xla.decode_raw_windowed(np.frombuffer(hostile, np.uint8), out_len, hdr_len)
        t_h = time.perf_counter() - t0
        assert out_h == exp.tobytes(), "windowed fallback mismatch"
        metrics.add(stage="decode_windowed_fallback", bytes=out_len, gbps=out_len / t_h / 1e9, kernel="xla_windowed")

    # ---- large config, device-resident kernel rate: DISTINCT batches that
    # all live on the card (encoded there once, one batch per chunk), so the
    # timed decode touches the full byte count.
    large_bytes = int(os.environ.get("BENCH_LARGE_BYTES", 64 << 20))
    if large_bytes > 0:
        loops = -(-large_bytes // (BATCH * BLOCK_SIZE))
        lraw = corpus_stream(loops * BATCH * BLOCK_SIZE)
        enc_l = select.block_encoder(BATCH)
        dlens = jax.device_put(np.full(BATCH, BLOCK_SIZE, np.int32))
        dbufs, outs = [], []
        for k in range(loops):
            bufk = np.zeros((BATCH, BLOCK_SIZE + encode_xla.ENC_PAD), np.uint8)
            bufk[:, :BLOCK_SIZE] = np.frombuffer(lraw, np.uint8)[k * BATCH * BLOCK_SIZE : (k + 1) * BATCH * BLOCK_SIZE].reshape(BATCH, BLOCK_SIZE)
            dbufs.append(jax.device_put(bufk))
            outs.append(enc_l(dbufs[-1], dlens))
        # The decoder's width bucket, sliced on the device out of the
        # encoder's wider rows; bytes past each clen are never read.
        width = -(-(max(int(np.asarray(ol).max()) for _, ol in outs) + decode_xla.COMP_PAD) // 8192) * 8192
        assert width <= encode_xla.BLOCK_MAX_OUT
        dec_l = select.block_decoder(width, BLOCK_SIZE)
        dcomps = [o[:, :width] for o, _ in outs]
        dclens = [ol for _, ol in outs]
        got, oks, _ = dec_l(dcomps[0], dclens[0], dlens)
        assert bool(np.asarray(oks).all()) and np.asarray(got).tobytes() == lraw[: BATCH * BLOCK_SIZE]

        def decode_all():
            return [dec_l(dcomps[k], dclens[k], dlens) for k in range(loops)]

        def encode_all():
            return [enc_l(dbufs[k], dlens) for k in range(loops)]

        st_d = time_fn(decode_all, iters=3)
        st_e = time_fn(encode_all, iters=3)
        nbytes = loops * BATCH * BLOCK_SIZE
        metrics.add(
            stage="large_device",
            bytes=nbytes,
            compress_gbps=nbytes / st_e["median"] / 1e9,
            uncompress_gbps=nbytes / st_d["median"] / 1e9,
            kernels={"encode": select.encoder_name(), "decode": select.decoder_name()},
        )
        del dcomps, dbufs, outs

    # ---- streaming pipeline: frames through parallel/streaming.py with
    # read/compute/write overlap.
    stream_cfg = int(os.environ.get("BENCH_STREAM_BYTES", 64 << 20))
    if stream_cfg > 0:
        import io

        from snappy_tpu.parallel import streaming

        sraw = corpus_stream(stream_cfg)
        warm = io.BytesIO()
        streaming.compress_stream(io.BytesIO(sraw[: BATCH * BLOCK_SIZE]), warm, blocks_per_frame=BATCH)
        warm.seek(0)
        streaming.uncompress_stream(warm, io.BytesIO())
        comp_buf = io.BytesIO()
        t0 = time.perf_counter()
        csize = streaming.compress_stream(io.BytesIO(sraw), comp_buf, blocks_per_frame=BATCH)
        t_c = time.perf_counter() - t0
        comp_buf.seek(0)
        out_buf = io.BytesIO()
        t0 = time.perf_counter()
        n = streaming.uncompress_stream(comp_buf, out_buf)
        t_u = time.perf_counter() - t0
        assert n == len(sraw) and out_buf.getvalue() == sraw, "streaming round-trip mismatch"
        metrics.add(
            stage="stream_large",
            bytes=len(sraw),
            ratio=csize / len(sraw),
            compress_gbps=len(sraw) / t_c / 1e9,
            uncompress_gbps=len(sraw) / t_u / 1e9,
            blocks_per_frame=BATCH,
            retries=streaming.last_stats.get("retries", 0),
        )

    metrics.dump(os.path.join(REPO, "benchmarks", "report_last.json"))


if __name__ == "__main__":
    main()
