"""Per-file corpus benchmark replicating the reference's README table
(reference test/benchmarks.jl:10-102, README.md:28-47): compress and
uncompress throughput per corpus file, device path vs native C++, and
compressed ratios vs real libsnappy.

Each file is tiled into a BATCH of 64 KiB blocks per dispatch and timed as
the median of calls ending in ``block_until_ready``. The device decode
times the routed device encoder's own streams (gated bit-exact first),
like the reference times its own compress output. Kernels come from the
selector (ops/select.py). Needs a GPU; exits non-zero elsewhere.

    python benchmarks/run_corpus.py [--md OUT.md]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

from snappy_tpu.core import varint
from snappy_tpu.core.constants import BLOCK_SIZE
from snappy_tpu.ops import decode_xla, encode_xla, select
from snappy_tpu.utils import cache
from snappy_tpu.utils.metrics import time_fn
from bench import pack_streams

FILES = [
    ("txt", "alice29.txt"),
    ("html", "html"),
    ("jpeg", "fireworks.jpeg"),
    ("pdf", "paper-100k.pdf"),
    ("urls", "urls.10K"),
    ("json", "sample-tweet.json"),
]
BATCH = 128  # matches bench.py so the encoder jit compile is shared


def human(bps: float) -> str:
    return f"{bps / 1e9:.2f} GB/s" if bps >= 1e9 else f"{bps / 1e6:.0f} MB/s"


def median_time(fn, iters: int = 9) -> float:
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def tile_blocks(raw: bytes, batch: int) -> np.ndarray:
    buf = raw
    while len(buf) < batch * BLOCK_SIZE:
        buf += raw
    return np.frombuffer(buf[: batch * BLOCK_SIZE], np.uint8).reshape(batch, BLOCK_SIZE)


def device_row(raw: bytes) -> dict:
    from snappy_tpu.ops import route

    blocks = tile_blocks(raw, BATCH)
    buf = np.zeros((BATCH, BLOCK_SIZE + encode_xla.ENC_PAD), np.uint8)
    buf[:, :BLOCK_SIZE] = blocks
    lens = np.full(BATCH, BLOCK_SIZE, np.int32)
    streams = route.compress_blocks_routed(buf, lens, BATCH, select.block_encoder)
    host_idx = np.flatnonzero(route.dup_ratios(buf, lens, BATCH) < route.DUP_THRESHOLD)
    dev_idx = np.setdiff1d(np.arange(BATCH), host_idx)
    # Timed routed dispatch with the device subset put on the card first.
    nbd = max(len(dev_idx), 1)
    enc = select.block_encoder(nbd)
    sub = np.zeros((nbd,) + buf.shape[1:], np.uint8)
    sub[: len(dev_idx)] = buf[dev_idx]
    sublens = np.zeros(nbd, np.int32)
    sublens[: len(dev_idx)] = lens[dev_idx]
    dsub, dsublens = jax.device_put(sub), jax.device_put(sublens)

    def routed_call():
        route.dup_ratios(buf, lens, BATCH)  # detector (host)
        out_d = enc(dsub, dsublens) if len(dev_idx) else None  # async device dispatch
        route.native_streams_for(buf, lens, host_idx)  # overlapped
        return out_d

    # One decode width for every file: a single compile shared across files.
    width = -(-(encode_xla.BLOCK_MAX_OUT + decode_xla.COMP_PAD) // 512) * 512
    _, comp_np, clens_np = pack_streams(streams, decode_xla.COMP_PAD)
    comp_np = np.pad(comp_np, ((0, 0), (0, width - comp_np.shape[1])))
    dec = select.block_decoder(width, BLOCK_SIZE)
    args = (jax.device_put(comp_np), jax.device_put(clens_np), jax.device_put(lens))
    out, ok, _ = dec(*args)
    assert bool(np.asarray(ok).all()), "device decode flagged corrupt"
    assert np.asarray(out).tobytes() == blocks.tobytes(), "device decode mismatch"
    return {
        "blocks_host_routed": len(host_idx),
        "ratio_device": sum(len(t) for t in streams) / (BATCH * BLOCK_SIZE),
        "dev_compress": BATCH * BLOCK_SIZE / time_fn(routed_call, iters=3)["median"],
        "dev_uncompress": BATCH * BLOCK_SIZE / time_fn(dec, args, iters=3)["median"],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=9)
    ap.add_argument("--md", default=None, help="write a markdown table to this path")
    args = ap.parse_args()

    cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"run_corpus.py measures the GPU; JAX found {dev.platform!r}")

    from snappy_tpu.native import libsnappy as ls
    from snappy_tpu.native import runtime as nat

    rows = []
    for label, name in FILES:
        raw = open(os.path.join(REPO, "testdata", name), "rb").read()
        comp = nat.compress(raw)
        nat.uncompress(comp)  # warm
        row = {
            "file": label,
            "size": len(raw),
            "ratio_native": len(comp) / len(raw),
            "native_compress": len(raw) / median_time(lambda: nat.compress(raw), args.iters),
            "native_uncompress": len(raw) / median_time(lambda: nat.uncompress(comp), args.iters),
        }
        if ls.available():
            row["ratio_libsnappy"] = sum(
                len(ls.compress(bytes(b))) - len(varint.encode32(BLOCK_SIZE)) for b in tile_blocks(raw, 16)
            ) / (16 * BLOCK_SIZE)
        row.update(device_row(raw))
        rows.append(row)
        print(f"{label}: {row}", flush=True)

    lines = [
        "| file | size | ratio (dev) | ratio (libsnappy) | dev compress | dev uncompress | native C++ comp | native C++ unc |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['file']} | {r['size']} | {r['ratio_device']:.3f} | {r.get('ratio_libsnappy', float('nan')):.3f} "
            f"| {human(r['dev_compress'])} | {human(r['dev_uncompress'])} "
            f"| {human(r['native_compress'])} | {human(r['native_uncompress'])} |"
        )
    table = "\n".join(lines)
    print(table)
    if args.md:
        with open(args.md, "w") as f:
            f.write(
                "# Per-file corpus benchmark\n\n"
                f"Device: {dev.device_kind} ({dev.platform}); {BATCH} tiled 64 KiB blocks per "
                "dispatch; kernels: encode "
                f"{select.encoder_name()}, decode {select.decoder_name()}. Ratios "
                "are compressed/uncompressed on tiled blocks (headerless).\n\n"
            )
            f.write(table + "\n")
        print(f"wrote {args.md}")


if __name__ == "__main__":
    main()
