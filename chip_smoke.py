"""Chip smoke test: drive the codec's main paths once on an NVIDIA GPU.

    python chip_smoke.py [--mib 64]     # one card
    python chip_smoke.py --cards 4      # the paths that span four cards

One card: builds the native C++ codec and the CUDA block decoder, then, on
a corpus-mix stream (64 MiB = 1,024 blocks of 64 KiB by default):

  1. raw API: snappy_tpu.compress/uncompress(backend="xla"), checked
     byte for byte under the native decoder (and real libsnappy where
     installed), for size against the native greedy encoder, and on foreign
     streams (the native encoder's, testdata/alice29.snappy);
  2. the framed container on one device;
  3. the streaming pipeline (parallel/streaming.py);
  4. the kernels: the CUDA decoder against decode_xla (out, ok and total
     identical) on the corpus batch, the 1<<17 merged segment and the
     corrupt battery, with times for both decoders and for encode_xla.

Four cards: the parent stays off JAX and runs, in turn, one child that
drives all four cards (parallel/distributed.py, gather=False and True, and
the mesh-framed path, checked against the single-device path) and four
one-card processes of the multi-host drivers (parallel/multihost.py).

Every phase checks exact bytes; any failure exits non-zero. The last line
of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi (a child off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.replace("\n", " | ")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def gpu_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: JAX's default device is {dev.platform!r}, not a GPU")
    return dev


def corpus(mib: int) -> bytes:
    from bench import corpus_stream

    return corpus_stream(mib << 20)


def median_seconds(fn, *args) -> float:
    from snappy_tpu.utils.metrics import time_fn

    return time_fn(fn, args, iters=5)["median"]


# ---------------------------------------------------------------- one card


def build_libraries() -> None:
    from snappy_tpu.native import build
    from snappy_tpu.native import runtime as nat

    t0 = time.perf_counter()
    build.build()
    log(f"build: native C++ codec {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    build.build_cuda()
    log(f"build: CUDA block decoder {time.perf_counter() - t0:.2f} s")
    check(nat.available(), "native codec (scan_blocks) unavailable")
    from snappy_tpu.ops import decode_cuda

    decode_cuda.register()


def phase_raw(data: bytes) -> None:
    import numpy as np

    import snappy_tpu
    from snappy_tpu.core import varint
    from snappy_tpu.native import libsnappy as ls
    from snappy_tpu.native import runtime as nat
    from snappy_tpu.ops import host as xh
    from snappy_tpu.ops import select

    used = set()

    def recording(cmax_padded, out_size):
        used.add(select.decoder_name())
        return select.block_decoder(cmax_padded, out_size)

    t0 = time.perf_counter()
    own = snappy_tpu.compress(data, backend="xla")
    t_c = time.perf_counter() - t0
    check(nat.uncompress(own) == data, "own stream does not decode under the native decoder")
    decoders = ["native C++"]
    if ls.available():
        check(ls.uncompress(own) == data, "own stream does not decode under libsnappy")
        decoders.append("libsnappy")
    native = nat.compress(data)
    check(len(own) <= len(native), f"own stream {len(own)} B larger than the native encoder's {len(native)} B")
    log(
        f"raw compress: {len(data)} -> {len(own)} B (native greedy {len(native)} B) in {t_c:.3f} s "
        f"(first call, compiles included); kernel encode_{select.encoder_name()} + routed native; "
        f"decodes bit-exact under {', '.join(decoders)}"
    )
    foreign = read_testdata("alice29.snappy")
    for label, stream, expect in (
        ("own stream", own, data),
        ("native stream", native, data),
        ("alice29.snappy", foreign, read_testdata("alice29.txt")),
    ):
        check(snappy_tpu.uncompress(stream, backend="xla") == expect, f"uncompress mismatch: {label}")
        comp = np.frombuffer(stream, np.uint8)
        ulen, start = varint.parse32(comp, 0)
        out = xh._uncompress_blocked(comp, ulen, start, recording)
        check(out is not None, f"raw fast path declined {label}")
        check(out == expect, f"raw fast path mismatch: {label}")
    log(f"raw uncompress: own, native and alice29.snappy streams bit-exact on the batched fast path; kernel decode_{'+'.join(sorted(used))}")


def phase_framed(data: bytes) -> None:
    import snappy_tpu
    from snappy_tpu.core.constants import BLOCK_SIZE
    from snappy_tpu.ops import decode_xla, select
    from snappy_tpu.parallel import framed
    from snappy_tpu.parallel.host import _bucket_cmax

    t0 = time.perf_counter()
    frame = snappy_tpu.compress_framed(data)
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = snappy_tpu.uncompress_framed(frame)
    t_u = time.perf_counter() - t0
    check(out == data, "framed round trip mismatch")
    idx = framed.parse_index(frame)
    cmax = _bucket_cmax(max(e - s for s, e in idx.block_ranges()))
    log(
        f"framed (one device): {len(data)} -> {len(frame)} B, round trip bit-exact "
        f"(compress {t_c:.3f} s, uncompress {t_u:.3f} s, first calls); kernels encode_{select.encoder_name()} "
        f"+ routed native, decode_{select.decoder_name()}"
    )


def phase_streaming(data: bytes) -> None:
    import io

    from snappy_tpu.parallel import streaming

    dst = io.BytesIO()
    t0 = time.perf_counter()
    csize = streaming.compress_stream(io.BytesIO(data), dst)
    t_c = time.perf_counter() - t0
    dst.seek(0)
    out = io.BytesIO()
    t0 = time.perf_counter()
    n = streaming.uncompress_stream(dst, out)
    t_u = time.perf_counter() - t0
    check(n == len(data) and out.getvalue() == data, "streaming round trip mismatch")
    log(f"streaming: {len(data)} -> {csize} B, round trip bit-exact (compress {t_c:.3f} s, uncompress {t_u:.3f} s)")


def read_testdata(name: str) -> bytes:
    with open(os.path.join(REPO, "testdata", name), "rb") as f:
        return f.read()


def block_batch(data: bytes, n_blocks: int):
    """Native-encoded headerless block streams of the first n_blocks blocks,
    packed as the decoders take them."""
    import numpy as np

    from snappy_tpu.core.constants import BLOCK_SIZE
    from snappy_tpu.native import runtime as nat
    from snappy_tpu.ops import decode_xla

    bodies = []
    for i in range(n_blocks):
        s = nat.compress(data[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE])
        _, hdr = nat.uncompressed_length(s)
        bodies.append(s[hdr:])
    cmax = -(-max(len(b) for b in bodies) // 8192) * 8192 + decode_xla.COMP_PAD
    return bodies, [BLOCK_SIZE] * n_blocks, cmax


def compare_decoders(label: str, bodies, ulens, out_size: int, cmax_padded: int, card: str, timing: bool):
    import jax
    import numpy as np

    from snappy_tpu.ops import decode_cuda, decode_xla

    comp = np.zeros((len(bodies), cmax_padded), np.uint8)
    for i, b in enumerate(bodies):
        comp[i, : len(b)] = np.frombuffer(bytes(b), np.uint8)
    args = (
        jax.device_put(comp),
        jax.device_put(np.array([len(b) for b in bodies], np.int32)),
        jax.device_put(np.asarray(ulens, np.int32)),
    )
    fx = decode_xla.decode_blocks_jit(cmax_padded, out_size)
    fc = decode_cuda.decode_blocks_jit(cmax_padded, out_size)
    rx, rc = fx(*args), fc(*args)
    for name, a, b in zip(("out", "ok", "total"), rx, rc):
        check(bool((np.asarray(a) == np.asarray(b)).all()), f"{label}: CUDA decoder {name} differs from decode_xla")
    n_ok = int(np.asarray(rc[1]).sum())
    msg = f"kernel check {label}: {len(bodies)} blocks, out/ok/total identical (cuda vs xla), {n_ok} ok"
    if timing:
        nbytes = len(bodies) * out_size
        tc, tx = median_seconds(fc, *args), median_seconds(fx, *args)
        msg += (
            f"; decode_cuda {tc * 1e3:.3f} ms ({nbytes / tc / 1e9:.2f} GB/s), "
            f"decode_xla {tx * 1e3:.3f} ms ({nbytes / tx / 1e9:.2f} GB/s) [{card}]"
        )
    log(msg)
    return args


def phase_kernels(data: bytes, card: str) -> None:
    import jax
    import numpy as np

    from snappy_tpu.core import varint
    from snappy_tpu.core.constants import BLOCK_SIZE
    from snappy_tpu.cpu import oracle
    from snappy_tpu.native import runtime as nat
    from snappy_tpu.ops import decode_cuda, decode_xla, encode_xla
    from snappy_tpu.ops import host as xh

    # Corrupt battery: every structurally bad shape, plus a good block.
    corrupt = [
        bytes([0x12, 0x00, 0x00]),
        bytes([0x61, 0x09, 0x20, 0x00]),
        bytes([39 << 2, 0x61, 0x62]),
        bytes([0xF8]),
        bytes([0x01]),
        bytes([0x0C, 97, 98, 99, 100, 0x0F, 4, 0, 255, 255]),
        bytes([0x00, 97, 0x02 | (63 << 2), 1]),
    ]
    good = oracle.compress(b"hello world " * 40)
    args = compare_decoders(
        "corrupt battery", corrupt + [good[2:]], [64] * 6 + [65, 480], 1 << 13, 8192 + 4, card, False
    )
    ok = np.asarray(decode_cuda.decode_blocks_jit(8196, 1 << 13)(*args)[1])
    check(not ok[:-1].any() and bool(ok[-1]), "corrupt battery: ok flags wrong")
    rng = np.random.default_rng(0)
    fuzz = [rng.integers(0, 256, int(rng.integers(1, 60))).astype(np.uint8).tobytes() for _ in range(512)]
    compare_decoders("fuzzed streams", fuzz, list(rng.integers(0, 300, 512)), 256, 67, card, False)

    # The merged-segment bucket: a >64 KiB segment with a wide COPY_4.
    big = rng.integers(0, 256, 70_000).astype(np.uint8).tobytes()
    body = bytes([62 << 2]) + (len(big) - 1).to_bytes(3, "little") + big
    body += bytes([(63 << 2) | 3]) + (66_000).to_bytes(4, "little") + bytes([3 << 2]) + b"tail"
    compare_decoders("merged segment 1<<17", [body], [70_068], 1 << 17, -(-(len(body) + 4) // 512) * 512, card, False)

    # Corpus batches at bench's batch and at the full stream.
    n_all = len(data) // BLOCK_SIZE
    for nb in sorted({min(128, n_all), n_all}):
        bodies, ulens, cmax = block_batch(data, nb)
        args = compare_decoders(f"corpus batch {nb}x64KiB", bodies, ulens, BLOCK_SIZE, cmax, card, True)
        if nb == n_all:
            for name, mod in (("decode_xla", decode_xla), ("decode_cuda", decode_cuda)):
                mem = mod.decode_blocks_jit(cmax, BLOCK_SIZE).lower(*args).compile().memory_analysis()
                log(f"memory_analysis {name} {nb} blocks: {mem}")

    # encode_xla, the only device encoder.
    for nb in sorted({16, min(128, n_all)}):
        buf = np.zeros((nb, BLOCK_SIZE + encode_xla.ENC_PAD), np.uint8)
        buf[:, :BLOCK_SIZE] = np.frombuffer(data[: nb * BLOCK_SIZE], np.uint8).reshape(nb, BLOCK_SIZE)
        eargs = (jax.device_put(buf), jax.device_put(np.full(nb, BLOCK_SIZE, np.int32)))
        enc = encode_xla.encode_blocks_jit(nb)
        out, olens = (np.asarray(a) for a in enc(*eargs))
        te = median_seconds(enc, *eargs)
        for i in range(0, nb, max(nb // 8, 1)):
            stream = varint.encode32(BLOCK_SIZE) + out[i, : olens[i]].tobytes()
            check(nat.uncompress(stream) == data[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE], f"encode_xla block {i} wrong")
        log(f"encode_xla {nb}x64KiB: {te * 1e3:.3f} ms ({nb * BLOCK_SIZE / te / 1e9:.2f} GB/s), sampled blocks decode bit-exact [{card}]")
        if nb == 128:
            log(f"memory_analysis encode_xla {nb} blocks: {enc.lower(*eargs).compile().memory_analysis()}")

    # End to end: the raw fast path on the whole stream, CUDA vs XLA decoder.
    stream = np.frombuffer(nat.compress(data), np.uint8)
    ulen, start = varint.parse32(stream, 0)
    for rnd in range(2):
        for name, factory in (("decode_cuda", None), ("decode_xla", decode_xla.decode_blocks_jit)):
            check(xh._uncompress_blocked(stream, ulen, start, factory) == data, f"end-to-end {name} mismatch")
            t = median_seconds(xh._uncompress_blocked, stream, ulen, start, factory)
            log(f"end to end raw uncompress {len(data) >> 20} MiB via {name} (round {rnd}): {t * 1e3:.1f} ms ({len(data) / t / 1e9:.2f} GB/s) [{card}]")
    import snappy_tpu

    stream_bytes = stream.tobytes()
    check(snappy_tpu.uncompress(stream_bytes, backend="xla") == data, "public uncompress mismatch")
    t = median_seconds(snappy_tpu.uncompress, stream_bytes, "xla")
    log(f"end to end snappy_tpu.uncompress(backend='xla') {len(data) >> 20} MiB: {t * 1e3:.1f} ms ({len(data) / t / 1e9:.2f} GB/s) [{card}]")


def one_card(mib: int) -> dict:
    import jax

    from snappy_tpu.utils import cache

    cache.enable()
    dev = gpu_device()
    card = card_line()
    log(f"device: {dev.platform} {dev.device_kind}, {len(jax.devices())} visible")
    build_libraries()
    data = corpus(mib)
    phase_raw(data)
    phase_framed(data)
    phase_streaming(data)
    phase_kernels(data, card)
    log(f"card: {card}")
    return {"platform": dev.platform, "kind": dev.device_kind, "count": 1}


# ---------------------------------------------------------------- four cards


def mesh_child(mib: int, workdir: str) -> None:
    """One process on all four cards: the sharded block codec."""
    import jax
    import numpy as np

    import snappy_tpu
    from snappy_tpu.core.constants import BLOCK_SIZE
    from snappy_tpu.ops import decode_xla, encode_xla, select
    from snappy_tpu.parallel import distributed, framed
    from snappy_tpu.parallel.host import _bucket_cmax, pack_rows
    from snappy_tpu.utils import cache

    cache.enable()
    dev = gpu_device()
    check(len(jax.devices()) >= 4, f"need 4 GPUs, found {len(jax.devices())}")
    mesh = distributed.mesh_1d(jax.devices()[:4])
    data = corpus(mib)
    n = len(data) // BLOCK_SIZE
    inp = np.frombuffer(data, np.uint8)
    buf = np.zeros((n, BLOCK_SIZE + encode_xla.ENC_PAD), np.uint8)
    buf[:, :BLOCK_SIZE] = inp.reshape(n, BLOCK_SIZE)
    blens = np.full(n, BLOCK_SIZE, np.int32)
    for gather in (False, True):
        out, olens = distributed.compress_blocks(buf, blens, mesh, gather=gather)
        out, olens = np.asarray(out), np.asarray(olens)
        streams = [out[i, : olens[i]].tobytes() for i in range(n)]
        cmax = _bucket_cmax(int(olens.max())) + decode_xla.COMP_PAD
        comp = np.zeros((n, cmax), np.uint8)
        pack_rows(out.reshape(-1), np.arange(n) * out.shape[1], olens, comp)
        dec, ok, total = distributed.decompress_blocks(comp, olens, blens, mesh, BLOCK_SIZE, gather=gather)
        check(bool(np.asarray(ok).all()), f"sharded decode flagged corrupt (gather={gather})")
        check(np.asarray(dec).tobytes() == data, f"sharded round trip mismatch (gather={gather})")
        # The sharded frame must decode under the single-device path.
        frame = framed.build_frame(streams, [data[i * BLOCK_SIZE : (i + 1) * BLOCK_SIZE] for i in range(n)], len(data))
        check(snappy_tpu.uncompress_framed(frame) == data, f"sharded frame fails the single-device decode (gather={gather})")
        log(
            f"mesh (4 cards, gather={gather}): {n} blocks encoded and decoded bit-exact; frame decodes on one device; "
            f"kernels encode_{select.encoder_name()}, decode_{select.decoder_name()}"
        )
    t0 = time.perf_counter()
    frame = snappy_tpu.compress_framed(data, mesh=mesh)
    check(snappy_tpu.uncompress_framed(frame, mesh=mesh) == data, "mesh framed round trip mismatch")
    check(snappy_tpu.uncompress_framed(frame) == data, "mesh frame fails the single-device decode")
    log(f"mesh framed: compress_framed/uncompress_framed(mesh=4 cards) bit-exact, frame decodes on one device ({time.perf_counter() - t0:.2f} s)")
    with open(os.path.join(workdir, "input.bin"), "wb") as f:  # the multihost processes' input
        f.write(data)
    with open(os.path.join(workdir, "mesh_device.json"), "w") as f:
        json.dump({"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}, f)


def host_child(coordinator: str, pid: int, workdir: str) -> None:
    """One of four processes, each on its own card (multihost drivers)."""
    import jax

    # Join before importing snappy_tpu: its modules put constant tables on
    # the device at import. Each process takes one card.
    jax.distributed.initialize(coordinator_address=coordinator, num_processes=4, process_id=pid, local_device_ids=[pid])
    from snappy_tpu.parallel import multihost
    from snappy_tpu.utils import cache

    cache.enable()

    gpu_device()
    check(jax.process_count() == 4 and len(jax.local_devices()) == 1, "expected 4 processes with one card each")
    mesh = multihost.global_mesh()
    src = os.path.join(workdir, "input.bin")
    frame = os.path.join(workdir, "multihost.frame")
    out = os.path.join(workdir, "multihost.out")
    multihost.compress_framed(src, frame, mesh=mesh)
    multihost.uncompress_framed(frame, out, mesh=mesh)
    if pid == 0:
        import snappy_tpu

        with open(frame, "rb") as f, open(src, "rb") as g:
            check(snappy_tpu.uncompress_framed(f.read()) == g.read(), "multihost frame fails the single-device decode")
    log(f"multihost process {pid}: compress_framed + uncompress_framed done on {jax.local_devices()[0]}")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def four_cards(mib: int) -> dict:
    import shutil

    workdir = os.path.join(REPO, ".smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        me = [sys.executable, os.path.abspath(__file__)]
        subprocess.run([*me, "--mesh-child", workdir, "--mib", str(mib)], check=True, timeout=1500)
        with open(os.path.join(workdir, "mesh_device.json")) as f:
            device = json.load(f)
        check(device["count"] == 4, f"mesh child saw {device['count']} cards")
        with open(os.path.join(workdir, "input.bin"), "rb") as f:
            data = f.read()
        coordinator = f"localhost:{free_port()}"
        procs = [
            subprocess.Popen([*me, "--host-child", workdir, "--coordinator", coordinator, "--pid", str(i)])
            for i in range(4)
        ]
        try:
            rcs = [p.wait(timeout=1500) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(rcs == [0, 0, 0, 0], f"multihost processes exited {rcs}")
        with open(os.path.join(workdir, "multihost.out"), "rb") as f:
            check(f.read() == data, "multihost output differs from the input")
        log(f"multihost (4 processes x 1 card): output file bit-exact ({len(data)} B)")
        log(f"card: {card_line()}")
        return device
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mib", type=int, default=64, help="stream size in MiB (64 KiB blocks)")
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--mesh-child", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--host-child", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", help=argparse.SUPPRESS)
    ap.add_argument("--pid", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_child:
        mesh_child(args.mib, args.mesh_child)
        return
    if args.host_child:
        host_child(args.coordinator, args.pid, args.host_child)
        return
    device = four_cards(args.mib) if args.cards == 4 else one_card(args.mib)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
