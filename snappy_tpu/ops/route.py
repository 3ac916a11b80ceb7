"""Content-routed block encoding: incompressible blocks bypass the device.

The reference's growing-stride skip heuristic makes incompressible input
nearly free (reference src/internal.jl:162-172): it probes sparsely and
emits one long literal. The device encoder has no such bail-out — its
kv-sort candidate prepass costs the same for jpeg as for html. Routing
mirrors the heuristic's EFFECT at block granularity:

  1. a host detector samples about 4096 4-byte grams per block and
     measures their duplicate ratio — incompressible corpus blocks (jpeg,
     the pdf's image stream) measure < 0.02, every compressible corpus
     block >= 0.23;
  2. detected blocks are compressed ON HOST by the C++ greedy encoder
     (native/snappy_native.cpp) — the same greedy algorithm as libsnappy,
     fast on incompressible data thanks to its own skip heuristic;
  3. the remaining blocks take the batched device encoder; the host
     natives run while the device dispatch is in flight (JAX dispatch is
     async), so detected blocks cost approximately nothing end-to-end.

Density stays gate-safe: routed blocks compress to exactly what libsnappy
would emit on them, and blocks with real matches stay on the device path,
which is strictly denser than libsnappy (exact kv-sort candidates).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp


#: sampled-gram duplicate ratio below which a block is treated as
#: incompressible (observed corpus gap: <= 0.017 vs >= 0.23)
DUP_THRESHOLD = 0.05
#: nominal gram sample count for the detector (stride adapts to block size)
DETECT_SAMPLES = 4096


def dup_ratios(buf: np.ndarray, blens: np.ndarray, n_blocks: int) -> np.ndarray:
    """Sampled 4-gram duplicate ratio per block.

    Uniform full-length blocks take a BATCH-vectorized path (one fancy
    gather + one row-sorted adjacent-equal count) instead of a per-block
    np.unique loop. The stride adapts so the sample count stays ~4096 (a
    fixed stride under-samples partial tails); blocks under 1 KiB never
    route — the sample is too small to trust and routing gains nothing
    there."""
    out = np.ones(n_blocks, np.float32)
    lens = blens[:n_blocks].astype(np.int64)
    big = lens >= 1024
    rest = []
    if big.any():
        # vectorize the modal length (typically every full block); loop
        # only the stragglers (partial tails)
        vals, counts = np.unique(lens[big], return_counts=True)
        modal = int(vals[np.argmax(counts)])
        uniform = np.flatnonzero(big & (lens == modal))
        rest = list(np.flatnonzero(big & (lens != modal)))
        n = modal - 3
        idx = np.arange(0, n, max(1, n >> 11))
        sub = buf[uniform]
        w = (
            sub[:, idx].astype(np.uint32)
            | (sub[:, idx + 1].astype(np.uint32) << 8)
            | (sub[:, idx + 2].astype(np.uint32) << 16)
            | (sub[:, idx + 3].astype(np.uint32) << 24)
        )
        w.sort(axis=1)
        out[uniform] = (w[:, 1:] == w[:, :-1]).mean(axis=1, dtype=np.float32)
    for i in rest:
        n = int(lens[i]) - 3
        idx = np.arange(0, n, max(1, n >> 11))
        b = buf[i]
        w = (
            b[idx].astype(np.uint32)
            | (b[idx + 1].astype(np.uint32) << 8)
            | (b[idx + 2].astype(np.uint32) << 16)
            | (b[idx + 3].astype(np.uint32) << 24)
        )
        out[i] = 1.0 - len(np.unique(w)) / len(w)
    return out


def native_available() -> bool:
    try:
        from ..native import runtime as nat

        return nat.available()
    except ImportError:
        return False


def _native_block_stream(block: bytes) -> bytes:
    """Headerless tag stream for one block via the C++ greedy encoder."""
    from ..native import runtime as nat

    s = nat.compress(block)
    _, hdr = nat.uncompressed_length(s)
    return s[hdr:]


def native_streams_for(buf: np.ndarray, blens: np.ndarray, host_idx) -> dict:
    """Compress the routed blocks on host: ONE batched native call per
    worker thread (native/runtime.py compress_rows, which saves a ctypes
    call per block), threads splitting the index range (the call
    releases the GIL, so the C++ encoders run on all cores and overlap
    the in-flight device dispatch)."""
    from ..native import runtime as nat

    idx = [int(i) for i in host_idx]
    if not idx:
        return {}
    import os as _os

    workers = min(max(_os.cpu_count() or 1, 1), 8, len(idx))
    if workers == 1:
        return dict(zip(idx, nat.compress_rows(buf, blens, idx)))
    import concurrent.futures as cf

    chunks = [idx[k::workers] for k in range(workers)]
    with cf.ThreadPoolExecutor(workers) as pool:
        outs = list(pool.map(lambda c: nat.compress_rows(buf, blens, c), chunks))
    result = {}
    for c, streams in zip(chunks, outs):
        result.update(zip(c, streams))
    return result


def dispatch_routed(buf: np.ndarray, blens: np.ndarray, n_blocks: int, encoder_for):
    """Async routed encode of ``n_blocks`` rows of (buf, blens).

    ``encoder_for(nb)`` must return the batched device encoder for a
    padded block count nb. Returns a ticket for :func:`assemble_routed`.
    The device dispatch is issued BEFORE the host natives run, so the two
    paths overlap.
    """
    if not native_available():
        host_idx = np.zeros(0, np.int64)
    else:
        ratios = dup_ratios(buf, blens, n_blocks)
        host_idx = np.flatnonzero(ratios < DUP_THRESHOLD)
    dev_idx = (
        np.setdiff1d(np.arange(n_blocks), host_idx) if len(host_idx) else np.arange(n_blocks)
    )

    ticket_dev = None
    if len(dev_idx):
        nb = 1
        while nb < len(dev_idx):
            nb <<= 1
        dbuf = np.zeros((nb,) + buf.shape[1:], buf.dtype)
        dbuf[: len(dev_idx)] = buf[dev_idx]
        dlens = np.zeros(nb, np.int32)
        dlens[: len(dev_idx)] = blens[dev_idx]
        out, olens = encoder_for(nb)(jnp.asarray(dbuf), jnp.asarray(dlens))
        ticket_dev = (out, olens)

    # host natives run while the device dispatch is in flight
    native_streams = native_streams_for(buf, blens, host_idx)
    return (ticket_dev, dev_idx, native_streams, n_blocks)


def assemble_routed(ticket) -> list[bytes]:
    """Fence the device part and return per-block tag streams in order."""
    ticket_dev, dev_idx, native_streams, n_blocks = ticket
    streams: list[bytes | None] = [None] * n_blocks
    if ticket_dev is not None:
        out, olens = ticket_dev
        out = np.asarray(out)
        olens = np.asarray(olens)
        for j, i in enumerate(dev_idx):
            streams[int(i)] = out[j, : olens[j]].tobytes()
    for i, s in native_streams.items():
        streams[i] = s
    return streams  # type: ignore[return-value]


def compress_blocks_routed(buf: np.ndarray, blens: np.ndarray, n_blocks: int, encoder_for) -> list[bytes]:
    return assemble_routed(dispatch_routed(buf, blens, n_blocks, encoder_for))
