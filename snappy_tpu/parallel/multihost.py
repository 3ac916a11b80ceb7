"""Multi-host framed codec drivers (SURVEY.md §5 distributed backend,
§7 step 6).

The reference is strictly single-threaded (reference src/Snappy.jl); here
the framed container's block independence scales past one host: every
process reads only its DISJOINT byte range of the input, all processes
run the SAME shard_map codec program over the GLOBAL device mesh, and
the frame is assembled without serializing the payload through one host:

  compress:   per-process local read + sharded encode -> allgather of the
              per-block compressed lengths (+ crcs), the ONLY cross-host
              exchange: 4-8 B/block between hosts -> every process computes its
              payload byte offsets from the global index and pwrites its
              own slice; process 0 writes the header + index.
  decompress: every process reads the (tiny) frame index plus ONLY its own
              payload byte range, decodes its block range, and pwrites its
              output slice at block_size offsets. No collective at all —
              ordering falls out of the index.

Note: the single-host framed path content-routes incompressible blocks to
the host-native encoder (ops/route.py); the mesh-sharded path here keeps
every block on-device (per-host routing across a shard_map boundary is
future work), so a frame containing incompressible blocks may differ
byte-wise between the two paths — both are valid, gate-equal streams.

Call :func:`initialize` once per process before using these drivers
(wraps jax.distributed.initialize; works across real pods and localhost
CPU process groups alike — tests/test_multihost.py runs exactly this with
two CPU processes and asserts byte equality with the single-process frame).

**Filesystem requirement:** ``in_path``/``out_path`` must live on a
filesystem shared by ALL processes (NFS/GCS-fuse/parallel FS — the normal
cluster arrangement, and what the localhost tests use). Each process pwrites
only its own slice; on per-host local disks every host would end up with
a silently incomplete file. After the final barrier every process
re-parses the header+index from disk, and process 0 decodes a sampled
block from each peer's payload slice — so the per-host-local-disk
misconfiguration fails loudly on every process (peers see no header;
process 0 sees undecodable peer payload).
"""

from __future__ import annotations

import os
import zlib

import numpy as np

import jax
from jax.experimental import multihost_utils
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core.config import DEFAULT_FRAME_CONFIG, FrameConfig
from ..core.errors import CorruptInputError
from ..ops import decode_xla
from . import distributed, framed
from .host import _blockify, _bucket, _bucket_cmax


def initialize(coordinator_address: str, num_processes: int, process_id: int, **kw) -> None:
    """Join the multi-host process group (jax.distributed under the hood).

    Each host then sees the GLOBAL device set via jax.devices() and builds
    the same mesh; jax.local_devices() are the devices this process feeds."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kw,
    )


def global_mesh(axis: str = distributed.AXIS):
    """1-D mesh over ALL processes' devices (block data-parallel)."""
    return distributed.mesh_1d(jax.devices(), axis)


def _my_block_range(nb_padded: int, mesh) -> tuple[int, int]:
    """The contiguous block range this process owns under P(AXIS) sharding
    of a length-nb_padded leading axis (blocks lay out in device order, so
    the range is exactly the blocks of this process's local devices)."""
    n_dev = mesh.devices.size
    per_dev = nb_padded // n_dev
    devs = list(mesh.devices.reshape(-1))
    mine = [i for i, d in enumerate(devs) if d.process_index == jax.process_index()]
    if max(mine) - min(mine) + 1 != len(mine):
        # Non-contiguous device enumeration would silently claim other
        # processes' blocks and desynchronize file I/O from the sharding.
        raise RuntimeError(
            "multihost drivers require each process's devices to be "
            f"contiguous in mesh order; process {jax.process_index()} owns "
            f"mesh positions {mine}"
        )
    return min(mine) * per_dev, (max(mine) + 1) * per_dev


def _shard_in(local_np: np.ndarray, global_rows: int, mesh):
    sharding = NamedSharding(mesh, P(distributed.AXIS))
    return jax.make_array_from_process_local_data(
        sharding, local_np, (global_rows,) + local_np.shape[1:]
    )


def _local_rows(garr) -> np.ndarray:
    """This process's rows of a P(AXIS)-sharded global array, in order."""
    shards = sorted(garr.addressable_shards, key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)


def _allgather_rows(local_np: np.ndarray) -> np.ndarray:
    """Concatenate equal-shaped per-process host values in process order
    (the cross-host exchange; 4-8 bytes per block in practice)."""
    return np.asarray(multihost_utils.process_allgather(local_np, tiled=True))


def compress_framed(
    in_path: str,
    out_path: str,
    mesh=None,
    config: FrameConfig = DEFAULT_FRAME_CONFIG,
) -> int:
    """Multi-host framed compress: every process encodes its disjoint block
    range of ``in_path`` and pwrites its frame slice of ``out_path``.
    Returns the total frame size (same value on every process)."""
    mesh = global_mesh() if mesh is None else mesh
    bs = config.block_size
    total_len = os.path.getsize(in_path)
    n_blocks = -(-total_len // bs) if total_len else 0
    nb = distributed.pad_block_count(max(_bucket(max(n_blocks, 1)), 1), mesh.devices.size)
    lo, hi = _my_block_range(nb, mesh)

    # per-host I/O: read ONLY this process's byte range
    with open(in_path, "rb") as f:
        f.seek(lo * bs)
        local = np.frombuffer(f.read((hi - lo) * bs), np.uint8)
    buf, blens = _blockify(local, bs, hi - lo)

    gbuf = _shard_in(buf, nb, mesh)
    glens = _shard_in(blens.astype(np.int32), nb, mesh)
    out, olens = distributed._sharded_encode(mesh, False)(gbuf, glens)

    local_out = _local_rows(out)
    local_olens = _local_rows(olens)
    n_local = max(0, min(hi, n_blocks) - lo)
    streams = [local_out[i, : local_olens[i]].tobytes() for i in range(n_local)]
    local_crcs = np.zeros(hi - lo, np.uint32)
    for i in range(n_local):
        local_crcs[i] = zlib.crc32(local[i * bs : i * bs + int(blens[i])].tobytes())

    # The cross-host exchange: per-block compressed lengths (+ crcs).
    all_olens = _allgather_rows(local_olens.astype(np.int32))[:n_blocks]
    all_crcs = _allgather_rows(local_crcs.view(np.int32))[:n_blocks] if config.checksum else None

    header = framed.build_frame_header(
        [int(x) for x in all_olens],
        [int(np.uint32(c)) for c in all_crcs] if all_crcs is not None else None,
        total_len,
        config,
    )
    offsets = len(header) + np.concatenate([[0], np.cumsum(all_olens)]).astype(np.int64)
    frame_size = int(offsets[-1]) if n_blocks else len(header)

    fd = os.open(out_path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        os.ftruncate(fd, frame_size)
        if jax.process_index() == 0:
            os.pwrite(fd, header, 0)
        for i, s in enumerate(streams):
            os.pwrite(fd, s, int(offsets[lo + i]))
    finally:
        os.close(fd)
    multihost_utils.sync_global_devices("snappy_tpu.multihost.compress")
    # Post-write verification (after the barrier, so every process has
    # written). The size check alone cannot catch a non-shared filesystem
    # (every process ftruncates its local file to frame_size), so the check
    # is cross-process both ways:
    #   - EVERY process re-reads and parses the header+index from disk —
    #     on per-host local disks, processes != 0 see ftruncate zeros where
    #     process 0's header should be and fail loudly;
    #   - process 0 additionally decodes one sampled block from each OTHER
    #     process's payload slice with the CPU oracle and checks its length
    #     (+ crc when enabled) — actual peer payload bytes, not metadata.
    if os.path.getsize(out_path) != frame_size:
        raise RuntimeError(
            f"assembled frame {out_path} is {os.path.getsize(out_path)} "
            f"bytes, expected {frame_size}: are all processes writing "
            "to the same (shared) filesystem?"
        )
    with open(out_path, "rb") as vf:
        framed.parse_index(vf.read(len(header)), require_payload=False)
    if jax.process_index() == 0 and n_blocks:
        from ..core import varint
        from ..cpu import oracle

        per_dev = nb // mesh.devices.size
        first_block: dict[int, int] = {}
        for pos, d in enumerate(mesh.devices.reshape(-1)):
            first_block.setdefault(d.process_index, pos * per_dev)
        with open(out_path, "rb") as vf:
            for p, blk in sorted(first_block.items()):
                if p == jax.process_index() or blk >= n_blocks:
                    continue
                vf.seek(int(offsets[blk]))
                stream = vf.read(int(all_olens[blk]))
                ulen = min(bs, total_len - blk * bs)
                try:
                    out_blk = oracle.uncompress(varint.encode32(ulen) + stream)
                except Exception as e:
                    raise RuntimeError(
                        f"payload slice of process {p} (block {blk}) does not "
                        f"decode ({e}): are all processes writing to the same "
                        "(shared) filesystem?"
                    ) from e
                if len(out_blk) != ulen or (
                    all_crcs is not None
                    and zlib.crc32(out_blk) != int(np.uint32(all_crcs[blk]))
                ):
                    raise RuntimeError(
                        f"payload slice of process {p} (block {blk}) decodes "
                        "to wrong content: are all processes writing to the "
                        "same (shared) filesystem?"
                    )
    return frame_size


def uncompress_framed(in_path: str, out_path: str, mesh=None) -> int:
    """Multi-host framed decompress: every process reads only its payload
    byte range, decodes its block range, and pwrites its output slice.
    Returns total uncompressed length."""
    mesh = global_mesh() if mesh is None else mesh
    with open(in_path, "rb") as f:
        head = f.read(framed._HEADER.size)
        if len(head) < framed._HEADER.size:
            raise CorruptInputError("frame too short")
        magic, flags, block_size, total_len, n_blocks = framed._HEADER.unpack(head)
        index_bytes = 4 * n_blocks * (2 if flags & framed.FLAG_CRC else 1)
        index = f.read(index_bytes)
        idx = framed.parse_index(head + index, require_payload=False)
        if n_blocks == 0:
            if jax.process_index() == 0:
                open(out_path, "wb").close()
            multihost_utils.sync_global_devices("snappy_tpu.multihost.uncompress")
            return 0
        nb = distributed.pad_block_count(max(_bucket(n_blocks), 1), mesh.devices.size)
        lo, hi = _my_block_range(nb, mesh)
        ranges = idx.block_ranges()
        n_local = max(0, min(hi, n_blocks) - lo)
        # per-host payload I/O: only [lo, lo+n_local)'s contiguous bytes
        if n_local:
            f.seek(ranges[lo][0])
            payload = f.read(ranges[lo + n_local - 1][1] - ranges[lo][0])
            if len(payload) < ranges[lo + n_local - 1][1] - ranges[lo][0]:
                raise CorruptInputError("frame payload truncated")
        else:
            payload = b""

    cmax = _bucket_cmax(max(int(e - s) for s, e in ranges))
    comp = np.zeros((hi - lo, cmax + decode_xla.COMP_PAD), np.uint8)
    clens = np.zeros(hi - lo, np.int32)
    ulens = np.zeros(hi - lo, np.int32)
    pbuf = np.frombuffer(payload, np.uint8)
    base = ranges[lo][0] if n_local else 0
    for i in range(n_local):
        s, e = ranges[lo + i]
        comp[i, : e - s] = pbuf[s - base : e - base]
        clens[i] = e - s
        ulens[i] = idx.block_ulen(lo + i)

    out_size = _bucket(int(idx.block_size), 64)
    gcomp = _shard_in(comp, nb, mesh)
    gclens = _shard_in(clens, nb, mesh)
    gulens = _shard_in(ulens, nb, mesh)
    out, ok, _total = distributed._sharded_decode(mesh, out_size, False)(gcomp, gclens, gulens)

    ok_local = _local_rows(ok).reshape(-1)
    if not bool(ok_local[:n_local].all()):
        bad = lo + int(np.flatnonzero(~ok_local[:n_local])[0])
        raise CorruptInputError(f"corrupt framed block {bad}")
    out_local = _local_rows(out)
    blocks = [out_local[i, : idx.block_ulen(lo + i)].tobytes() for i in range(n_local)]
    framed.verify_crcs_range(idx, blocks, lo)

    fd = os.open(out_path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        os.ftruncate(fd, int(total_len))
        for i, b in enumerate(blocks):
            os.pwrite(fd, b, (lo + i) * idx.block_size)
    finally:
        os.close(fd)
    multihost_utils.sync_global_devices("snappy_tpu.multihost.uncompress")
    return int(total_len)
