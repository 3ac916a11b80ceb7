"""Multi-device / multi-host block-parallel codec (Mesh + shard_map).

The reference has no parallelism of any kind (SURVEY.md §2); the format's
own 64 KiB block independence (reference src/Snappy.jl:29-33) is what this
module promotes to the scaling axis: blocks shard data-parallel over a 1-D
device mesh, each device runs the selected codec kernels (ops/select.py) on
its local blocks, and the ordered concatenation of framed outputs falls out
of the global array layout (or an explicit ordered ``lax.all_gather`` when
the result must be device-resident). The mesh follows the algorithm only:
blocks need no communication, so its layout says nothing about topology.

Multi-host: ``jax.distributed.initialize()`` + per-host I/O of disjoint
block ranges; the same shard_map program then spans every process's
devices, with XLA's collectives (NCCL on GPUs) carrying the gather.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import select

AXIS = "blocks"


def mesh_1d(devices=None, axis: str = AXIS) -> Mesh:
    """1-D device mesh over the block (data-parallel) axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def pad_block_count(n_blocks: int, n_devices: int) -> int:
    """Blocks are padded to a multiple of the mesh size; empty blocks
    (blen==0) encode/decode to nothing."""
    return -(-n_blocks // n_devices) * n_devices


@functools.lru_cache(maxsize=16)
def _sharded_encode(mesh: Mesh, gather: bool):
    """shard_map'd batched encoder over the block axis.

    gather=False: outputs stay sharded (host assembles in index order —
    order is by construction, no collective needed).
    gather=True: ordered all_gather so every device holds the full framed
    output (device-resident pipelines).

    shard_map checks replication (check_vma) on the sharded path. With
    gather=True it cannot: ``jax.lax.all_gather`` is typed varying ->
    varying, so the replicated P() out_specs are true of the values but not
    inferable from their types.
    """

    def local(blocks, blens):
        out, olens = select.block_encoder(blocks.shape[0])(blocks, blens)
        if gather:
            out = jax.lax.all_gather(out, AXIS, tiled=True)
            olens = jax.lax.all_gather(olens, AXIS, tiled=True)
        return out, olens

    spec_in = P(AXIS)
    spec_out = P() if gather else P(AXIS)
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=(spec_in, spec_in), out_specs=(spec_out, spec_out), check_vma=not gather
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=16)
def _sharded_decode(mesh: Mesh, out_size: int, gather: bool):
    """shard_map'd batched decoder: each device runs the selected kernel
    (the CUDA decoder's FFI call included) on its local blocks."""

    def local(comp, clens, ulens):
        dec = select.block_decoder(comp.shape[1], out_size)
        out, ok, total = dec(comp, clens, ulens)
        if gather:
            out = jax.lax.all_gather(out, AXIS, tiled=True)
            ok = jax.lax.all_gather(ok, AXIS, tiled=True)
            total = jax.lax.all_gather(total, AXIS, tiled=True)
        return out, ok, total

    spec_in = P(AXIS)
    spec_out = P() if gather else P(AXIS)
    fn = jax.shard_map(
        local, mesh=mesh, in_specs=(spec_in, spec_in, spec_in), out_specs=(spec_out, spec_out, spec_out),
        check_vma=not gather,  # see _sharded_encode
    )
    return jax.jit(fn)


def _device_put_sharded(arr: np.ndarray, mesh: Mesh) -> jax.Array:
    return jax.device_put(arr, NamedSharding(mesh, P(AXIS)))


def compress_blocks(
    blocks: np.ndarray,
    blens: np.ndarray,
    mesh: Mesh,
    gather: bool = False,
):
    """Encode a [NB, BLOCK_SIZE+ENC_PAD] batch sharded over ``mesh``.

    NB must be a multiple of the mesh size (see pad_block_count).
    Returns (out [NB, BLOCK_MAX_OUT], olens [NB]) — sharded, or replicated
    if gather=True.
    """
    fn = _sharded_encode(mesh, gather)
    return fn(_device_put_sharded(blocks, mesh), _device_put_sharded(blens.astype(np.int32), mesh))


def decompress_blocks(
    comp: np.ndarray, clens: np.ndarray, ulens: np.ndarray, mesh: Mesh, out_size: int, gather: bool = False
):
    """Decode a [NB, Cmax+COMP_PAD] batch of headerless block streams
    sharded over ``mesh``."""
    fn = _sharded_decode(mesh, out_size, gather)
    return fn(
        _device_put_sharded(comp, mesh),
        _device_put_sharded(clens.astype(np.int32), mesh),
        _device_put_sharded(ulens.astype(np.int32), mesh),
    )


def initialize_multihost(**kwargs) -> None:
    """Multi-host entry: call once per host before building the mesh
    (wraps jax.distributed.initialize; coordinator/process args as in JAX).
    Each host then reads its disjoint byte range and participates in the
    same shard_map program."""
    jax.distributed.initialize(**kwargs)
