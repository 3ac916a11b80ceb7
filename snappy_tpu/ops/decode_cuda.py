"""Batched block decoder in CUDA (snappy_tpu/native/decode_blocks.cu).

Same contract as :func:`decode_xla.decode_blocks_jit`, bit for bit:
``(comp u8[B, C], clens i32[B], ulens i32[B]) -> (out u8[B, out_size],
ok bool[B], total i32[B])`` with ``C = cmax + COMP_PAD``. One warp walks
each block's tags serially and moves every tag's bytes with its 32 lanes;
the block's output window lives in shared memory, which bounds
``out_size``: the FFI handler rejects shapes past its limits.

The library is compiled with nvcc at first use (or by
``python -m snappy_tpu.native.build``) and registered as an XLA FFI target
for the CUDA platform. It has no CPU or interpret mode: its tests compare
it with decode_xla on the card (``pytest -m gpu``).
"""

from __future__ import annotations

import ctypes
import functools

import jax
import jax.numpy as jnp

TARGET = "snappy_decode_blocks"


def result_shapes(n_blocks: int, out_size: int):
    return (
        jax.ShapeDtypeStruct((n_blocks, out_size), jnp.uint8),
        jax.ShapeDtypeStruct((n_blocks,), jnp.bool_),
        jax.ShapeDtypeStruct((n_blocks,), jnp.int32),
    )


def decode_blocks(comp, clens, ulens, out_size: int):
    """Trace the FFI call (the target must be registered before compiling:
    :func:`decode_blocks_jit` does that)."""
    if comp.ndim != 2 or comp.dtype != jnp.uint8:
        raise TypeError(f"comp must be uint8[B, C], got {comp.dtype}{list(comp.shape)}")
    call = jax.ffi.ffi_call(TARGET, result_shapes(comp.shape[0], out_size))
    outs = call(comp, clens.astype(jnp.int32), ulens.astype(jnp.int32))
    # Inside shard_map the results vary over the same mesh axes as the
    # blocks; saying so keeps shard_map's replication checks (check_vma) on.
    vma = tuple(jax.typeof(comp).vma)
    return tuple(jax.lax.pcast(x, vma, to="varying") for x in outs) if vma else tuple(outs)


@functools.lru_cache(maxsize=1)
def register() -> str:
    """Build (if stale) and load the library, register the FFI target."""
    from ..native import build

    lib = ctypes.cdll.LoadLibrary(build.build_cuda())
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.SnappyDecodeBlocks), platform="CUDA")
    return TARGET


@functools.lru_cache(maxsize=32)
def decode_blocks_jit(cmax_padded: int, out_size: int):
    register()

    @jax.jit
    def fn(comp_blocks, clens, ulens):
        return decode_blocks(comp_blocks, clens, ulens, out_size)

    return fn
