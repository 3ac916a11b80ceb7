"""Kernel selection: the one place a block codec kernel is chosen.

Shared by the single-device and the mesh-sharded (shard_map) drivers, so
both run the same kernel. Keyed on the platform of ``jax.devices()[0]``
alone:

  gpu   the CUDA block decoder (decode_cuda) and encode_xla
  cpu   decode_xla and encode_xla
  other an error: there is no kernel for it.
"""

from __future__ import annotations

from . import decode_cuda, decode_xla, encode_xla

PLATFORMS = ("gpu", "cpu")


def platform() -> str:
    import jax

    return jax.devices()[0].platform


def _checked(plat: str | None) -> str:
    plat = platform() if plat is None else plat
    if plat not in PLATFORMS:
        raise RuntimeError(f"no codec kernels for platform {plat!r} (supported: {', '.join(PLATFORMS)})")
    return plat


def decoder_name(plat: str | None = None) -> str:
    """Name of the block decoder: "cuda" or "xla"."""
    return "cuda" if _checked(plat) == "gpu" else "xla"


def encoder_name(plat: str | None = None) -> str:
    """Name of the block encoder: "xla" on every supported platform."""
    _checked(plat)
    return "xla"


def block_decoder(cmax_padded: int, out_size: int):
    """Block decoder for the current platform.

    (comp u8[B, cmax_padded], clens i32[B], ulens i32[B]) ->
    (out u8[B, out_size], ok bool[B], total i32[B]).
    """
    if decoder_name() == "cuda":
        return decode_cuda.decode_blocks_jit(cmax_padded, out_size)
    return decode_xla.decode_blocks_jit(cmax_padded, out_size)


def block_encoder(n_blocks: int):
    """Block encoder for the current platform:
    (blocks u8[B, BLOCK_SIZE + ENC_PAD], blens i32[B]) ->
    (out u8[B, BLOCK_MAX_OUT], olens i32[B])."""
    encoder_name()
    return encode_xla.encode_blocks_jit(n_blocks)
