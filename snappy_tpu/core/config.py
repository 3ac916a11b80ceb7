"""Runtime configuration.

The reference has compile-time tunables only (reference src/internal.jl:6-7,
31-33). Here the same defaults live in a frozen dataclass so the block size,
frame options and mesh shape are explicit, hashable (usable as jit static
args), and overridable per call.
"""

from __future__ import annotations

import dataclasses

from .constants import BLOCK_SIZE, INPUT_MARGIN_BYTES, MAX_HASH_TABLE_SIZE


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Tunables for the codec. Defaults mirror the reference/libsnappy."""

    # Uncompressed bytes per independently-compressed block
    # (reference src/internal.jl:31). Must be <= 65536: offsets are 16-bit.
    block_size: int = BLOCK_SIZE
    # Largest LZ hash table (reference src/internal.jl:33).
    max_hash_table_size: int = MAX_HASH_TABLE_SIZE
    # Fast-path overread margin (reference src/internal.jl:32).
    input_margin: int = INPUT_MARGIN_BYTES
    # Cap on vectorized match extension in the device encoder. Matches longer
    # than this are split into back-to-back copies at the same offset, which
    # re-chunk to the identical tag sequence the reference's 64-byte chunking
    # produces (reference src/internal.jl:316-326), so density is unaffected.
    max_match_scan: int = 512

    def __post_init__(self) -> None:
        if not 1 <= self.block_size <= 1 << 16:
            raise ValueError("block_size must be in [1, 65536]")


DEFAULT_CONFIG = CodecConfig()


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Options for the framed container (snappy_tpu-specific, §parallel).

    The raw snappy stream is a single sequential tag stream; the framed
    container records per-block compressed sizes + checksums so that decode
    (and distributed decode) is embarrassingly parallel and resumable.
    """

    block_size: int = BLOCK_SIZE
    checksum: bool = True


DEFAULT_FRAME_CONFIG = FrameConfig()
