"""snappy_tpu: a Snappy codec framework on JAX/XLA, with a CUDA block decoder.

A from-scratch reimplementation of the Snappy compression format
(capability parity with the reference Snappy.jl; see SURVEY.md) built for
an accelerator: block-parallel XLA kernels for encode/decode and a CUDA
block decoder on NVIDIA GPUs, a framed container for embarrassingly-parallel
and distributed codec paths, plus a scalar CPU oracle and a native C++
runtime for host-side work.

Public API (mirrors reference src/Snappy.jl:3-5,20-93):
  - compress(data) -> bytes              raw snappy stream
  - uncompress(data) -> bytes            decode raw snappy stream
  - max_compressed_length(n) -> int
  - uncompressed_length(data) -> (n, header_len)
"""

from .api import compress, uncompress
from .parallel import compress_framed, mesh_1d, uncompress_framed
from .core import (
    CodecConfig,
    CorruptInputError,
    FrameConfig,
    InputTooLargeError,
    SnappyError,
    max_compressed_length,
)
from .cpu.oracle import uncompressed_length

__version__ = "0.1.0"

__all__ = [
    "CodecConfig",
    "CorruptInputError",
    "FrameConfig",
    "InputTooLargeError",
    "SnappyError",
    "compress",
    "compress_framed",
    "max_compressed_length",
    "mesh_1d",
    "uncompress",
    "uncompress_framed",
    "uncompressed_length",
]
