"""Top-level codec API with backend dispatch.

``compress``/``uncompress`` accept bytes-like input and pick a backend:

  - "cpu"    scalar NumPy oracle (always available, ground truth)
  - "native" C++ shared library (fast host path)
  - "xla"    JAX device path (kernels from ops/select.py: the CUDA block
             decoder and encode_xla on a GPU, the XLA codecs on CPU)
  - None     best available: native for host calls, falling back to cpu

The device path is exposed both here (host convenience, includes host<->device
transfer) and as jittable functions in :mod:`snappy_tpu.ops` for callers
composing larger device programs.
"""

from __future__ import annotations

from .cpu import oracle


def _backend_funcs(backend: str | None):
    if backend in (None, "native"):
        try:
            from .native import runtime as native_runtime

            if native_runtime.available():
                return native_runtime.compress, native_runtime.uncompress
        except Exception:
            if backend == "native":
                raise
    if backend == "xla":
        from .ops import host as xla_host

        return xla_host.compress, xla_host.uncompress
    return oracle.compress, oracle.uncompress


def compress(data, backend: str | None = None) -> bytes:
    """Compress ``data`` into a raw Snappy stream."""
    c, _ = _backend_funcs(backend)
    return c(data)


def uncompress(data, backend: str | None = None) -> bytes:
    """Decode a raw Snappy stream produced by any conformant encoder."""
    _, u = _backend_funcs(backend)
    return u(data)
