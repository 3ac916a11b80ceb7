"""Build the native libraries: the C++ host codec and the CUDA block decoder.

Invoked automatically on first use (snappy_tpu.native.runtime,
snappy_tpu.ops.decode_cuda) or manually:

    python -m snappy_tpu.native.build   # C++ codec, then CUDA when nvcc exists

Each library is a single translation unit with no dependencies, so the
compilers are called directly. Outputs are ``*.so`` next to the sources,
which .gitignore lists.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "snappy_native.cpp")
_LIB = os.path.join(_DIR, "_snappy_native.so")
_CUDA_SRC = os.path.join(_DIR, "decode_blocks.cu")
_CUDA_LIB = os.path.join(_DIR, "_decode_blocks_cuda.so")

CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native", "-fno-exceptions", "-fno-rtti", "-Wall"]
# sm_90a: Hopper's own target (plain sm_90 refuses its arch-specific instructions).
NVCCFLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]


def lib_path() -> str:
    return _LIB


def _stale(lib: str, src: str) -> bool:
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def is_stale() -> bool:
    return _stale(_LIB, _SRC)


def _compile(cmd_prefix: list[str], src: str, lib: str, what: str) -> None:
    # Build to a temp file then rename: atomic w.r.t. concurrent importers.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib))
    os.close(fd)
    try:
        proc = subprocess.run([*cmd_prefix, src, "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{what} build failed:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build(force: bool = False, quiet: bool = True) -> str:
    """Compile the C++ host codec if missing or stale; returns its path."""
    if force or is_stale():
        _compile(["g++", *CXXFLAGS], _SRC, _LIB, "native")
        if not quiet:
            print(f"built {_LIB}", file=sys.stderr)
    return _LIB


def nvcc() -> str | None:
    """Path of nvcc: on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def build_cuda(force: bool = False, quiet: bool = True) -> str:
    """Compile the CUDA block decoder if missing or stale; returns its path.

    Raises RuntimeError when nvcc is missing or the build fails."""
    if not force and not _stale(_CUDA_LIB, _CUDA_SRC):
        return _CUDA_LIB
    compiler = nvcc()
    if compiler is None:
        raise RuntimeError("nvcc not found: the CUDA block decoder cannot be built")
    import jax.ffi

    _compile([compiler, *NVCCFLAGS, "-I", jax.ffi.include_dir()], _CUDA_SRC, _CUDA_LIB, "CUDA")
    if not quiet:
        print(f"built {_CUDA_LIB}", file=sys.stderr)
    return _CUDA_LIB


if __name__ == "__main__":
    force = "--force" in sys.argv
    build(force=force, quiet=False)
    if nvcc() is not None:
        build_cuda(force=force, quiet=False)
    else:
        print("nvcc not found: skipped the CUDA block decoder", file=sys.stderr)
