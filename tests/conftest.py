"""Test harness config.

Forces JAX onto a virtual 8-device CPU platform *before* jax initialises a
backend, so multi-device shard_map/collective paths are exercised without
an accelerator (SURVEY.md §4: mirror of the reference's single-host CI,
plus the multi-device simulation the reference lacks). Tests marked
``gpu`` need the card; they skip here (see ``gpu_platform``) and run on a
GPU machine with ``python -m pytest -m gpu -p no:xdist tests/test_gpu_kernels.py``,
where ``SNAPPY_TEST_GPU=1`` keeps the real platform.
"""

import os

import jax

if os.environ.get("SNAPPY_TEST_GPU", "0") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

TESTDATA = os.path.join(os.path.dirname(__file__), "..", "testdata")

CORPUS_FILES = [
    "alice29.txt",
    "asyoulik.txt",
    "html",
    "html_x_4",
    "kppkn.gtb",
    "lcet10.txt",
    "fireworks.jpeg",
    "geo.protodata",
    "paper-100k.pdf",
    "plrabn12.txt",
    "urls.10K",
    "random1.bin",
    "random2.bin",
    "random3.bin",
    "smallrandom1.bin",
    "sample-tweet.json",
]

# Small mixed subset for tests where the slow scalar oracle is the encoder.
CORPUS_SMALL = ["html", "fireworks.jpeg", "paper-100k.pdf", "sample-tweet.json", "smallrandom1.bin"]


@pytest.fixture(scope="session")
def testdata_dir():
    assert os.path.isdir(TESTDATA), f"missing corpus at {TESTDATA}"
    return TESTDATA


def read_testdata(name: str) -> bytes:
    with open(os.path.join(TESTDATA, name), "rb") as f:
        return f.read()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0x5EED)


@pytest.fixture
def gpu_platform():
    """Skip unless JAX's default device is a GPU (decided per test, never at
    import, so every xdist worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run with SNAPPY_TEST_GPU=1 -m gpu on the card")
    return jax.devices()[0]
