"""Multi-host codec tests: a REAL 2-process jax.distributed group on CPU
(localhost coordinator), asserting the 2-process frame and roundtrip equal
the single-process results byte-for-byte (SURVEY.md §7 step 6)."""

import os
import socket
import subprocess
import sys

import pytest

from conftest import read_testdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_frame_matches_single_process(tmp_path):
    raw = read_testdata("urls.10K") + read_testdata("html_x_4")  # ~1.1 MB, 17 blocks
    in_path = tmp_path / "in.bin"
    in_path.write_bytes(raw)

    port = _free_port()
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": REPO,
    }
    env.pop("PYTHONSTARTUP", None)
    procs = []
    for pid in range(2):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    os.path.join(REPO, "tests", "multihost_worker.py"),
                    f"127.0.0.1:{port}",
                    "2",
                    str(pid),
                    str(in_path),
                    str(tmp_path / "mh.frame"),
                    str(tmp_path / "mh.out"),
                ],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            )
        )
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        logs.append(out.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"

    # roundtrip correctness
    assert (tmp_path / "mh.out").read_bytes() == raw

    # byte equality with the single-process (4-virtual-device) frame: the
    # frame layout is a pure function of (data, config), not of how many
    # processes produced it.
    import snappy_tpu

    single = snappy_tpu.compress_framed(raw)
    assert (tmp_path / "mh.frame").read_bytes() == single

    # and the single-process decoder accepts the multi-host frame
    assert snappy_tpu.uncompress_framed((tmp_path / "mh.frame").read_bytes()) == raw


@pytest.mark.slow
@pytest.mark.parametrize(
    "nprocs,n_bytes",
    [
        (2, 5 * 65536 + 777),  # odd block count + partial tail block
        (4, 9 * 65536 + 3000),  # 10 blocks over 8 devices: one process gets
        # a partial range, the last process gets NO real blocks
        (4, 3 * 65536),  # fewer real blocks than processes
    ],
)
def test_uneven_splits_match_single_process(nprocs, n_bytes, tmp_path):
    """Multi-host frames must be byte-identical to single-process output
    for block counts that don't divide evenly over processes/devices —
    exercises _my_block_range / pwrite offset arithmetic on uneven tails."""
    rng = __import__("numpy").random.RandomState(13)
    words = [rng.randint(0, 256, rng.randint(4, 17)).astype("uint8").tobytes() for _ in range(64)]
    raw = b"".join(words[rng.randint(0, 64)] for _ in range(n_bytes // 8))[:n_bytes]
    in_path = tmp_path / "in.bin"
    in_path.write_bytes(raw)

    port = _free_port()
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    env.pop("PYTHONSTARTUP", None)
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                os.path.join(REPO, "tests", "multihost_worker.py"),
                f"127.0.0.1:{port}",
                str(nprocs),
                str(pid),
                str(in_path),
                str(tmp_path / "mh.frame"),
                str(tmp_path / "mh.out"),
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(nprocs)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        logs.append(out.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"

    assert (tmp_path / "mh.out").read_bytes() == raw
    import snappy_tpu

    assert (tmp_path / "mh.frame").read_bytes() == snappy_tpu.compress_framed(raw)


def test_block_range_rejects_noncontiguous_devices():
    """_my_block_range must refuse meshes where a process's devices are
    not contiguous in mesh order (silent block-claim desync otherwise)."""
    import types

    import numpy as np

    from snappy_tpu.parallel import multihost

    class Dev:
        def __init__(self, pi):
            self.process_index = pi

    # process 0 owns mesh slots 0 and 2: non-contiguous
    devs = np.array([Dev(0), Dev(1), Dev(0), Dev(1)], dtype=object)
    mesh = types.SimpleNamespace(devices=devs)
    import jax

    if jax.process_index() != 0:
        return
    import pytest as _pytest

    with _pytest.raises(RuntimeError, match="contiguous"):
        multihost._my_block_range(8, mesh)
