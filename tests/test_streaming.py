"""Streaming pipeline tests: frame sequences, bounded memory, recovery."""

import io

import numpy as np
import pytest

from snappy_tpu.core.errors import CorruptInputError
from snappy_tpu.parallel import streaming

from conftest import read_testdata


def roundtrip(raw: bytes, **kw) -> bytes:
    src, dst = io.BytesIO(raw), io.BytesIO()
    streaming.compress_stream(src, dst, **kw)
    dst.seek(0)
    out = io.BytesIO()
    n = streaming.uncompress_stream(dst, out)
    assert n == len(raw)
    return out.getvalue()


def test_multi_frame_stream():
    raw = read_testdata("urls.10K") + read_testdata("html_x_4")  # ~1.1 MB, 2 frames
    assert roundtrip(raw) == raw


def test_small_blocks_per_frame():
    raw = read_testdata("html")
    assert roundtrip(raw, blocks_per_frame=1) == raw


def test_empty_stream():
    assert roundtrip(b"") == b""


def test_frame_iteration_offsets():
    raw = read_testdata("html_x_4") * 3  # ~1.2 MB
    src, dst = io.BytesIO(raw), io.BytesIO()
    streaming.compress_stream(src, dst, blocks_per_frame=4)
    dst.seek(0)
    frames = list(streaming.iter_frames(dst))
    assert len(frames) == -(-((len(raw) + 65535) // 65536) // 4)
    # Resume from frame 2 only (recovery: re-dispatch from a frame boundary).
    from snappy_tpu.parallel import uncompress_framed

    partial = b"".join(uncompress_framed(f) for f in frames[2:])
    assert partial == raw[2 * 4 * 65536 :]


def test_transient_frame_failure_recovers(monkeypatch):
    """A frame decode that fails once is re-dispatched and succeeds
    (SURVEY.md §5: blocks are stateless, recovery = re-dispatch)."""
    raw = read_testdata("html_x_4")
    src, dst = io.BytesIO(raw), io.BytesIO()
    streaming.compress_stream(src, dst, blocks_per_frame=2)
    dst.seek(0)

    from snappy_tpu.parallel import host as phost

    real = phost.assemble_uncompress
    fail_once = {"armed": True}

    def flaky(ticket):
        if fail_once["armed"]:
            fail_once["armed"] = False
            raise RuntimeError("injected transient device fault")
        return real(ticket)

    monkeypatch.setattr(phost, "assemble_uncompress", flaky)
    out = io.BytesIO()
    n = streaming.uncompress_stream(dst, out)
    assert n == len(raw) and out.getvalue() == raw
    assert streaming.last_stats["retries"] == 1


def test_corrupt_frame_does_not_retry(monkeypatch):
    """Data corruption is deterministic: the pipeline must NOT burn a
    re-dispatch on CorruptInputError — only transient faults
    retry."""
    raw = read_testdata("html")
    src, dst = io.BytesIO(raw), io.BytesIO()
    streaming.compress_stream(src, dst)
    dst.seek(0)

    from snappy_tpu.parallel import host as phost

    calls = {"n": 0}

    def corrupt(ticket):
        calls["n"] += 1
        raise CorruptInputError("injected corruption")

    monkeypatch.setattr(phost, "assemble_uncompress", corrupt)
    with pytest.raises(CorruptInputError):
        streaming.uncompress_stream(dst, io.BytesIO())
    assert calls["n"] == 1  # no re-dispatch, no second decode


def test_persistent_frame_failure_raises(monkeypatch):
    raw = read_testdata("html")
    src, dst = io.BytesIO(raw), io.BytesIO()
    streaming.compress_stream(src, dst)
    dst.seek(0)

    from snappy_tpu.parallel import host as phost

    def broken(ticket):
        raise RuntimeError("injected permanent fault")

    monkeypatch.setattr(phost, "assemble_uncompress", broken)
    with pytest.raises(RuntimeError):
        streaming.uncompress_stream(dst, io.BytesIO())


def test_torn_stream_raises():
    src, dst = io.BytesIO(b"x" * 300000), io.BytesIO()
    streaming.compress_stream(src, dst)
    data = dst.getvalue()
    for cut in [3, len(data) - 5]:
        with pytest.raises(CorruptInputError):
            out = io.BytesIO()
            streaming.uncompress_stream(io.BytesIO(data[:cut]), out)


class TestKillAndResume:
    """Checkpoint/resume (SURVEY.md §5): the frame sequence is the
    checkpoint; a killed run restarts from the last durable frame."""

    def _mkdata(self, n=5 * (1 << 16) + 777):
        rng = np.random.RandomState(11)
        words = [bytes(rng.randint(0, 256, rng.randint(4, 17))) for _ in range(64)]
        return b"".join(words[rng.randint(0, 64)] for _ in range(n // 8))[:n]

    def test_resume_compress_after_torn_tail(self, tmp_path):
        raw = self._mkdata()
        src = tmp_path / "in.bin"
        src.write_bytes(raw)
        ref = tmp_path / "ref.snpf"
        streaming.compress_file(str(src), str(ref), blocks_per_frame=2)
        full = ref.read_bytes()

        for cut_frac in (0.25, 0.6, 0.97):
            out = tmp_path / f"out{cut_frac}.snpf"
            out.write_bytes(full[: int(len(full) * cut_frac)])  # the "kill"
            size = streaming.resume_compress_file(str(src), str(out), blocks_per_frame=2)
            assert size == len(full)
            assert out.read_bytes() == full

    def test_resume_compress_from_scratch_and_idempotent(self, tmp_path):
        raw = self._mkdata()
        src = tmp_path / "in.bin"
        src.write_bytes(raw)
        out = tmp_path / "out.snpf"
        s1 = streaming.resume_compress_file(str(src), str(out), blocks_per_frame=2)
        first = out.read_bytes()
        s2 = streaming.resume_compress_file(str(src), str(out), blocks_per_frame=2)
        assert (s1, first) == (s2, out.read_bytes())

    def test_resume_uncompress_after_torn_output(self, tmp_path):
        raw = self._mkdata()
        src = tmp_path / "in.bin"
        src.write_bytes(raw)
        comp = tmp_path / "c.snpf"
        streaming.compress_file(str(src), str(comp), blocks_per_frame=2)

        for cut in (0, 100, 3 * (1 << 16) + 5, len(raw) - 3):
            out = tmp_path / f"o{cut}.bin"
            out.write_bytes(raw[:cut])  # torn output prefix from a kill
            n = streaming.resume_uncompress_file(str(comp), str(out))
            assert n == len(raw)
            assert out.read_bytes() == raw

    def test_resume_compress_after_input_grew(self, tmp_path):
        """A finished stream ends in a short frame; if the INPUT then grows,
        resume must drop that short frame and continue (not dead-end)."""
        raw = self._mkdata()
        src = tmp_path / "in.bin"
        src.write_bytes(raw)
        out = tmp_path / "out.snpf"
        streaming.compress_file(str(src), str(out), blocks_per_frame=2)
        grown = raw + self._mkdata(3 * (1 << 16) + 99)
        src.write_bytes(grown)
        size = streaming.resume_compress_file(str(src), str(out), blocks_per_frame=2)
        ref = tmp_path / "ref.snpf"
        streaming.compress_file(str(src), str(ref), blocks_per_frame=2)
        assert size == len(ref.read_bytes())
        assert out.read_bytes() == ref.read_bytes()

    def test_resume_compress_finished_truncates_torn_tail(self, tmp_path):
        raw = self._mkdata()
        src = tmp_path / "in.bin"
        src.write_bytes(raw)
        out = tmp_path / "out.snpf"
        streaming.compress_file(str(src), str(out), blocks_per_frame=2)
        full = out.read_bytes()
        out.write_bytes(full + b"\x99" * 7)  # killed while appending junk
        assert streaming.resume_compress_file(str(src), str(out), blocks_per_frame=2) == len(full)
        assert out.read_bytes() == full

    def test_scan_durable_frames_counts(self, tmp_path):
        raw = self._mkdata()
        src = tmp_path / "in.bin"
        src.write_bytes(raw)
        comp = tmp_path / "c.snpf"
        streaming.compress_file(str(src), str(comp), blocks_per_frame=2)
        full = comp.read_bytes()
        durable, nf, covered = streaming.scan_durable_frames(str(comp))
        assert durable == len(full) and covered == len(raw) and nf == 3
        # torn tail: drop 1 byte -> last frame not durable
        comp.write_bytes(full[:-1])
        d2, nf2, c2 = streaming.scan_durable_frames(str(comp))
        assert nf2 == 2 and d2 < len(full) and c2 == 4 * (1 << 16)
