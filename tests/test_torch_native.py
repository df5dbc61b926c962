"""Port parity, the native data path and the host soft-DTW
(``milnce_tpu_torch/native/``, ``data/video.py::NativeFFmpegDecoder``)
against ``milnce_tpu/native/`` and ``milnce_tpu/data/video.py``.

Hermetic: shell ``printf``/``head`` jobs and executable stubs stand in
for the ffmpeg binary, as in ``tests/test_native.py``.  The library is
built from the port's own ``csrc/milnce_native.cpp`` by ``g++``:

- the ReaderPool's concurrent jobs, truncation at capacity and argv
  quoting; the in-flight registry reaps a running pool job and cancels
  a queued one;
- ``NativeFFmpegDecoder`` on a stub emits the JAX decoder's frames and
  ``FFmpegDecoder``'s, and raises on a spawn failure, on no frames and
  on a buffer that came back exactly full;
- ``build_decoder``'s refusals; the HowTo source with
  ``data.use_native_reader`` on draws the samples of the flag off;
- the host soft-DTW's value and gradient against JAX ``softdtw_native``
  and the port's plain recurrence (rtol 1e-5), with and without a band;
- the transport harness' JSON line.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from milnce_tpu.data import video as jax_video
from milnce_tpu.native.softdtw_cpu import softdtw_native as jax_softdtw_native
from milnce_tpu_torch.config import tiny_preset
from milnce_tpu_torch.data import video
from milnce_tpu_torch.data.datasets import HowTo100MSource
from milnce_tpu_torch.native.build import native_available
from milnce_tpu_torch.ops.softdtw import softdtw_scan

torch.set_num_threads(1)         # six test workers share the cores

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="no C++ compiler to build the "
                                       "native library")

SIZE, FRAMES = 8, 5


def _stub(tmp_path, body, name="fake_ffmpeg"):
    """An executable standing in for the ffmpeg binary: it ignores the
    decode argv and runs ``body``."""
    script = tmp_path / name
    script.write_text("#!/bin/sh\n" + body + "\n")
    script.chmod(0o755)
    return str(script)


def _frames_stub(tmp_path, frames=FRAMES, size=SIZE, name="fake_ffmpeg"):
    """A stub printing ``frames`` rgb24 frames of seeded random bytes."""
    data = np.random.RandomState(frames * size).randint(
        0, 256, (frames, size, size, 3)).astype(np.uint8)
    path = tmp_path / f"frames-{frames}x{size}.bin"
    path.write_bytes(data.tobytes())
    return _stub(tmp_path, f"cat {path}", name), data


# --------------------------------------------------------------- the pool
def test_concurrent_jobs_fill_buffers():
    from milnce_tpu_torch.native.reader import ReaderPool

    pool = ReaderPool(workers=4)
    bufs = [np.zeros(16, np.uint8) for _ in range(12)]
    got = pool.decode_into([f"printf 'job%02d-data' {i}" for i in range(12)],
                           bufs)
    assert got == [10] * 12
    for i, buf in enumerate(bufs):
        assert bytes(buf[:10]) == f"job{i:02d}-data".encode()
    pool.close()


def test_oversized_output_truncated_to_capacity():
    from milnce_tpu_torch.native.reader import ReaderPool

    pool = ReaderPool(workers=2)
    buf = np.zeros(8, np.uint8)
    assert pool.decode_into(["printf '0123456789ABCDEF'"], [buf]) == [8]
    assert bytes(buf) == b"01234567"
    pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.decode_into(["true"], [buf])


def test_argv_command_is_quoted():
    from milnce_tpu_torch.native.reader import ReaderPool

    pool = ReaderPool(workers=1)
    buf = np.zeros(32, np.uint8)
    (got,) = pool.decode_into([["printf", "a b; echo x"]], [buf])
    assert bytes(buf[:got]) == b"a b; echo x"
    pool.close()


def test_inflight_registry_reaps_running_and_queued_jobs(tmp_path):
    """A mid-epoch stop (``kill_inflight_decoders``, as the loader's close
    calls it) ends a pool job that is decoding and cancels one still
    queued behind it, so no decoder child outlives the epoch."""
    dec = video.NativeFFmpegDecoder(
        binary=_stub(tmp_path, "exec sleep 30"), workers=1)
    errors = []

    def decode():
        try:
            dec.decode("x.mp4", 0.0, 1.0, 2, SIZE)
        except RuntimeError as exc:
            errors.append(str(exc))

    threads = [threading.Thread(target=decode) for _ in range(2)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    while ((len(video._INFLIGHT) < 2
            or not any(p.endswith(".pid") for p in os.listdir(dec._jobdir)))
           and time.monotonic() - t0 < 10):
        time.sleep(0.02)
    assert len(video._INFLIGHT) == 2
    assert video.kill_inflight_decoders() == 2
    for t in threads:
        t.join(10)
    assert time.monotonic() - t0 < 10
    assert errors == ["native decode produced no frames: x.mp4"] * 2
    assert not video._INFLIGHT and not os.listdir(dec._jobdir)
    dec.close()


# ---------------------------------------------------------- the decoder
def test_native_decoder_matches_jax_and_the_subprocess_path(tmp_path):
    stub, frames = _frames_stub(tmp_path)
    dec = video.NativeFFmpegDecoder(binary=stub, workers=2)
    out = dec.decode("x.mp4", 0.0, FRAMES / 2.0, 2, SIZE)
    jax_dec = jax_video.NativeFFmpegDecoder(binary=stub, workers=2)
    np.testing.assert_array_equal(out, frames)
    np.testing.assert_array_equal(
        out, jax_dec.decode("x.mp4", 0.0, FRAMES / 2.0, 2, SIZE))
    np.testing.assert_array_equal(
        out, video.FFmpegDecoder(binary=stub).decode("x.mp4", 0.0,
                                                     FRAMES / 2.0, 2, SIZE))
    dec.close()


@pytest.mark.parametrize("case", ["spawn", "no-frames", "exactly-full"])
def test_native_decoder_errors(tmp_path, case, monkeypatch):
    num_sec, fps = 2.0, 2
    full = (int(np.ceil((num_sec + 0.1) * fps))
            + video.NativeFFmpegDecoder.SLACK_FRAMES) * SIZE * SIZE * 3
    body = {"spawn": "true", "no-frames": "exit 1",
            "exactly-full": f"head -c {full} /dev/zero"}[case]
    dec = video.NativeFFmpegDecoder(binary=_stub(tmp_path, body), workers=1)
    if case == "spawn":
        monkeypatch.setattr(dec._pool, "decode_into",
                            lambda cmds, bufs: [-1] * len(cmds))
    match = {"spawn": "spawn failed", "no-frames": "no frames",
             "exactly-full": "overflow"}[case]
    with pytest.raises(RuntimeError, match=match):
        dec.decode("bad.mp4", 0.0, num_sec, fps, SIZE)
    dec.close()


def test_build_decoder_refusals(monkeypatch):
    """A native request implies the ffmpeg backend: another backend is
    refused (the JAX package warns and decodes through cv2), and a host
    without the binary is refused when the decoder is built."""
    for backend in ("cv2", "fake"):
        with pytest.raises(ValueError, match="ffmpeg-binary backend only"):
            video.build_decoder(backend, use_native_reader=True)
    monkeypatch.setattr(video.shutil, "which", lambda _name: None)
    for backend in ("auto", "ffmpeg"):
        with pytest.raises(RuntimeError, match="needs the ffmpeg binary"):
            video.build_decoder(backend, use_native_reader=True)
    monkeypatch.setattr(video.shutil, "which", lambda _name: "/bin/ffmpeg")
    dec = video.build_decoder("auto", use_native_reader=True, workers=3)
    assert isinstance(dec, video.NativeFFmpegDecoder)
    assert type(video.build_decoder("auto")) is video.FFmpegDecoder
    dec.close()


def test_howto_source_with_the_flag_matches_the_flag_off(tmp_path,
                                                         monkeypatch):
    """``data.use_native_reader`` routes the HowTo source's decoder through
    the pool; on the same stub its samples are the subprocess path's."""
    (tmp_path / "captions").mkdir()
    (tmp_path / "captions" / "vid0.json").write_text(json.dumps(
        {"start": [0], "end": [6], "text": ["hello world"]}))
    (tmp_path / "train.csv").write_text("video_path\nvid0.mp4\n")
    cfg = tiny_preset()
    cfg.data.synthetic = False
    cfg.data.train_csv = str(tmp_path / "train.csv")
    cfg.data.video_root = str(tmp_path)
    cfg.data.caption_root = str(tmp_path / "captions")
    cfg.data.num_reader_threads = 2
    (tmp_path / "bin").mkdir()
    _frames_stub(tmp_path / "bin", cfg.data.num_frames, cfg.data.video_size,
                 name="ffmpeg")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}:{os.environ['PATH']}")
    samples = {}
    for flag in (False, True):
        cfg.data.use_native_reader = flag
        src = HowTo100MSource(cfg.data, cfg.model)
        assert type(src.decoder) is (video.NativeFFmpegDecoder if flag
                                     else video.FFmpegDecoder)
        samples[flag] = src.sample(0, np.random.RandomState(0))
        assert src.decode_failures == 0
    for key, val in samples[False].items():
        np.testing.assert_array_equal(samples[True][key], val, err_msg=key)


# ------------------------------------------------------- host soft-DTW
@pytest.mark.parametrize("b,n,m,gamma,band", [
    (3, 7, 5, 0.5, 0), (2, 6, 6, 0.7, 0), (2, 8, 8, 0.5, 2),
    (2, 9, 7, 0.1, 3)], ids=["rect", "square", "band2", "band3-g0.1"])
def test_host_softdtw_matches_jax_native_and_the_plain_recurrence(b, n, m,
                                                                  gamma,
                                                                  band):
    from milnce_tpu_torch.native.softdtw_cpu import softdtw_native

    rng = np.random.RandomState(n * m + band)
    D = rng.rand(b, n, m).astype(np.float32)
    g = rng.rand(b).astype(np.float32) + 0.5
    x = torch.from_numpy(D).requires_grad_()
    value = softdtw_native(x, gamma, band)
    (value * torch.from_numpy(g)).sum().backward()
    jax_value, jax_vjp = jax_softdtw_native(D, gamma, band)
    np.testing.assert_allclose(value.detach().numpy(), jax_value,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), jax_vjp(g), rtol=1e-5,
                               atol=1e-6)
    ref = torch.from_numpy(D).double().requires_grad_()
    want = softdtw_scan(ref, gamma, band)
    (want * torch.from_numpy(g).double()).sum().backward()
    np.testing.assert_allclose(value.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), ref.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_host_softdtw_refusals():
    from milnce_tpu_torch.native.softdtw_cpu import (softdtw_forward_native,
                                                     softdtw_native)

    with pytest.raises(ValueError, match="bandwidth"):
        softdtw_native(torch.ones(2, 10, 4), 1.0, 3)
    meta = torch.ones(1, 3, 3, device="meta")
    with pytest.raises(ValueError, match="takes CPU tensors"):
        softdtw_forward_native(meta, 1.0)


def test_reader_bench_harness(capsys):
    from milnce_tpu_torch.native.bench_reader import main

    rec = main(n_jobs=8, mb_per_job=1, workers=4)
    assert rec["python_MBps"] > 0 and rec["native_MBps"] > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
