"""Host-side video decode (port of ``milnce_tpu/data/video.py``).

Two production decoders build the reference's clip (video_loader.py:
58-88): :class:`FFmpegDecoder` runs the ffmpeg binary with the same
filter graph as subprocess args, :class:`Cv2Decoder` decodes in-process
through OpenCV's bundled libav*.  :class:`FakeDecoder` yields
deterministic frames with no codec at all (hermetic tests, ``--fake_decoder``).

Filter-graph parity with video_loader.py:60-88:
- seek: ``-ss start -t num_sec+0.1`` on the INPUT side;
- ``fps=<fps>`` filter;
- crop: either direct ``size x size`` crop at a fractional offset
  (crop_only, :69-74) or largest-square crop + bilinear scale (:75-82);
- optional horizontal flip (:83-84);
- rawvideo rgb24 on stdout -> numpy.

Output is channels-LAST ``(T, H, W, 3) uint8``, zero-padded/truncated to
``num_frames`` (:92-95).  ``cv2`` is imported only where it decodes.
``sample_clip`` fires the ``decode.raise`` and ``decode.hang`` fault
sites (``resilience/faults.py``).  :class:`NativeFFmpegDecoder`
(``data.use_native_reader``) runs the same ffmpeg command through the
C++ pipe pump of ``native/reader.py``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import shlex
import shutil
import signal
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from typing import Protocol

import numpy as np

from milnce_tpu_torch.resilience import faults

# In-flight decoder children, registered for kill-on-close: a mid-epoch
# stop cancels QUEUED decode futures, but the ffmpeg children already
# spawned would keep decoding to completion.  Every subprocess-backed
# decode registers its Popen (the native pool's jobs: a _PoolJob) here
# for the duration of the pipe read; ShardedLoader's generator close
# calls :func:`kill_inflight_decoders`.
_INFLIGHT: set = set()
_INFLIGHT_LOCK = threading.Lock()


def _register_inflight(proc) -> None:
    with _INFLIGHT_LOCK:
        _INFLIGHT.add(proc)


def _unregister_inflight(proc) -> None:
    with _INFLIGHT_LOCK:
        _INFLIGHT.discard(proc)


def kill_inflight_decoders(grace: float = 0.2) -> int:
    """SIGTERM (then SIGKILL after ``grace``) every registered in-flight
    decode child; returns how many were signalled.  The owning decode()
    call then fails its pipe read — callers are already past caring (the
    epoch generator is closing)."""
    with _INFLIGHT_LOCK:
        procs = list(_INFLIGHT)
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    killed = 0
    for proc in procs:
        if proc.poll() is None:
            try:
                proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                proc.kill()
        killed += 1
    return killed


class ClipDecoder(Protocol):
    def decode(self, path: str, start_seek: float, num_sec: float,
               fps: int, size: int, aw: float, ah: float, crop_only: bool,
               hflip: bool) -> np.ndarray: ...

    def duration(self, path: str) -> float: ...


def _crop_expr(size: int, aw: float, ah: float, crop_only: bool) -> str:
    # ffmpeg crop filter is crop=w:h:x:y
    if crop_only:
        return f"crop={size}:{size}:(iw-{size})*{aw}:(ih-{size})*{ah}"
    return (f"crop=min(iw\\,ih):min(iw\\,ih)"
            f":(iw-min(iw\\,ih))*{aw}:(ih-min(iw\\,ih))*{ah}"
            f",scale={size}:{size}")


@dataclass
class FFmpegDecoder:
    binary: str = "ffmpeg"
    probe_binary: str = "ffprobe"

    def available(self) -> bool:
        return shutil.which(self.binary) is not None

    def command(self, path: str, start_seek: float, num_sec: float,
                fps: int, size: int, aw: float = 0.5, ah: float = 0.5,
                crop_only: bool = False, hflip: bool = False) -> list[str]:
        """The decode argv (rawvideo rgb24 on stdout)."""
        vf = f"fps={fps},{_crop_expr(size, aw, ah, crop_only)}"
        if hflip:
            vf += ",hflip"
        return [self.binary, "-nostdin", "-loglevel", "error",
                "-ss", f"{start_seek}", "-t", f"{num_sec + 0.1}",
                "-i", path, "-vf", vf,
                "-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:"]

    def decode(self, path: str, start_seek: float, num_sec: float,
               fps: int, size: int, aw: float = 0.5, ah: float = 0.5,
               crop_only: bool = False, hflip: bool = False) -> np.ndarray:
        if not self.available():
            raise RuntimeError(
                "ffmpeg binary not found — install it on the host or use the "
                "synthetic data source (data.synthetic=True)")
        cmd = self.command(path, start_seek, num_sec, fps, size, aw, ah,
                           crop_only, hflip)
        # Popen (not subprocess.run) so the child is registered while its
        # pipe is being pumped: kill_inflight_decoders() can reap it on a
        # mid-epoch generator close instead of orphaning a full decode.
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL)
        _register_inflight(proc)
        try:
            out, _ = proc.communicate()
        finally:
            _unregister_inflight(proc)
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(proc.returncode, cmd)
        n = len(out) // (size * size * 3)
        return np.frombuffer(out[: n * size * size * 3],
                             np.uint8).reshape(n, size, size, 3)

    def duration(self, path: str) -> float:
        """Container duration in seconds (the reference uses
        ``ffmpeg.probe``, msrvtt_loader.py:117-119)."""
        cmd = [self.probe_binary, "-v", "error", "-show_entries",
               "format=duration", "-of",
               "default=noprint_wrappers=1:nokey=1", path]
        return float(subprocess.run(cmd, stdout=subprocess.PIPE,
                                    check=True).stdout.strip())


class _PoolJob:
    """One native-pool decode, in the in-flight registry's terms (the
    ``Popen`` calls :func:`kill_inflight_decoders` makes).  The pool
    popen()s through ``/bin/sh``, which gives no pid back, so the job's
    command writes the shell's pid into ``pidfile`` and ``exec``s the
    decoder in its place (same pid); a job not started yet when it is
    terminated finds ``cancelfile`` and exits without decoding."""

    def __init__(self, pidfile: str, cancelfile: str):
        self.pidfile, self.cancelfile = pidfile, cancelfile
        self.done = threading.Event()

    def wrap(self, cmd: str) -> str:
        return (f"[ -e {shlex.quote(self.cancelfile)} ] || "
                f"{{ echo $$ > {shlex.quote(self.pidfile)}; exec {cmd}; }}")

    def _signal(self, sig) -> None:
        try:
            with open(self.pidfile) as fh:
                pid = int(fh.read().strip() or 0)
        except (OSError, ValueError):
            return
        if pid and not self.done.is_set():
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass

    def poll(self):
        return 0 if self.done.is_set() else None

    def terminate(self) -> None:
        with open(self.cancelfile, "w"):
            pass
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)

    def wait(self, timeout=None) -> int:
        if not self.done.wait(timeout):
            raise subprocess.TimeoutExpired("native decode", timeout)
        return 0

    def cleanup(self) -> None:
        for path in (self.pidfile, self.cancelfile):
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)


class NativeFFmpegDecoder(FFmpegDecoder):
    """FFmpegDecoder whose byte pumping runs in the C++ ReaderPool
    (``csrc/milnce_native.cpp``): worker threads popen() the decode
    command and fread() rawvideo straight into a numpy buffer, with no
    GIL held and no Python-side byte copies.  Enable with
    ``DataConfig.use_native_reader``.

    The pool is shared across the loader's Python threads; each decode()
    submits one job and blocks only its own thread (``reader_wait``
    drops the GIL inside ctypes).  A decode whose output exactly fills
    the buffer is treated as truncated (raise) rather than silently
    cropped; the buffer holds ``SLACK_FRAMES`` frames more than the clip
    can, so a correct decode never fills it.  Each job is registered
    in flight (:class:`_PoolJob`) while its pipe is read.
    """

    SLACK_FRAMES = 4

    def __init__(self, binary: str = "ffmpeg", probe_binary: str = "ffprobe",
                 workers: int = 8):
        super().__init__(binary=binary, probe_binary=probe_binary)
        from milnce_tpu_torch.native.reader import ReaderPool

        self._pool = ReaderPool(workers=workers)
        self._jobdir = tempfile.mkdtemp(prefix="milnce-native-decode-")
        self._ids = itertools.count()

    def decode(self, path: str, start_seek: float, num_sec: float,
               fps: int, size: int, aw: float = 0.5, ah: float = 0.5,
               crop_only: bool = False, hflip: bool = False) -> np.ndarray:
        if not self.available():
            raise RuntimeError(
                "ffmpeg binary not found — install it on the host or use the "
                "synthetic data source (data.synthetic=True)")
        cmd = self.command(path, start_seek, num_sec, fps, size, aw, ah,
                           crop_only, hflip)
        # the pool popen()s through /bin/sh with inherited fds: route any
        # decoder chatter away from the training logs (the subprocess
        # path gets the same from stderr=DEVNULL)
        cmd_str = " ".join(shlex.quote(c) for c in cmd) + " 2>/dev/null"
        frame_bytes = size * size * 3
        max_frames = int(np.ceil((num_sec + 0.1) * fps)) + self.SLACK_FRAMES
        buf = np.empty((max_frames * frame_bytes,), np.uint8)
        n = next(self._ids)
        job = _PoolJob(os.path.join(self._jobdir, f"{n}.pid"),
                       os.path.join(self._jobdir, f"{n}.cancel"))
        _register_inflight(job)
        try:
            got = self._pool.decode_into([job.wrap(cmd_str)], [buf])[0]
        finally:
            job.done.set()
            _unregister_inflight(job)
            job.cleanup()
        if got < 0:
            raise RuntimeError(f"native decode spawn failed: {path}")
        if got == 0:
            raise RuntimeError(f"native decode produced no frames: {path}")
        if got >= buf.nbytes:
            raise RuntimeError(f"native decode overflow (buffer too small "
                               f"for {path}; got >= {buf.nbytes} bytes)")
        n = got // frame_bytes
        return buf[: n * frame_bytes].reshape(n, size, size, 3).copy()

    def close(self) -> None:
        """Join the pool's threads and drop the job directory."""
        self._pool.close()
        shutil.rmtree(self._jobdir, ignore_errors=True)


class Cv2Decoder:
    """In-process decode via OpenCV's bundled ffmpeg libraries, for hosts
    with no ffmpeg *binary*.

    Same clip semantics as :class:`FFmpegDecoder`'s filter graph: input-
    side seek, constant-rate fps resample, fractional-offset square crop
    (direct ``size``-crop or largest-square crop + resize) and optional
    hflip.  Two one-frame-scale divergences from the binary: the resample
    emits the LAST source frame with pts <= output pts (ffmpeg's ``fps=``
    rounds to the nearest), and ``CAP_PROP_POS_MSEC`` seeks are keyframe
    dependent.  Exact frame-index parity across backends is not
    guaranteed."""

    def available(self) -> bool:
        try:
            import cv2  # noqa: F401
            return True
        except ImportError:
            return False

    def decode(self, path: str, start_seek: float, num_sec: float,
               fps: int, size: int, aw: float = 0.5, ah: float = 0.5,
               crop_only: bool = False, hflip: bool = False) -> np.ndarray:
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise RuntimeError(f"cv2 failed to open video: {path}")
        try:
            src_fps = cap.get(cv2.CAP_PROP_FPS)
            if not src_fps or src_fps <= 0:
                src_fps = float(fps)
            if start_seek > 0:
                cap.set(cv2.CAP_PROP_POS_MSEC, float(start_seek) * 1000.0)
            max_out = int(np.ceil((num_sec + 0.1) * fps))
            ok, frame = cap.read()
            if not ok:
                raise RuntimeError(f"cv2 decoded no frames: {path} "
                                   f"(seek {start_seek}s)")
            out = []
            src_idx = 0                 # source frames consumed since seek
            exhausted = False
            for k in range(max_out):
                target = k / float(fps)   # output pts, relative to the seek
                # the fps-filter rule: emit the last source frame whose
                # timestamp is <= the output timestamp
                while not exhausted and (src_idx + 1) / src_fps <= target:
                    ok, nxt = cap.read()
                    if not ok:
                        exhausted = True
                        break
                    frame = nxt
                    src_idx += 1
                if exhausted and target >= (src_idx + 1) / src_fps:
                    break               # past the last frame's span: stop,
                                        # like ffmpeg at EOF (caller pads)
                out.append(self._process(frame, size, aw, ah, crop_only,
                                         hflip))
            return np.stack(out, axis=0)
        finally:
            cap.release()

    @staticmethod
    def _process(frame: np.ndarray, size: int, aw: float, ah: float,
                 crop_only: bool, hflip: bool) -> np.ndarray:
        import cv2

        ih, iw = frame.shape[:2]
        if crop_only:
            if iw < size or ih < size:
                # ffmpeg's crop filter fails such frames outright; match it
                # so both backends feed the same resampling path
                raise RuntimeError(
                    f"crop_only: frame {iw}x{ih} smaller than crop "
                    f"size {size}")
            x = int((iw - size) * aw)
            y = int((ih - size) * ah)
            frame = frame[y:y + size, x:x + size]
        else:
            s = min(iw, ih)
            x = int((iw - s) * aw)
            y = int((ih - s) * ah)
            frame = cv2.resize(frame[y:y + s, x:x + s], (size, size),
                               interpolation=cv2.INTER_LINEAR)
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if hflip:
            frame = frame[:, ::-1]
        return np.ascontiguousarray(frame)

    def duration(self, path: str) -> float:
        import cv2

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise RuntimeError(f"cv2 failed to open video: {path}")
        try:
            n = cap.get(cv2.CAP_PROP_FRAME_COUNT)
            fps = cap.get(cv2.CAP_PROP_FPS)
            if not n or not fps or fps <= 0:
                raise RuntimeError(f"cv2 could not probe duration: {path}")
            return float(n) / float(fps)
        finally:
            cap.release()


def build_decoder(backend: str = "auto", use_native_reader: bool = False,
                  workers: int = 8) -> ClipDecoder:
    """Production decoder factory.  ``auto`` prefers the ffmpeg binary and
    falls back to in-process cv2; with neither it raises, naming both —
    never a silent :class:`FakeDecoder`, whose frames a run would train on
    unnoticed.  ``fake`` is the hermetic backend, asked for by name.

    ``use_native_reader`` (the JAX logic) makes ``auto`` the ffmpeg
    backend and refuses, here, a host without the binary: a decoder
    whose every decode raised would be swallowed by the source's
    resampling and the run would train on black frames.  Unlike the JAX
    package, which warns and decodes through cv2, it also refuses any
    backend but ffmpeg (the pool pumps subprocess pipes), and a native
    library that does not build raises here."""
    if use_native_reader:
        if backend not in ("auto", "ffmpeg"):
            raise ValueError(
                f"data.use_native_reader applies to the ffmpeg-binary "
                f"backend only (the C++ ReaderPool pumps its subprocess "
                f"pipes); data.decoder_backend is {backend!r}")
        if not FFmpegDecoder().available():
            raise RuntimeError(
                "use_native_reader needs the ffmpeg binary (the C++ "
                "ReaderPool pumps ffmpeg subprocess pipes) but none is on "
                "PATH — install ffmpeg, or drop use_native_reader to let "
                "'auto' fall back to in-process cv2 decode")
        return NativeFFmpegDecoder(workers=workers)
    if backend == "fake":
        return FakeDecoder()
    if backend == "auto":
        backend = "ffmpeg" if FFmpegDecoder().available() else "cv2"
        if backend == "cv2" and not Cv2Decoder().available():
            raise RuntimeError(
                "decoder auto-selection failed: no ffmpeg binary on PATH "
                "(install ffmpeg — the usual fix) and cv2 is not importable "
                "either")
    if backend == "ffmpeg":
        return FFmpegDecoder()
    if backend == "cv2":
        dec = Cv2Decoder()
        if not dec.available():
            raise RuntimeError("decoder backend 'cv2' requested but cv2 is "
                               "not importable")
        return dec
    raise ValueError(f"unknown decoder backend {backend!r} "
                     "(expected auto|ffmpeg|cv2|fake)")


@dataclass
class FakeDecoder:
    """Deterministic pseudo-decoder for hermetic tests: frame values are a
    function of (path hash, seek, fps) — the JAX package's, frame for
    frame, in the same process (``hash`` of a str is per process)."""

    frames_per_clip: int = 64
    fixed_duration: float = 30.0

    def decode(self, path: str, start_seek: float, num_sec: float,
               fps: int, size: int, aw: float = 0.5, ah: float = 0.5,
               crop_only: bool = False, hflip: bool = False) -> np.ndarray:
        n = min(self.frames_per_clip, max(1, int(round(num_sec * fps))))
        seed = (hash(path) ^ int(start_seek * 7 + fps)) % (2 ** 31)
        rng = np.random.RandomState(seed)
        frames = rng.randint(0, 255, size=(n, size, size, 3), dtype=np.uint8)
        if hflip:
            frames = frames[:, :, ::-1, :]
        return frames

    def duration(self, path: str) -> float:
        return self.fixed_duration


def black_sample(cfg) -> dict:
    """Black frames + empty caption bag + zero start: a valid, if
    useless, sample with the exact training batch contract — the
    sources' bounded-resample last resort and the loader watchdog's
    escalation target (data/pipeline.py)."""
    return {"video": np.zeros((cfg.num_frames, cfg.video_size,
                               cfg.video_size, 3), np.uint8),
            "text": np.zeros((cfg.num_candidates, cfg.max_words), np.int32),
            "start": np.float32(0.0)}


def pad_or_trim(frames: np.ndarray, num_frames: int) -> np.ndarray:
    """Zero-pad the tail / truncate to exactly ``num_frames``
    (video_loader.py:92-95)."""
    t = frames.shape[0]
    if t >= num_frames:
        return frames[:num_frames]
    pad = np.zeros((num_frames - t,) + frames.shape[1:], frames.dtype)
    return np.concatenate([frames, pad], axis=0)


def sample_clip(decoder: ClipDecoder, path: str, start: float, end: float,
                num_frames: int, fps: int, size: int,
                rng: np.random.RandomState, crop_only: bool,
                center_crop: bool, random_flip: bool) -> np.ndarray:
    """Random training clip draw within [start, end]
    (video_loader.py:58-95): random seek, random or center fractional
    crop offset, coin-flip hflip."""
    # the decode fault sites, inside the source's resample and the
    # loader's watchdog: ``train.faults`` drives both through here
    faults.maybe_raise("decode.raise")
    faults.maybe_hang("decode.hang")
    num_sec = num_frames / float(fps)
    hi = int(max(start, end - num_sec))
    start_seek = rng.randint(int(start), hi + 1)
    if center_crop:
        aw = ah = 0.5
    else:
        aw, ah = rng.uniform(0, 1), rng.uniform(0, 1)
    hflip = bool(random_flip and rng.uniform(0, 1) > 0.5)
    frames = decoder.decode(path, start_seek, num_sec, fps, size, aw, ah,
                            crop_only, hflip)
    return pad_or_trim(frames, num_frames)


def eval_windows(decoder: ClipDecoder, path: str, start: float, end: float,
                 num_clip: int, num_frames: int, fps: int,
                 size: int) -> np.ndarray:
    """``num_clip`` deterministic center-cropped windows linspaced over
    [start, end] (youcook_loader.py:52-57) -> (num_clip, T, H, W, 3) u8."""
    num_sec = num_frames / float(fps)
    starts = np.linspace(start, max(start, end - num_sec), num_clip)  # graftlint: disable=GL004(host clip start times in seconds, handed to the decoder as Python floats)
    clips = [pad_or_trim(decoder.decode(path, float(s), num_sec, fps, size,
                                        0.5, 0.5, False, False), num_frames)
             for s in starts]
    return np.stack(clips, axis=0)
