"""Native subprocess pipe-reader pool (port of
``milnce_tpu/native/reader.py``; ctypes front-end).

The decode hot path of the input pipeline: worker threads in C++ popen()
the decode commands and fread() their stdout straight into
caller-provided numpy buffers, with no GIL held and no Python-side byte
copies (the reference shuttles every frame through ``ffmpeg-python``'s
``run(capture_stdout=True)`` inside loader worker processes,
video_loader.py:85-88).
"""

from __future__ import annotations

import ctypes
import shlex
from typing import Sequence

import numpy as np

from milnce_tpu_torch.native.build import load_native_library


class ReaderPool:
    """Threaded pipe pump.  ``decode_into`` runs shell commands
    concurrently, filling each command's numpy buffer with its stdout.
    Building one raises when the native library cannot be had."""

    def __init__(self, workers: int = 8):
        self._lib = load_native_library()
        self._pool = self._lib.reader_create(int(workers))
        if not self._pool:
            raise RuntimeError("reader_create failed")

    def decode_into(self, commands: Sequence[Sequence[str] | str],
                    buffers: Sequence[np.ndarray]) -> list[int]:
        """Run every command (a shell string, or an argv that is quoted
        into one), filling ``buffers[i]`` (uint8, C-contiguous) with its
        stdout, truncated at the buffer's size.  Returns the bytes read a
        job (-1: the command could not be spawned)."""
        if len(commands) != len(buffers):
            raise ValueError(f"{len(commands)} commands for "
                             f"{len(buffers)} buffers")
        if self._pool is None:
            raise RuntimeError("the reader pool is closed")
        jobs = []
        for cmd, buf in zip(commands, buffers):
            if buf.dtype != np.uint8 or not buf.flags.c_contiguous:
                raise ValueError("buffers must be C-contiguous uint8 arrays")
            if not isinstance(cmd, str):
                cmd = " ".join(shlex.quote(c) for c in cmd)
            ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            jobs.append(self._lib.reader_submit(
                self._pool, cmd.encode(), ptr, buf.nbytes))
        return [int(self._lib.reader_wait(self._pool, j)) for j in jobs]

    def close(self) -> None:
        """Join the pool's threads (each finishes the job it holds)."""
        if getattr(self, "_pool", None):
            self._lib.reader_destroy(self._pool)
            self._pool = None

    def __del__(self):
        self.close()
