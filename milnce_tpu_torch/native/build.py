"""Build and load the port's host C++ library (port of
``milnce_tpu/native/build.py``; ctypes, no pybind11).

``milnce_tpu_torch/csrc/milnce_native.cpp`` (the threaded pipe pump of
the native decode path and the soft-DTW CPU recurrences) is compiled by
``g++ -O3 -shared -fPIC -pthread -std=c++17`` at first use into
``libmilnce_native-<hash>.so`` beside the CUDA libraries
(``ops/cuda_build.py::BUILD_DIR``: ``build/torch_kernels/`` of a
checkout, else the per-user cache); the name carries a
hash of the source and the flags, so an edited source is never served
from a stale build.  Nothing here runs when the module is imported.

Unlike the JAX package's build, nothing degrades: :func:`load_native_library`
raises when the library cannot be built or loaded, and every user of it
(``data.use_native_reader``, ``native/softdtw_cpu.py``) fails with it.
:func:`native_available` exists for tests to skip on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from milnce_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "milnce_native.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmilnce_native-{digest}.so"


def _compile(out: Path) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("the native library needs a C++ compiler (g++) "
                           "on the host; none is on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def load_native_library() -> ctypes.CDLL:
    """The loaded library, built first if there is no current build;
    raises when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
            _declare(lib)
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads here (for tests to skip on;
    the run paths call :func:`load_native_library` and let it raise)."""
    try:
        load_native_library()
    except (RuntimeError, OSError):
        return False
    return True


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.reader_create.restype = ctypes.c_void_p
    lib.reader_create.argtypes = [ctypes.c_int]
    lib.reader_submit.restype = ctypes.c_long
    lib.reader_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u8p,
                                  ctypes.c_long]
    lib.reader_wait.restype = ctypes.c_long
    lib.reader_wait.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.reader_destroy.restype = None
    lib.reader_destroy.argtypes = [ctypes.c_void_p]
    lib.softdtw_forward_cpu.restype = None
    lib.softdtw_forward_cpu.argtypes = [f32p, f32p, f32p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_float, ctypes.c_int]
    lib.softdtw_backward_cpu.restype = None
    lib.softdtw_backward_cpu.argtypes = [f32p, f32p, f32p, f32p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int]
