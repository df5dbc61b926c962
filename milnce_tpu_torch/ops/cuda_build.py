"""Build and load the port's CUDA kernels (``milnce_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under :data:`BUILD_DIR`, at first use, and
loaded with ``ctypes``: ``build/torch_kernels/`` of the checkout (ignored
by git) when the package runs from a checkout of the repository, else
the per-user cache ``$XDG_CACHE_HOME/milnce_tpu_torch`` (by default
``~/.cache/milnce_tpu_torch``), since an installed package's directory
may not be writable.  The library's name carries a
hash of its source, so an edited kernel is never served from a stale
build.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"


def _build_dir() -> Path:
    """``build/torch_kernels`` of the checkout that holds the package (the
    directory above it has ``pyproject.toml``), else the per-user cache."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "milnce_tpu_torch"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SM90_SMEM_OPTIN = 232448            # shared bytes a block may opt in to, H100

_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def library_path(name: str, defines=()) -> Path:
    """The library of ``csrc/<name>.cu`` built with ``-D`` ``defines``."""
    flags = " ".join((*NVCC_FLAGS, *(f"-D{d}" for d in defines)))
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()
                            + flags.encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names, defines=()) -> dict:
    """Compile every named source that has no current library, one
    ``nvcc`` each, all started together; ``defines`` (``NAME=VALUE``)
    go to nvcc as ``-D``.  Returns ``{name: (seconds, compiler output)}``
    for the sources it compiled; raises naming the source if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
               "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    done = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


def current_stream(x) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``x``'s device, for a launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


# Callables of one argument, the launch's name, called at every launch a
# wrapper makes (after its check) and at every launch a wrapper plans on
# the ``meta`` device in its stead: the op trace's (analysis/optrace.py)
# view of the hand kernels, which no dispatch mode sees.
LAUNCH_HOOKS: list = []


def note_launch(name: str) -> None:
    """Tell the launch hooks of a launch of ``name``."""
    for hook in LAUNCH_HOOKS:
        hook(name)


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize does not report it); else note
    the launch of ``name`` to the launch hooks."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    if LAUNCH_HOOKS:
        note_launch(name)


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (with ``defines``), built
    if needed."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        build([name], defines)
        lib = ctypes.CDLL(str(library_path(name, defines)))
        _LIBS[key] = lib
    return lib
