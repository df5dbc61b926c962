"""Decode-transport harness: the C++ ReaderPool against a Python thread
pool of subprocesses (port of ``milnce_tpu/native/bench_reader.py``).

Both pump ``head -c`` from /dev/zero, pure pipe throughput with no codec
cost, so the comparison isolates the transport:

    python -m milnce_tpu_torch.native.bench_reader [n_jobs] [mb_per_job] [workers]

Prints one JSON line: MB/s for each path and the speedup.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import subprocess
import sys
import time

import numpy as np

from milnce_tpu_torch.native.reader import ReaderPool


def python_pool(commands, nbytes, workers) -> float:
    """The pure-Python transport: ``subprocess.run`` capturing stdout on a
    thread pool (what ``FFmpegDecoder`` does without the native reader)."""
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(workers) as pool:
        def run(cmd):
            out = subprocess.run(cmd, shell=True, stdout=subprocess.PIPE,
                                 check=True).stdout
            return np.frombuffer(out, np.uint8)

        results = list(pool.map(run, commands))
    dt = time.perf_counter() - t0
    if not all(r.nbytes == nbytes for r in results):
        raise RuntimeError("a Python-pool job came back short")
    return len(commands) * nbytes / dt / 1e6


def native_pool(commands, nbytes, workers) -> float:
    pool = ReaderPool(workers=workers)
    buffers = [np.empty(nbytes, np.uint8) for _ in commands]
    t0 = time.perf_counter()
    got = pool.decode_into(commands, buffers)
    dt = time.perf_counter() - t0
    pool.close()
    if not all(g == nbytes for g in got):
        raise RuntimeError(f"a native-pool job came back short: {got[:4]}")
    return len(commands) * nbytes / dt / 1e6


def main(n_jobs: int = 64, mb_per_job: int = 8, workers: int = 8) -> dict:
    nbytes = mb_per_job * 1_000_000
    commands = [f"head -c {nbytes} /dev/zero" for _ in range(n_jobs)]
    py = python_pool(commands, nbytes, workers)
    nat = native_pool(commands, nbytes, workers)
    rec = {"n_jobs": n_jobs, "mb_per_job": mb_per_job, "workers": workers,
           "python_MBps": round(py, 1), "native_MBps": round(nat, 1),
           "speedup": round(nat / py, 2)}
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
