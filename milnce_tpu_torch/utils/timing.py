"""Device timing for CUDA work (the port's counterpart of
``milnce_tpu/utils/timing.py``'s chained protocol).

Kernel launches are asynchronous, so a wall-clock delta around a call
measures its launch, not its work (graftlint GL005).  Two protocols:

- :func:`event_ms`: CUDA events recorded around each call on the
  device's current stream, the end event waited for, and the median of
  ``reps`` calls after ``warm`` warm-up calls.  It times one call with
  its launch gaps, as a caller sees it.
- :func:`chained_ms`: ``k1`` and then ``k1 + n`` calls launched back to
  back with one synchronize at the end of each run; ``(T(k1 + n) -
  T(k1)) / n`` cancels the fixed cost of the first launch and of the
  synchronize, and leaves a call's share of a busy queue.

Both take an explicit ``device``; on the CPU they read
``time.perf_counter`` around synchronous calls.  ``clock`` and ``sync``
replace the clock and the synchronize (a fake clock in the tests).
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def event_ms(fn: Callable[[], object], reps: int = 20, warm: int = 3,
             device="cuda") -> float:
    """Median milliseconds of one call of ``fn()`` over ``reps`` calls,
    after ``warm`` calls: CUDA events on ``device``, else the host
    clock."""
    for _ in range(warm):
        fn()
    times = []
    if not _is_cuda(device):
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    with torch.cuda.device(device):
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def chained_ms(fn: Callable[[], object], n: int = 20, k1: int = 4,
               device="cuda", reps: int = 3, clock=time.perf_counter,
               sync=None) -> float:
    """Milliseconds a call of ``fn()`` adds to a busy queue: the least of
    ``reps`` measurements of ``(T(k1 + n) - T(k1)) / n``, where T(k) is
    the wall time of ``k`` back-to-back calls and one synchronize of
    ``device``."""
    if sync is None:
        sync = ((lambda: torch.cuda.synchronize(device))
                if _is_cuda(device) else (lambda: None))

    def run(k: int) -> float:
        sync()
        t0 = clock()
        for _ in range(k):
            fn()
        sync()
        return clock() - t0

    run(k1)                                     # warm
    best = min(run(k1 + n) - run(k1) for _ in range(reps))
    return max(best, 0.0) * 1e3 / n
