"""Profiling / step-timing utilities (port of
``milnce_tpu/utils/profiling.py``): a windowed step timer (steps/sec,
clips/sec) and an optional ``torch.profiler`` trace context.
"""

from __future__ import annotations

import contextlib
import os
import time


class StepTimer:
    """Windowed throughput meter."""

    def __init__(self, clips_per_step: int):
        self.clips_per_step = clips_per_step
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self) -> None:
        self._steps += 1

    @property
    def steps(self) -> int:
        return self._steps

    @property
    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0

    @property
    def steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0

    @property
    def clips_per_sec(self) -> float:
        return self.steps_per_sec * self.clips_per_step


@contextlib.contextmanager
def maybe_trace(log_dir: str | None):
    """``with maybe_trace('/tmp/trace'):`` wraps the block in a
    ``torch.profiler`` trace (CPU activity, and CUDA activity when a card
    is visible) written as a Chrome trace, ``trace.json``, into the
    directory when it is given; no-op otherwise."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
