"""Preemption-aware drain: one latched verdict from three signals (port of
``milnce_tpu/elastic/drain.py``).

Preemptible machines deliver SIGTERM; orchestrators that can't signal
(or tests that must be deterministic) drop a file or arm the
``host.preempt`` fault site.  All three converge on one latched flag
the train loop polls once per step: the in-flight optimizer step
finishes, the stop path forces a rotation checkpoint through the
atomic tmp+rename discipline, writes ``ELASTIC_STAMP.json``, and the
run exits with the distinct drained status.

Across ranks: the controller is per rank; the loop takes the MAX of the
polled flags over the group (``parallel/dist.py::reduce_flag``) every
``train.preempt_sync_steps`` steps, so one drained rank checkpoints the
whole group cooperatively at the same step.
"""

from __future__ import annotations

import os
import signal

from milnce_tpu_torch.resilience import faults

#: distinct process exit status of a drained run (train/cli.py): 75 is
#: BSD sysexits' EX_TEMPFAIL — "temporary failure, retry" — which is
#: exactly the contract: rerun with ``--train.resume true`` (on any
#: mesh shape whose batches divide).
DRAINED_EXIT_CODE = 75


class DrainController:
    """Latched drain verdict for one training process.

    ``poll()`` is called once per optimizer step by the train loop:
    cheap (one dict read + one disarmed-fault check + an optional
    ``os.path.exists``), and the ``host.preempt`` occurrence count is
    therefore the step number — ``host.preempt@N`` delivers the drain
    signal at step N, deterministically, with no real signal involved
    (signal handlers can't install from non-main threads, and a chaos
    test must not depend on kernel delivery timing)."""

    def __init__(self, signal_file: str = "", recorder=None):
        self._signal_file = signal_file
        self._rec = recorder
        self._flag = False
        self._source = ""
        self._announced = False
        self._prev_handler = None

    # -- signal plumbing ------------------------------------------------
    def install(self):
        """Install the SIGTERM handler (restore with :meth:`uninstall`).
        Non-main-thread installation (tests) degrades to the other two
        signal sources, same as the historical inline handler."""
        def _on_sigterm(signum, frame):
            self._trip("sigterm")

        try:
            self._prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:          # non-main thread
            self._prev_handler = None
        return self._prev_handler

    def uninstall(self) -> None:
        if self._prev_handler is not None:
            signal.signal(signal.SIGTERM, self._prev_handler)
            self._prev_handler = None

    # -- the per-step check ---------------------------------------------
    def _trip(self, source: str) -> None:
        if not self._flag:
            self._flag = True
            self._source = source

    def poll(self, step: int = 0) -> bool:
        """Latched drain verdict; counts one ``host.preempt`` occurrence
        per call while untripped.  The ``preempt.signal`` event is
        emitted HERE (loop thread), never from the signal handler —
        recorder IO in signal context is how handlers deadlock."""
        if not self._flag:
            if faults.fire_site("host.preempt"):
                self._trip("host.preempt")
            elif self._signal_file and os.path.exists(self._signal_file):
                self._trip("signal_file")
        if self._flag and not self._announced:
            self._announced = True
            if self._rec is not None:
                self._rec.event("preempt.signal", source=self._source,
                                step=int(step))
        return self._flag

    @property
    def draining(self) -> bool:
        return self._flag

    @property
    def source(self) -> str:
        """What delivered the drain signal: ``sigterm`` |
        ``host.preempt`` | ``signal_file`` | '' (not draining)."""
        return self._source
