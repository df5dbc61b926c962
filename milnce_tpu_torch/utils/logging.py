"""Run logger: the run's messages echoed and appended to
``<log_root>/<run>.log``, structured records to ``<run>.jsonl`` (port of
``milnce_tpu/utils/logging.py``; reference main_distributed.py:304-306,
rank-0 gated at the call site).

Both files are opened once, line-buffered.  ``log`` and ``log_event``
arrive from reader threads and the train loop, so the handles are
checked and written under one lock; ``close`` is terminal (the handles
are nulled under the lock and later calls are no-ops).  The echo is a
callable (``print`` by default), so the trainer can hand its own.
"""

from __future__ import annotations

import json
import os
import threading
import time


class RunLogger:
    def __init__(self, log_root: str, run_name: str = "",
                 enabled: bool = True, echo=print):
        self.enabled = enabled
        self.path = None
        self.events_path = None
        self._echo = echo
        self._fh = None
        self._events_fh = None
        self._lock = threading.Lock()
        if enabled and log_root:
            os.makedirs(log_root, exist_ok=True)
            base = os.path.join(log_root, run_name or "run")
            self.path = base + ".log"
            self.events_path = base + ".jsonl"
            self._fh = open(self.path, "a", buffering=1)
            self._events_fh = open(self.events_path, "a", buffering=1)

    def log(self, message: str) -> None:
        """Echo ``message`` and append it, time-stamped, to the text log."""
        if not self.enabled:
            return
        self._echo(message)
        line = f"[{time.strftime('%H:%M:%S')}] {message}"
        with self._lock:
            if self._fh is not None:
                self._fh.write(line + "\n")

    def log_event(self, event: dict) -> None:
        """Append one record to the JSONL twin of the text log."""
        if not self.enabled:
            return
        with self._lock:
            if self._events_fh is not None:
                self._events_fh.write(json.dumps(event) + "\n")

    def close(self) -> None:
        with self._lock:
            for fh in (self._fh, self._events_fh):
                if fh is not None:
                    fh.close()
            self._fh = None
            self._events_fh = None
