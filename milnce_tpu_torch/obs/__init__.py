"""Observability of the PyTorch port (port of ``milnce_tpu/obs/``: the
same metric names, span and event names, attribute keys and the
``milnce.obs/v1`` snapshot schema, so the JAX package's readers and
``scripts/obs_report.py`` read the port's artifacts unchanged):

- :mod:`milnce_tpu_torch.obs.metrics` — process-wide, thread-safe typed
  registry (Counter / Gauge / Histogram, labeled families);
- :mod:`milnce_tpu_torch.obs.spans` — monotonic-clock span/event
  recorder (append-only ``RUN_EVENTS.jsonl`` + in-memory ring, opt-in
  ``torch.profiler.record_function`` bridge);
- :mod:`milnce_tpu_torch.obs.export` — Prometheus text exposition and
  the versioned JSON snapshot;
- :mod:`milnce_tpu_torch.obs.runctx` — ``run_id`` + ``process_index``
  (the rank) stamped on every record and snapshot;
- :mod:`milnce_tpu_torch.obs.goodput` — the goodput ledger: run wall
  time partitioned into compute / data-wait / checkpoint / skipped /
  rollback-lost badput categories;
- :mod:`milnce_tpu_torch.obs.anomaly` /
  :mod:`milnce_tpu_torch.obs.capture` — EWMA spike detection arming a
  bounded one-shot ``torch.profiler`` capture;
- :mod:`milnce_tpu_torch.obs.aggregate` — merging the ranks' views
  (summed counters, min/median/max gauges, straggler skew).

Recording is host-side only and never adds a device sync: nothing here
imports torch at module scope, and recording a CUDA tensor is a
:class:`TypeError`, not a silent ``float()`` sync.
"""

from milnce_tpu_torch.obs import export, metrics, spans  # noqa: F401
