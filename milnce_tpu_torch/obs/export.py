"""Exposition: Prometheus text format + the versioned JSON snapshot (port
of ``milnce_tpu/obs/export.py``: the same text and the same
``milnce.obs/v1`` schema, so the JAX package's readers and
``scripts/obs_report.py`` read the port's artifacts).

Two render targets off the same registry:

- :func:`to_prometheus` — text exposition (format 0.0.4) for pull-based
  scraping (``GET /metrics`` on the serving front);
- :func:`snapshot` — the versioned JSON document every artifact in this
  repo now shares (``schema`` = :data:`SNAPSHOT_SCHEMA`, ``kind``
  discriminates producers): registry snapshots, ``SERVE_BENCH_*.json``
  (scripts/serve_bench.py), the train bench line (bench.py).  One
  schema means ``scripts/obs_report.py`` can summarize and
  regression-gate any of them.

Format notes (pinned by the exposition golden in tests/test_obs.py):
integral values print without a decimal point; histogram buckets follow
the Prometheus cumulative-``le`` convention with a ``+Inf`` bucket and
``_sum`` / ``_count`` series; label values are escaped per the spec.
"""

from __future__ import annotations

import json
import math

from milnce_tpu_torch.obs import runctx
from milnce_tpu_torch.obs.metrics import MetricsRegistry

SNAPSHOT_SCHEMA = "milnce.obs/v1"

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v: float) -> str:
    f = float(v)
    if not math.isfinite(f):
        # legal Prometheus sample values (a guarded train window's loss
        # gauge is nan by construction) — one non-finite sample must
        # never 500 the whole scrape
        return "NaN" if math.isnan(f) else ("+Inf" if f > 0 else "-Inf")
    return str(int(f)) if f == int(f) else repr(f)


def _escape(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _labelstr(names: tuple, values: tuple, extra: tuple = ()) -> str:
    pairs = [f'{n}="{_escape(str(v))}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(str(v))}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def to_prometheus(registry: MetricsRegistry) -> str:
    lines: list[str] = []
    for fam in registry.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.type}")
        for values, child in fam.items():
            if fam.type in ("counter", "gauge"):
                lines.append(f"{fam.name}"
                             f"{_labelstr(fam.labelnames, values)} "
                             f"{_fmt(child.value)}")
                continue
            snap = child.snapshot()
            cum = 0
            for edge, n in zip(snap["edges"], snap["counts"]):
                cum += n
                lines.append(
                    f"{fam.name}_bucket"
                    f"{_labelstr(fam.labelnames, values, (('le', _fmt(edge)),))}"
                    f" {cum}")
            cum += snap["counts"][-1]
            lines.append(
                f"{fam.name}_bucket"
                f"{_labelstr(fam.labelnames, values, (('le', '+Inf'),))}"
                f" {cum}")
            lines.append(f"{fam.name}_sum"
                         f"{_labelstr(fam.labelnames, values)} "
                         f"{_fmt(snap['sum'])}")
            lines.append(f"{fam.name}_count"
                         f"{_labelstr(fam.labelnames, values)} "
                         f"{snap['count']}")
    return "\n".join(lines) + "\n"


def snapshot(registry: MetricsRegistry, kind: str = "metrics",
             extra: dict | None = None, run_id: str | None = None,
             process_index: int | None = None) -> dict:
    """Versioned JSON document of the registry's current state.

    ``kind`` names the producer (``metrics`` for a raw registry dump;
    serve_bench / bench stamp their own).  ``extra`` merges additional
    top-level keys (latency tables, run config) — the ``schema`` /
    ``kind`` / ``metrics`` keys are reserved.

    Run identity: the document is stamped with ``run_id`` +
    ``process_index`` from the installed run context (obs/runctx.py) —
    every artifact-producing entry point installs one, so pod-level
    aggregation (obs/aggregate.py) can verify same-run/distinct-process
    before merging.  Explicit keyword args override the context."""
    metrics: dict = {}
    for fam in registry.collect():
        values = []
        for labelvalues, child in fam.items():
            labels = dict(zip(fam.labelnames, labelvalues))
            if fam.type == "histogram":
                values.append({"labels": labels, **child.snapshot()})
            else:
                values.append({"labels": labels, "value": child.value})
        metrics[fam.name] = {"type": fam.type, "help": fam.help,
                             "values": values}
    doc = {"schema": SNAPSHOT_SCHEMA, "kind": kind, "metrics": metrics}
    ctx_run, ctx_pi = runctx.get_run_context()
    run_id = run_id if run_id is not None else ctx_run
    process_index = process_index if process_index is not None else ctx_pi
    if run_id is not None:
        doc["run_id"] = str(run_id)
    if process_index is not None:
        doc["process_index"] = int(process_index)
    for k, v in (extra or {}).items():
        if k in doc:
            raise ValueError(f"snapshot extra key {k!r} is reserved")
        doc[k] = v
    return doc


def write_snapshot(path: str, registry: MetricsRegistry,
                   kind: str = "metrics", extra: dict | None = None,
                   run_id: str | None = None,
                   process_index: int | None = None) -> dict:
    doc = snapshot(registry, kind, extra, run_id=run_id,
                   process_index=process_index)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return doc
