"""Pod-level telemetry aggregation: N per-process views -> one pod view
(port of ``milnce_tpu/obs/aggregate.py``; a process is a rank).

A pod run produces one snapshot / event stream PER PROCESS (each host
records only what it saw — the host-side-only invariant means there is
deliberately no cross-host collective in the telemetry path).  This
module merges them after the fact:

- :func:`merge_snapshots` — N ``milnce.obs/v1`` documents (same run,
  distinct processes) -> one ``pod_<kind>`` document: counters summed
  across hosts, gauges reported as min/median/max (a pod gauge has no
  single true value — the spread IS the signal), histograms summed
  bucket-wise, and every shared numeric top-level extra (qps, clips/s,
  ``goodput_fraction``, ``mfu``...) carried as its median with the
  spread alongside — so ``obs_report --check`` gates the pod view with
  the same gate metrics as a single-process artifact.
- :func:`merge_event_streams` — N record streams -> per-process step
  stats + **straggler detection**: cross-host step-span skew (max/min
  of per-process step p50) with the slow hosts named.  One straggler
  chip sets the pace of every collective — the skew number says which
  host to look at before anyone stares at a profile.

Both refuse loudly on mixed ``run_id``s or duplicate
``process_index``es (obs/runctx.py tagging): merging across runs or
double-counting a host produces confident nonsense, which is worse
than an error.  Stdlib-only, like the rest of ``obs/``.
"""

from __future__ import annotations

from milnce_tpu_torch.obs.export import SNAPSHOT_SCHEMA
from milnce_tpu_torch.obs.goodput import split_runs

# default skew ratio above which a host is called a straggler: p50 step
# span > STRAGGLER_RATIO * the fastest host's p50
STRAGGLER_RATIO = 1.25


def _median(vals: list) -> float:
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    return (vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2.0)


def _check_identity(docs: list, what: str) -> tuple:
    """Verify same-run / distinct-process across the inputs; returns
    (run_id, sorted process indices)."""
    if len(docs) < 2:
        raise ValueError(f"pod merge needs >= 2 {what}, got {len(docs)}")
    run_ids = {d.get("run_id") for d in docs}
    if None in run_ids:
        raise ValueError(
            f"{what} without a run_id tag cannot be pod-merged — "
            "regenerate with the current tools (OBSERVABILITY.md "
            "'Run identity')")
    if len(run_ids) > 1:
        raise ValueError(
            f"mixed-run merge refused: {what} carry run_ids "
            f"{sorted(run_ids)} — a pod view spans ONE run")
    pis = [d.get("process_index") for d in docs]
    if None in pis:
        raise ValueError(f"{what} without a process_index tag cannot "
                         "be pod-merged")
    if len(set(pis)) != len(pis):
        raise ValueError(
            f"duplicate process_index in merge inputs ({sorted(pis)}) — "
            "the same host's view counted twice is not a pod view")
    return run_ids.pop(), sorted(pis)


def merge_snapshots(docs: list) -> dict:
    """N same-run, distinct-process ``milnce.obs/v1`` docs -> one
    ``pod_<kind>`` doc (schema unchanged, so obs_report gates it)."""
    for d in docs:
        if d.get("schema") != SNAPSHOT_SCHEMA:
            raise ValueError(f"cannot merge unversioned/foreign doc "
                             f"(schema {d.get('schema')!r})")
    kinds = {d.get("kind") for d in docs}
    if len(kinds) > 1:
        raise ValueError(f"cannot merge snapshots of different kinds "
                         f"{sorted(kinds)}")
    kind = kinds.pop()
    run_id, pis = _check_identity(docs, "snapshots")

    merged_metrics: dict = {}
    names = sorted({n for d in docs for n in (d.get("metrics") or {})})
    for name in names:
        fams = [d["metrics"][name] for d in docs
                if name in (d.get("metrics") or {})]
        mtype = fams[0]["type"]
        if any(f["type"] != mtype for f in fams):
            raise ValueError(f"metric {name!r} has conflicting types "
                             "across processes")
        # children keyed by their label dict (JSON-stable)
        by_label: dict = {}
        for fam in fams:
            for v in fam["values"]:
                key = tuple(sorted(v["labels"].items()))
                by_label.setdefault(key, []).append(v)
        values = []
        for key, vs in sorted(by_label.items()):
            labels = dict(key)
            if mtype == "counter":
                values.append({"labels": labels,
                               "value": sum(v["value"] for v in vs)})
            elif mtype == "gauge":
                nums = [float(v["value"]) for v in vs]
                values.append({"labels": labels,
                               "value": _median(nums),
                               "min": min(nums), "max": max(nums),
                               "processes": len(nums)})
            else:                       # histogram: bucket-wise sum
                edges = vs[0]["edges"]
                if any(v["edges"] != edges for v in vs):
                    raise ValueError(
                        f"histogram {name!r} has mismatched bucket edges "
                        "across processes — not mergeable")
                counts = [sum(col) for col in
                          zip(*(v["counts"] for v in vs))]
                values.append({"labels": labels, "edges": edges,
                               "counts": counts,
                               "sum": sum(v["sum"] for v in vs),
                               "count": sum(v["count"] for v in vs)})
        merged_metrics[name] = {"type": mtype, "help": fams[0]["help"],
                                "values": values}

    out = {"schema": SNAPSHOT_SCHEMA, "kind": f"pod_{kind}",
           "run_id": run_id, "processes": len(docs),
           "process_indices": pis, "metrics": merged_metrics}

    # top-level numeric extras shared by every process: median at the
    # gate key (obs_report reads it exactly like a single-process doc),
    # spread alongside so a pod gate failure is attributable to a host
    reserved = {"schema", "kind", "metrics", "run_id", "process_index"}
    spread: dict = {}
    for key in sorted(set(docs[0]) - reserved):
        vals = [d.get(key) for d in docs]
        if all(isinstance(v, (int, float)) and not isinstance(v, bool)
               for v in vals):
            nums = [float(v) for v in vals]
            out[key] = _median(nums)
            spread[key] = {"min": min(nums), "median": _median(nums),
                           "max": max(nums)}
    if spread:
        out["spread"] = spread
    return out


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return float("nan")
    if len(sorted_vals) == 1:
        return float(sorted_vals[0])
    pos = (q / 100.0) * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac)


def merge_event_streams(streams: list,
                        straggler_ratio: float = STRAGGLER_RATIO) -> dict:
    """N per-process record streams -> pod step-time view + stragglers.

    Each stream must be single-run (same run across all) and
    single-process; ``straggler_ratio`` is the p50 multiple over the
    fastest host above which a host is flagged."""
    docs = []
    for records in streams:
        runs = split_runs(records)
        if len(runs) != 1:
            raise ValueError(
                f"stream holds {len(runs)} runs "
                f"({sorted(str(k) for k in runs)}) — split on run_id "
                "first (obs_report --run-id)")
        pis = {r.get("process_index") for r in records} - {None}
        docs.append({
            "run_id": next(iter(runs)),
            "process_index": pis.pop() if len(pis) == 1 else None,
            "records": records,
        })
    run_id, pis = _check_identity(docs, "event streams")

    per_process: dict = {}
    for d in docs:
        durs = sorted(float(r.get("dur_ms", 0.0)) for r in d["records"]
                      if r.get("kind") == "span" and r.get("name") == "step")
        per_process[d["process_index"]] = {
            "steps": len(durs),
            "step_ms_p50": round(_percentile(durs, 50), 4),
            "step_ms_p99": round(_percentile(durs, 99), 4),
        }
    p50s = {pi: s["step_ms_p50"] for pi, s in per_process.items()
            if s["steps"] > 0}
    if not p50s:
        raise ValueError("no step spans in any stream — nothing to skew")
    fastest = min(p50s.values())
    skew = (max(p50s.values()) / fastest) if fastest > 0 else float("inf")
    stragglers = sorted(pi for pi, p in p50s.items()
                        if fastest > 0 and p > straggler_ratio * fastest)
    return {"run_id": run_id, "processes": len(docs),
            "process_indices": pis, "per_process": per_process,
            "step_p50_skew": round(skew, 4),
            "straggler_ratio": straggler_ratio,
            "stragglers": stragglers}
