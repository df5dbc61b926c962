"""Process-wide, thread-safe typed metrics registry (port of
``milnce_tpu/obs/metrics.py``, same names, types and exposition).

Three metric types, Prometheus-shaped on purpose (export.py renders the
text exposition straight off these objects):

- :class:`Counter` — monotonically increasing (requests, failures);
- :class:`Gauge` — set-to-current-value (loss, learning rate), with an
  optional collect-time callback for values that live elsewhere (e.g.
  the serving engine's ``recompiles()``, the cache hit rate);
- :class:`Histogram` — fixed bucket edges given at creation (batch
  occupancy, latencies); cumulative bucket counts at exposition.

Every metric belongs to a *family* (name + help + label names); a family
with no labels has exactly one child and the registry helpers return the
child directly so the common case reads ``REG.counter(...).inc()``.

Hard invariants:

- **host-side only**: recording a tensor that lives on a CUDA device
  raises ``TypeError`` instead of letting a ``float()`` smuggle a device
  sync into a hot path.  Train-side values are fed from numbers the
  loop already holds on the host (train/loop.py).
- **thread-safe**: every mutation takes the metric's lock (decode
  failures arrive from reader threads, serving counters from request
  threads and the batcher worker — the exact race the old ``/healthz``
  dict had); the hammer test in tests/test_obs.py pins exact final
  counts under contention.

No torch, no numpy — pure stdlib, importable anywhere.  Every lock is
a plain ``threading.Lock``.
"""

from __future__ import annotations

import threading
import bisect
from typing import Callable, Optional, Sequence


METRIC_TYPES = ("counter", "gauge", "histogram")


def _host_number(value) -> float:
    """Reject device tensors at the recording boundary: ``float()`` of a
    CUDA tensor is a blocking device sync — exactly the class of hidden
    stall this registry must never introduce.  Host numbers (int, float,
    numpy scalars, CPU tensors) pass through."""
    if getattr(value, "is_cuda", False):
        raise TypeError(
            "refusing to record a device tensor: metrics recording is "
            "host-side only (fetch it on the host first)")
    return float(value)


class Counter:
    """Monotonic counter child.  ``inc(amount)`` with ``amount >= 0``."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        amount = _host_number(amount)
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Set-to-current-value child; ``fn`` makes it collect-time computed
    (reads delegate to the callback, ``set`` becomes an error).

    ``_fn`` shares ``_value``'s guard: ``bind()`` arrives from component
    (re)construction while scrape threads read — an unlocked swap raced
    both.  The callback itself is invoked OUTSIDE the
    lock: callbacks read other components' stats (engine recompiles,
    cache hit rate) that take their own locks, and calling through while
    holding ours would put this gauge's lock above every one of theirs
    in the lock order for no benefit."""

    __slots__ = ("_lock", "_value", "_fn")

    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def set(self, value: float) -> None:
        value = _host_number(value)
        with self._lock:
            if self._fn is not None:
                raise ValueError("callback gauge: the value comes from its "
                                 "fn at collect time, set() is meaningless")
            self._value = value

    def inc(self, amount: float = 1.0) -> None:
        amount = _host_number(amount)
        with self._lock:
            if self._fn is not None:
                raise ValueError("callback gauge cannot be incremented")
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-_host_number(amount))

    def bind(self, fn: Callable[[], float]) -> None:
        """(Re)bind the collect-time callback — create-or-get semantics
        mean a long-lived registry may outlive the object a callback
        reads; the latest binding wins."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        # callbacks go through the same host-side-only boundary as
        # set(): a callback returning a device array would otherwise
        # smuggle a blocking sync into every scrape/snapshot
        return _host_number(fn())


class Histogram:
    """Fixed-bucket histogram child.

    ``edges`` are the ascending upper bounds of the finite buckets; an
    implicit +Inf bucket catches the rest.  ``counts()`` returns
    per-bucket (non-cumulative) counts — export.py cumulates for the
    Prometheus ``le`` convention."""

    __slots__ = ("edges", "_lock", "_counts", "_sum", "_count")

    def __init__(self, edges: Sequence[float]):
        edges = tuple(float(e) for e in edges)
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"histogram edges must be non-empty and "
                             f"strictly ascending, got {edges}")
        self.edges = edges
        self._lock = threading.Lock()
        self._counts = [0] * (len(edges) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = _host_number(value)
        i = bisect.bisect_left(self.edges, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"edges": list(self.edges),
                    "counts": list(self._counts),
                    "sum": self._sum, "count": self._count}

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum


class Family:
    """name + type + help + label names -> children keyed by label values."""

    def __init__(self, name: str, mtype: str, help: str,
                 labelnames: tuple = (), edges: Sequence[float] = ()):
        assert mtype in METRIC_TYPES, mtype
        self.name = name
        self.type = mtype
        self.help = help
        self.labelnames = tuple(labelnames)
        self.edges = tuple(edges)
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}
        if not self.labelnames:          # unlabeled: materialize the child
            self.labels()

    def _make_child(self):
        if self.type == "counter":
            return Counter()
        if self.type == "gauge":
            return Gauge()
        return Histogram(self.edges)

    def labels(self, **labelvalues):
        """Child for this label-value combination (created on first use).
        Label names must match the family's declaration exactly."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labelvalues)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def items(self):
        """[(label-values tuple, child)] in creation order."""
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Create-or-get registry of metric families.

    Re-registering an existing name with the same (type, labelnames,
    edges) returns the existing family — module-level call sites and
    repeated component construction in one process stay idempotent; a
    conflicting re-registration raises (two meanings for one exposition
    name is exactly the incompatible-schema mess this subsystem ends).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}

    def _family(self, name: str, mtype: str, help: str, labels: tuple,
                edges: Sequence[float] = ()) -> Family:
        labels = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, mtype, help, labels, edges)
                self._families[name] = fam
                return fam
        if (fam.type, fam.labelnames, fam.edges) != (mtype, labels,
                                                     tuple(edges)):
            raise ValueError(
                f"metric {name!r} already registered as {fam.type}"
                f"{fam.labelnames} buckets={fam.edges}; conflicting "
                f"re-registration as {mtype}{labels} buckets={tuple(edges)}")
        return fam

    def counter(self, name: str, help: str = "", labels: tuple = ()):
        """Unlabeled: returns the Counter child; labeled: the Family
        (call ``.labels(...)`` for children)."""
        fam = self._family(name, "counter", help, labels)
        return fam if labels else fam.labels()

    def gauge(self, name: str, help: str = "", labels: tuple = (),
              fn: Optional[Callable[[], float]] = None):
        fam = self._family(name, "gauge", help, labels)
        if labels:
            if fn is not None:
                raise ValueError("callback gauges are unlabeled (bind fn "
                                 "on the child instead)")
            return fam
        child = fam.labels()
        if fn is not None:
            child.bind(fn)
        return child

    def histogram(self, name: str, help: str = "", *,
                  buckets: Sequence[float], labels: tuple = ()):
        fam = self._family(name, "histogram", help, labels, buckets)
        return fam if labels else fam.labels()

    def collect(self) -> list[Family]:
        with self._lock:
            return list(self._families.values())


# ---------------------------------------------------------------------------
# the process-wide default registry
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry()


def registry() -> MetricsRegistry:
    """THE process-wide registry: train loop, data pipeline, fault
    injection and the ``milnce-serve`` CLI all record here, so one
    scrape/snapshot answers "what is this process doing".  Components
    that need isolation (tests, multiple service instances in one
    process) construct a private :class:`MetricsRegistry` instead."""
    return _DEFAULT
