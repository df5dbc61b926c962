"""Deterministic fault-injection registry (port of
``milnce_tpu/resilience/faults.py``: the same spec grammar, site names,
schedule semantics, ``MILNCE_FAULTS`` variable and
``milnce_faults_injected_total`` counter).

At HowTo100M pod scale, corrupt files, wedged ffmpeg pipes, flaky
checkpoint storage and loss blow-ups are steady-state conditions, not
incidents.  The failure paths — bounded resample, decode watchdog,
finite-update guard, checkpoint retry — are only trustworthy if tests
can *drive* them; this module makes every failure injectable on a
reproducible schedule, so one spec drives the same recovery in both
packages.

Training sites, fired where the JAX package fires them:

- ``decode.raise``     host; the decode entry raises :class:`InjectedFault`
                       (``data/synthetic.py`` ``sample``, ``data/video.py``
                       ``sample_clip``; exercises the source's bounded
                       resample).
- ``decode.hang``      host; the decode entry sleeps ``x`` seconds
                       (exercises the loader watchdog; default x=5).
- ``ckpt.save_ioerror`` host; the checkpoint save raises ``OSError``
                       inside its retry (``train/checkpoint.py``).
- ``grad.nonfinite``   step; the train step multiplies the reduced
                       gradients by NaN on scheduled optimizer steps
                       (``train/step.py``; exercises the finite-update
                       guard and the rollback).  Read when the step is
                       built; the occurrence is the optimizer step number
                       ``step + 1``, which counts skipped steps and goes on
                       across a resume (the step is handed the restored
                       count).

- ``host.preempt``     host; the drain controller's once-a-step poll
                       latches a drain (``elastic/drain.py``); the
                       occurrence is the run's step number.
- ``host.slow``        host; the step sleeps ``x`` seconds inside its
                       ``step`` span (``train/loop.py``; default x=0.05),
                       a slow rank for the straggler policy.

Serving sites, fired where the JAX engine fires them
(``serving/engine.py``, before each dispatch takes the lock):

- ``serve.dispatch_raise`` host; the dispatch raises
                       :class:`InjectedFault`.
- ``serve.dispatch_hang``  host; the dispatch sleeps ``x`` seconds.
- ``serve.replica_dead``   host; the engine kills itself and raises
                       ``ReplicaDead`` (every later dispatch too).

Live-index sites (``serving/live_index.py``):

- ``index.swap_raise``  host; the build raises just before publishing
                       its generation (the old one keeps serving, the
                       rows are re-queued).
- ``index.ingest_hang`` host; an ``add`` caller sleeps ``x`` seconds
                       (the query path is untouched).

Spec grammar (config ``train.faults`` or env ``MILNCE_FAULTS``)::

    spec   := clause (';' clause)*
    clause := site '@' sched [':x=' float]
    sched  := '*'            every occurrence
            | '%' N          every Nth occurrence
            | i(,j,k...)     exact 1-based occurrence indices

For host sites an "occurrence" is the Nth invocation of the site in this
process (counted under a lock — decode sites fire from reader threads).

Zero overhead disarmed: every site call is one function call and a
module-global ``None`` check.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from milnce_tpu_torch.obs import metrics as obs_metrics

KNOWN_SITES = ("decode.raise", "decode.hang", "ckpt.save_ioerror",
               "grad.nonfinite", "serve.dispatch_raise",
               "serve.dispatch_hang", "serve.replica_dead",
               "index.swap_raise", "index.ingest_hang",
               "host.preempt", "host.slow")

# Process-wide injection telemetry (OBSERVABILITY.md): chaos drills and
# failure-rate dashboards read how often each site actually fired.
_INJECTED = obs_metrics.registry().counter(
    "milnce_faults_injected_total",
    "fault-site occurrences that fired (scheduled hits)", ("site",))

ENV_VAR = "MILNCE_FAULTS"


class InjectedFault(RuntimeError):
    """Raised by an armed ``maybe_raise`` site."""


@dataclass
class SiteSpec:
    site: str
    mode: str                    # 'at' | 'every' | 'all'
    at: tuple[int, ...] = ()
    every: int = 0
    x: float = 0.0               # site parameter (hang sleep seconds)
    hits: int = field(default=0, compare=False)

    def scheduled(self, n: int) -> bool:
        """Does the 1-based occurrence index ``n`` fire?"""
        if self.mode == "all":
            return True
        if self.mode == "every":
            return n % self.every == 0
        return n in self.at


def parse_spec(spec: str) -> dict[str, SiteSpec]:
    """'site@sched[:x=F];...' -> {site: SiteSpec}.  Unknown sites and
    malformed schedules raise ValueError — a typo'd fault spec must fail
    the run at arm time, not silently inject nothing."""
    out: dict[str, SiteSpec] = {}
    for clause in filter(None, (c.strip() for c in spec.split(";"))):
        if "@" not in clause:
            raise ValueError(f"fault clause {clause!r} missing '@sched' "
                             "(grammar: site@sched[:x=float])")
        site, _, sched = clause.partition("@")
        site = site.strip()
        if site not in KNOWN_SITES:
            raise ValueError(f"unknown fault site {site!r} "
                             f"(sites: {', '.join(KNOWN_SITES)})")
        x = 0.0
        if ":" in sched:
            sched, _, param = sched.partition(":")
            key, _, val = param.partition("=")
            if key.strip() != "x":
                raise ValueError(f"unknown fault parameter {key!r} in "
                                 f"{clause!r} (only ':x=float')")
            x = float(val)
        sched = sched.strip()
        if sched == "*":
            out[site] = SiteSpec(site, "all", x=x)
        elif sched.startswith("%"):
            n = int(sched[1:])
            if n < 1:
                raise ValueError(f"bad every-N schedule in {clause!r}")
            out[site] = SiteSpec(site, "every", every=n, x=x)
        else:
            at = tuple(int(i) for i in sched.split(","))
            if not at or any(i < 1 for i in at):
                raise ValueError(f"bad occurrence indices in {clause!r} "
                                 "(1-based)")
            out[site] = SiteSpec(site, "at", at=at, x=x)
    return out


class FaultRegistry:
    def __init__(self, spec: str):
        self.sites = parse_spec(spec)
        self._lock = threading.Lock()

    def fire(self, site: str) -> SiteSpec | None:
        """Count one occurrence of ``site``; return its spec if this
        occurrence is scheduled to fail."""
        s = self.sites.get(site)
        if s is None:
            return None
        with self._lock:
            s.hits += 1
            n = s.hits
        if not s.scheduled(n):
            return None
        _INJECTED.labels(site=site).inc()
        return s


_registry: FaultRegistry | None = None
_env_checked = False


def _active() -> FaultRegistry | None:
    global _registry, _env_checked
    if _registry is None and not _env_checked:
        _env_checked = True
        spec = os.environ.get(ENV_VAR, "")
        if spec:
            _registry = FaultRegistry(spec)
    return _registry


def arm(spec: str) -> FaultRegistry:
    """Install a registry from ``spec`` (replacing any active one)."""
    global _registry, _env_checked
    _env_checked = True          # explicit arming overrides the env
    _registry = FaultRegistry(spec)
    return _registry


def disarm() -> None:
    global _registry, _env_checked
    _env_checked = True          # a disarm must stay disarmed
    _registry = None


@contextmanager
def armed(spec: str):
    """Test helper: arm for the block, always disarm after."""
    reg = arm(spec)
    try:
        yield reg
    finally:
        disarm()


def maybe_raise(site: str, exc_type: type = InjectedFault) -> None:
    """Raise ``exc_type`` if ``site`` is armed and this occurrence is
    scheduled.  ``exc_type`` lets the call site match the failure class
    its handler is built for (OSError for checkpoint I/O)."""
    reg = _active()
    if reg is None:
        return
    s = reg.fire(site)
    if s is not None:
        raise exc_type(f"injected fault at {site} (occurrence {s.hits})")


def maybe_hang(site: str, default_sleep: float = 5.0) -> None:
    """Sleep ``x`` (spec parameter) seconds if scheduled — a stand-in for
    a wedged decode pipe, long enough to trip the loader watchdog."""
    reg = _active()
    if reg is None:
        return
    s = reg.fire(site)
    if s is not None:
        time.sleep(s.x or default_sleep)


def fire_site(site: str) -> bool:
    """Count one occurrence of ``site``; True when this occurrence is
    scheduled to fail — for call sites whose failure response is not an
    exception or a sleep (e.g. ``serve.replica_dead`` flips the engine's
    dead flag)."""
    reg = _active()
    if reg is None:
        return False
    return reg.fire(site) is not None


def device_schedule(site: str) -> SiteSpec | None:
    """The spec for the step's site (``grad.nonfinite``), or None when
    disarmed.  Read when the step is built: the step tests the schedule
    against its own optimizer-step count on the host, so firing costs no
    device sync."""
    reg = _active()
    return None if reg is None else reg.sites.get(site)
