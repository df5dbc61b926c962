"""Runtime lock sanitizer (port of ``milnce_tpu/analysis/lockrt.py``, the
same classes, names and environment variables; pure stdlib).

Static analysis sees the lock-acquisition *sites*; it cannot see
orderings assembled dynamically (callbacks, injected ``run_batch``
callables, locks reached through an attribute the AST can't resolve).
:class:`SanitizedLock` closes that gap the way the kernel's lockdep
does: every acquisition records an ordering edge *held -> acquired*
into a process-wide graph keyed by lock **name** (lock classes, not
instances — two batchers' children locks share one discipline), and an
acquisition that would close a cycle raises :class:`LockOrderError`
immediately — at the inversion site, on the first run that exhibits the
ordering, *without* needing the actual interleaving that deadlocks.

What it catches:

- **ABBA inversions** — thread 1 takes A then B, thread 2 takes B then
  A: the second ordering raises even if the threads never actually
  interleave into the deadlock;
- **self-deadlock** — re-acquiring a non-reentrant lock on the same
  thread raises instead of hanging;
- **hold-time pathologies** — an optional per-lock budget raises
  :class:`LockHoldBudgetExceeded` on release when a critical section
  ran long (device work or file I/O smuggled under a lock request
  threads contend on).

Opt-in wiring: the serving locks (``serving/``: the device dispatch
lock, the engine's and index's stats, the cache, the batcher's) are
created through :func:`make_lock`, which returns a plain
``threading.Lock`` unless ``MILNCE_LOCK_SANITIZE=1`` is set in the
environment **at construction time** (module-level locks therefore need
the variable set before import).  ``MILNCE_LOCK_HOLD_BUDGET_MS`` sets a
global hold budget for ``make_lock`` locks; unset means no budget.

Limitations (documented, deliberate):

- edges are keyed by lock *name*: two instances sharing a name share an
  order class (that is the point — per-instance orders that are safe by
  construction should use distinct names);
- acquire/release are assumed to happen on the same thread (true for
  every ``with`` use; a cross-thread release leaves a stale held-stack
  entry on the acquiring thread);
- the graph only grows — a deliberately re-ordered lock hierarchy needs
  :func:`reset_global_graph` (tests) or a process restart (production).
"""

from __future__ import annotations

import os
import sys
import threading
import time

ENV_SANITIZE = "MILNCE_LOCK_SANITIZE"
ENV_HOLD_BUDGET_MS = "MILNCE_LOCK_HOLD_BUDGET_MS"


class LockOrderError(RuntimeError):
    """Acquisition would close a cycle in the lock-order graph (a
    latent ABBA deadlock), or re-acquire a non-reentrant lock on the
    holding thread (a certain deadlock)."""


class LockHoldBudgetExceeded(RuntimeError):
    """A critical section outlived its configured hold budget."""


def _caller_site() -> str:
    """file:line of the first frame outside this module (the
    acquisition site recorded on order-graph edges)."""
    frame = sys._getframe(1)
    here = __file__
    while frame is not None and frame.f_code.co_filename == here:
        frame = frame.f_back
    if frame is None:  # pragma: no cover - only under exotic embedding
        return "<unknown>"
    return f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"


class LockOrderGraph:
    """Process-wide ordering graph: edge u -> v means "v was acquired
    while u was held".  A cycle means some interleaving deadlocks."""

    def __init__(self):
        self._meta = threading.Lock()      # guards _edges/_sites; never
        self._edges: dict[str, set] = {}   # sanitized (it IS the sanitizer)
        self._sites: dict[tuple, str] = {}

    def _path(self, src: str, dst: str) -> list | None:
        """Edge-path src ->* dst, or None (iterative DFS; called with
        the meta lock held)."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in sorted(self._edges.get(node, ())):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def check_acquire(self, held: list, name: str, site: str) -> None:
        """Record held->name edges; raise :class:`LockOrderError` if any
        edge would close a cycle (checked BEFORE blocking on the lock,
        so the violation surfaces even when no deadlock materializes)."""
        with self._meta:
            for h in held:
                if h == name:
                    continue
                cycle = self._path(name, h)
                if cycle is not None:
                    chain = " -> ".join(cycle + [name])
                    sites = "; ".join(
                        f"{u}->{v} @ {self._sites.get((u, v), '?')}"
                        for u, v in zip(cycle, cycle[1:]))
                    raise LockOrderError(
                        f"lock-order cycle: acquiring {name!r} at {site} "
                        f"while holding {h!r} inverts the established "
                        f"order {chain} (established: {sites}) — some "
                        "interleaving of these threads deadlocks")
            for h in held:
                if h != name and name not in self._edges.setdefault(h,
                                                                    set()):
                    self._edges[h].add(name)
                    self._sites[(h, name)] = site

    def snapshot(self) -> dict:
        """{'edges': [[u, v, first-site], ...]} sorted — for tests and
        the hammer's "sanitizer actually engaged" assertion."""
        with self._meta:
            return {"edges": sorted(
                [u, v, self._sites.get((u, v), "?")]
                for u, vs in self._edges.items() for v in vs)}

    def reset(self) -> None:
        with self._meta:
            self._edges.clear()
            self._sites.clear()


GLOBAL_GRAPH = LockOrderGraph()


def reset_global_graph() -> None:
    """Clear the process-wide order graph (test isolation)."""
    GLOBAL_GRAPH.reset()


_tls = threading.local()


def _held_stack() -> list:
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


class SanitizedLock:
    """Drop-in for ``threading.Lock`` that records per-thread
    acquisition stacks into the process-wide order graph and raises on
    a would-be cycle, a same-thread re-acquire, or (optionally) a
    blown hold-time budget.

    - ``name``: the lock's order *class* (defaults to the creation
      site) — instances sharing a name share ordering discipline;
    - ``hold_budget_s``: max seconds a holder may keep the lock;
      exceeded -> :class:`LockHoldBudgetExceeded` raised on release
      (after the lock is actually released — never wedges others);
    - ``graph``: injectable order graph (tests); default process-wide.
    """

    _REENTRANT = False

    def __init__(self, name: str | None = None, *,
                 hold_budget_s: float | None = None,
                 graph: LockOrderGraph | None = None):
        self._inner = threading.RLock() if self._REENTRANT \
            else threading.Lock()
        self.name = name if name else _caller_site()
        self.hold_budget_s = hold_budget_s
        self._graph = graph if graph is not None else GLOBAL_GRAPH

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held_stack()
        depth = sum(1 for entry in held if entry[0] is self)
        if depth and not self._REENTRANT and blocking:
            # a blocking re-acquire deadlocks for certain; a trylock on
            # a self-held lock legally returns False (stdlib semantics)
            raise LockOrderError(
                f"self-deadlock: thread {threading.current_thread().name!r} "
                f"re-acquiring non-reentrant lock {self.name!r} it already "
                "holds")
        if not depth and blocking:
            # trylocks are exempt from ordering (lockdep parity): a
            # failed non-blocking acquire can never participate in a
            # deadlock, and recording its edge would poison the graph
            # for the avoid-deadlock-by-trylock pattern
            self._graph.check_acquire(
                [entry[1] for entry in held], self.name, _caller_site())
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            held.append((self, self.name, time.monotonic()))
        return ok

    def release(self) -> None:
        held = _held_stack()
        t0 = None
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                t0 = held.pop(i)[2]
                break
        self._inner.release()
        if (t0 is not None and self.hold_budget_s is not None):
            dt = time.monotonic() - t0
            if dt > self.hold_budget_s:
                raise LockHoldBudgetExceeded(
                    f"{self.name!r} held {dt * 1e3:.1f} ms > budget "
                    f"{self.hold_budget_s * 1e3:.1f} ms — move the blocking "
                    "work outside the critical section")

    def __enter__(self) -> "SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self.release()
        except LockHoldBudgetExceeded:
            # an exception already unwinding through the with-block is
            # the root cause — the budget report must not replace it
            if exc_type is None:
                raise

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return bool(locked()) if locked is not None else False


class SanitizedRLock(SanitizedLock):
    """Reentrant variant: same-thread re-acquires are legal and do not
    re-check ordering (only the outermost acquire orders)."""

    _REENTRANT = True


def sanitizing_enabled() -> bool:
    return os.environ.get(ENV_SANITIZE, "") == "1"


def make_lock(name: str):
    """THE lock factory of the serving thread mesh.

    Plain ``threading.Lock`` by default (zero overhead in production);
    a :class:`SanitizedLock` carrying ``name`` when
    ``MILNCE_LOCK_SANITIZE=1`` is set at construction time.  Naming is
    what makes the order graph readable — pick stable dotted roles
    (``serving.device_dispatch``, ``obs.metrics.counter``)."""
    if not sanitizing_enabled():
        return threading.Lock()
    budget_ms = float(os.environ.get(ENV_HOLD_BUDGET_MS, "") or 0.0)
    # <= 0 (incl. an explicit "0") disables the budget — a 0.0-second
    # budget would raise on essentially every release
    return SanitizedLock(
        name, hold_budget_s=budget_ms / 1e3 if budget_ms > 0 else None)
