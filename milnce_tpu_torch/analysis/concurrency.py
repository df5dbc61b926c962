"""graftlint Pass 3a for the PyTorch port: pure-AST concurrency analysis
of the serving and obs thread mesh (the JAX package's Pass 3, with
PyTorch's device verbs).

The serving and observability layers are a multithreaded system (batcher
workers, HTTP request threads, the live index's ingest thread, data readers
and the train loop share mutable state behind ``threading`` locks), so
this pass turns races into failing tests:

- **GL010 unguarded-shared-state** — per class, infer the shared mutable
  attributes (assigned in ``__init__``, reachable from >= 2 thread
  roots) and the guard map (which lock protects which attribute, from
  ``with self._lock:`` blocks plus explicit ``# guarded-by: <lock>``
  annotations), then flag writes outside the guard always, and lock-free
  reads of guarded attributes unless the attribute is write-once in
  ``__init__``;
- **GL011 lock-order-cycle** — the static lock-acquisition graph (lock B
  acquired while A is held, through same-module calls and across
  modules via imported module-level locks) must have no cycle;
- **GL012 blocking-under-lock** — ``future.result()``, ``.join()`` /
  ``.wait()``, ``open()``, ``time.sleep()`` or a device verb while
  holding a lock.  The device verbs are PyTorch's: ``.to(device)``,
  ``.cuda()``, ``.cpu()``, ``.item()``, ``torch.cuda.synchronize()``,
  ``Event.synchronize()`` and a call of a model (a callee named
  ``model``/``*_model``).  They are exempt under locks whose name holds
  ``dispatch``: serializing device work is ``DEVICE_DISPATCH_LOCK``'s
  job (``serving/engine.py``).

It imports no torch and is heuristic by design.  The runtime twin, a
lock that checks the same order on live threads, is
:mod:`milnce_tpu_torch.analysis.lockrt`.

Annotation syntax (parsed from real comment tokens, like suppressions):

- on an ``__init__`` assignment line, ``# guarded-by: _lock`` declares
  the attribute's guard explicitly;
- on a ``def`` line (or the line above), ``# guarded-by: _lock``
  declares that callers hold ``_lock`` for the whole method.

A ``guarded-by`` naming a lock the module does not declare is a GL000.
The per-class guard map is each :class:`ClassReport`.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field

from milnce_tpu_torch.analysis.rules import RULES
from milnce_tpu_torch.analysis.astlint import Finding, _terminal_and_root

# Constructors that make an attribute/module global a lock (threading's,
# plus the sanitizer's drop-ins and the env-switched factory).
_LOCK_CTORS = {"Lock", "RLock", "SanitizedLock", "SanitizedRLock",
               "make_lock"}
# Class-scope triggers: constructing worker threads / reader pools, or
# serving HTTP (one handler thread per connection).
_THREAD_CTORS = {"Thread"}
_POOL_CTORS = {"ThreadPoolExecutor"}
_HTTP_METHOD = re.compile(r"^do_[A-Z]+$")
# An imported ALL-CAPS name containing LOCK is treated as a module-level
# lock defined by the import's source module (DEVICE_DISPATCH_LOCK).
_IMPORTED_LOCK = re.compile(r"^[A-Z_]*LOCK[A-Z_]*$")
_GUARDED_BY = re.compile(r"#\s*guarded-by:\s*(?P<lock>[A-Za-z_]\w*)")

# GL012 verb sets.  `.join`/`.wait` only count with thread-ish args
# (no args, a numeric timeout, or a timeout= kwarg) so `"x".join(parts)`
# and `os.path.join(a, b)` never trip it.
_BLOCK_METHOD_VERBS = {"result", "join", "wait"}
_DEVICE_VERBS = {"cuda", "cpu", "item", "synchronize"}
_MODEL_CALLEE = re.compile(r"(^|_)model$")


def _device_verb(call: ast.Call, terminal: str | None) -> bool:
    """A PyTorch call that waits on the card or dispatches to it."""
    if not isinstance(call.func, ast.Attribute):
        return bool(terminal) and bool(_MODEL_CALLEE.search(terminal))
    if terminal in _DEVICE_VERBS:
        return terminal != "cpu" or not call.args
    if terminal == "to":
        for arg in list(call.args) + [k.value for k in call.keywords]:
            text = ast.unparse(arg)
            if "device" in text or re.match(r"['\"](cuda|cpu)", text):
                return True
        return False
    return bool(_MODEL_CALLEE.search(terminal or ""))


def _module_key(path: str) -> str:
    base = os.path.basename(path)
    return base[:-3] if base.endswith(".py") else base


def _guard_comments(src: str) -> dict[int, str]:
    """line -> lock name for every real ``# guarded-by:`` comment."""
    out: dict[int, str] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(src).readline)
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                m = _GUARDED_BY.search(tok.string)
                if m:
                    out[tok.start[0]] = m.group("lock")
    except (tokenize.TokenError, SyntaxError):  # pragma: no cover
        pass
    return out


@dataclass
class LockGraph:
    """Static lock-order graph: edge (A, B) = "B acquired while A held",
    with the first acquisition site kept per edge.  Merged across every
    module in the lint scope before cycle detection, so an AB / BA split
    across two files still fails."""

    edges: dict = field(default_factory=dict)   # (src, dst) -> (path, line)

    def add(self, src: str, dst: str, path: str, line: int) -> None:
        key = (src, dst)
        if key not in self.edges or (path, line) < self.edges[key]:
            self.edges[key] = (path, line)

    def merge(self, other: "LockGraph") -> None:
        for (src, dst), (path, line) in other.edges.items():
            self.add(src, dst, path, line)

    @property
    def locks(self) -> set:
        return {n for edge in self.edges for n in edge}

    def cycle_findings(self) -> list[Finding]:
        """One GL011 finding per strongly-connected component (plus
        self-loops), anchored at the latest acquisition site in the
        cycle — the edge that *inverted* the established order."""
        adj: dict[str, set] = {}
        for (src, dst) in self.edges:
            adj.setdefault(src, set()).add(dst)
            adj.setdefault(dst, set())
        sccs = _tarjan(adj)
        findings = []
        for comp in sorted(sccs, key=lambda c: sorted(c)):
            comp = set(comp)
            internal = sorted(
                (u, v, self.edges[(u, v)]) for (u, v) in self.edges
                if u in comp and v in comp)
            if len(comp) == 1 and not any(u == v for u, v, _ in internal):
                continue
            anchor = max(site for _, _, site in internal)
            chain = "; ".join(f"{u} -> {v} @ {site[0]}:{site[1]}"
                              for u, v, site in internal)
            findings.append(Finding(
                anchor[0], anchor[1], RULES["GL011"],
                f"lock-order cycle among {sorted(comp)} — some thread "
                f"interleaving deadlocks (acquisition edges: {chain})"))
        return findings


def _tarjan(adj: dict) -> list[list]:
    """Strongly-connected components, iterative (lint runs on arbitrary
    user modules — no recursion-limit surprises)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set = set()
    stack: list = []
    out: list[list] = []
    counter = [0]

    for root in sorted(adj):
        if root in index:
            continue
        work = [(root, iter(sorted(adj[root])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(adj[nxt]))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)
    return out


# ---------------------------------------------------------------------------
# per-function walk
# ---------------------------------------------------------------------------

@dataclass
class _Access:
    attr: str
    write: bool
    line: int
    held: tuple


@dataclass
class _CallSite:
    callee: tuple          # ("func", name) | ("method", m) | ("ctor", Cls)
    line: int
    held: tuple


@dataclass
class _Blocking:
    verb: str
    line: int
    held: tuple
    device: bool


@dataclass
class _FnReport:
    accesses: list = field(default_factory=list)
    calls: list = field(default_factory=list)
    blocking: list = field(default_factory=list)
    direct_locks: set = field(default_factory=set)
    edges: list = field(default_factory=list)      # (src, dst, line)
    spawn_targets: set = field(default_factory=set)
    uses_threads: bool = False


class _FnWalker:
    """Walks one function/method body tracking the set of held locks."""

    def __init__(self, lock_resolver, initial_held: tuple = ()):
        self._resolve = lock_resolver        # expr -> lock id | None
        self.report = _FnReport()
        self._initial = initial_held

    def walk(self, fn: ast.FunctionDef) -> _FnReport:
        self._stmts(fn.body, self._initial)
        return self.report

    # ---- statements ------------------------------------------------------

    def _stmts(self, body: list, held: tuple) -> None:
        for stmt in body:
            self._stmt(stmt, held)

    def _stmt(self, stmt: ast.stmt, held: tuple) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = held
            for item in stmt.items:
                self._expr(item.context_expr, inner)
                lk = self._resolve(item.context_expr)
                if lk is not None:
                    for h in inner:
                        self.report.edges.append((h, lk, stmt.lineno))
                    self.report.direct_locks.add(lk)
                    inner = inner + (lk,)
            self._stmts(stmt.body, inner)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: runs later, on whatever thread calls it — no
            # inherited lock context; accesses still count toward the
            # enclosing method (spawn closures touch shared state)
            self._stmts(stmt.body, ())
            return
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            # a bare annotation (`self.x: int`, no value) assigns nothing
            if not (isinstance(stmt, ast.AnnAssign) and stmt.value is None):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    self._write_target(t, held)
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                self._write_target(t, held)
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.stmt):
                self._stmt(node, held)
            elif isinstance(node, ast.expr):
                self._expr(node, held)
            elif isinstance(node, ast.ExceptHandler):
                self._stmts(node.body, held)

    def _write_target(self, target: ast.expr, held: tuple) -> None:
        """self.x = / self.x[...] = / del self.x — container item
        assignment mutates the attribute's value; method calls on an
        attribute are deliberately NOT writes (opaque: `.inc()` on a
        registry counter is internally locked)."""
        if self._is_self_attr(target):
            self.report.accesses.append(
                _Access(target.attr, True, target.lineno, held))
        elif (isinstance(target, ast.Subscript)
                and self._is_self_attr(target.value)):
            self.report.accesses.append(
                _Access(target.value.attr, True, target.lineno, held))
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._write_target(elt, held)

    @staticmethod
    def _is_self_attr(node: ast.expr) -> bool:
        return (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self")

    # ---- expressions -----------------------------------------------------

    def _expr(self, expr: ast.expr, held: tuple) -> None:
        for node in ast.walk(expr):
            if (self._is_self_attr(node)
                    and isinstance(node.ctx, ast.Load)):
                self.report.accesses.append(
                    _Access(node.attr, False, node.lineno, held))
            elif isinstance(node, ast.Call):
                self._call(node, held)

    def _call(self, call: ast.Call, held: tuple) -> None:
        terminal, root = _terminal_and_root(call.func)
        # `.acquire()` on a resolvable lock counts as holding it from
        # here on is NOT modeled (manual acquire/release pairs are rare
        # — the codebase idiom is `with`); it still counts as an
        # acquisition edge and a scope trigger.
        if terminal == "acquire" and isinstance(call.func, ast.Attribute):
            lk = self._resolve(call.func.value)
            if lk is not None:
                for h in held:
                    self.report.edges.append((h, lk, call.lineno))
                self.report.direct_locks.add(lk)
        if terminal in _THREAD_CTORS or terminal in _POOL_CTORS:
            self.report.uses_threads = True
        # spawn targets: Thread(target=self.m) / pool.submit(self.m, ..)
        if terminal in _THREAD_CTORS:
            for kw in call.keywords:
                if kw.arg == "target" and self._is_self_attr(kw.value):
                    self.report.spawn_targets.add(kw.value.attr)
        if terminal == "submit" and call.args \
                and self._is_self_attr(call.args[0]):
            self.report.spawn_targets.add(call.args[0].attr)
        # callee resolution for interprocedural lock propagation
        if self._is_self_attr(call.func):
            self.report.calls.append(
                _CallSite(("method", call.func.attr), call.lineno, held))
        elif isinstance(call.func, ast.Name):
            self.report.calls.append(
                _CallSite(("name", call.func.id), call.lineno, held))
        # GL012 blocking verbs
        blocking = None
        device = False
        if _device_verb(call, terminal):
            blocking, device = f"{terminal}()", True
        elif (terminal in _BLOCK_METHOD_VERBS
                and isinstance(call.func, ast.Attribute)
                and self._threadish_args(call)):
            blocking = f".{terminal}()"
        elif terminal == "sleep" and root == "time":
            blocking = "time.sleep()"
        elif terminal == "open" and isinstance(call.func, ast.Name):
            blocking = "open()"
        if blocking and held:
            self.report.blocking.append(
                _Blocking(blocking, call.lineno, held, device))

    @staticmethod
    def _threadish_args(call: ast.Call) -> bool:
        """join/wait/result signatures: no args, a numeric timeout, or a
        timeout= kwarg.  `sep.join(parts)` / `os.path.join(a, b)` have
        non-numeric positional args and never match."""
        if any(kw.arg == "timeout" for kw in call.keywords):
            return True
        if not call.args and not call.keywords:
            return True
        return (len(call.args) == 1 and not call.keywords
                and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, (int, float)))


# ---------------------------------------------------------------------------
# per-class analysis
# ---------------------------------------------------------------------------

@dataclass
class ClassReport:
    """The inferred threading model of one class (also the data behind
    the guard-map CLI)."""

    module: str
    name: str
    in_scope: bool
    roots: list
    lock_attrs: list
    guards: dict            # attr -> lock id ('' = unguarded)
    write_once: set
    shared: set             # attrs reachable from >= 2 roots


class _ModulePass:
    def __init__(self, src: str, path: str):
        self.src = src
        self.path = path
        self.mod = _module_key(path)
        self.tree = ast.parse(src)
        self.comments = _guard_comments(src)
        self.findings: list[Finding] = []
        self.graph = LockGraph()
        self.class_reports: list[ClassReport] = []
        # module-level locks: own definitions + imported LOCK names
        self.module_locks: dict[str, str] = {}
        self.module_funcs: dict[str, ast.FunctionDef] = {}
        self.classes: dict[str, ast.ClassDef] = {}
        self._discover()

    # ---- discovery -------------------------------------------------------

    @staticmethod
    def _is_lock_ctor(value: ast.expr) -> bool:
        if not isinstance(value, ast.Call):
            return False
        terminal, _root = _terminal_and_root(value.func)
        return terminal in _LOCK_CTORS

    def _discover(self) -> None:
        for node in self.tree.body:
            if isinstance(node, ast.Assign) and self._is_lock_ctor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.module_locks[t.id] = f"{self.mod}:{t.id}"
            elif isinstance(node, ast.ImportFrom) and node.module:
                src_mod = node.module.split(".")[-1]
                for alias in node.names:
                    name = alias.asname or alias.name
                    if _IMPORTED_LOCK.match(alias.name):
                        self.module_locks[name] = f"{src_mod}:{alias.name}"
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.module_funcs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node

    # ---- run -------------------------------------------------------------

    def run(self) -> None:
        fn_reports: dict[tuple, _FnReport] = {}
        # module-level functions
        for name, fn in self.module_funcs.items():
            rep = self._walk_fn(fn, None, set())
            fn_reports[("func", name)] = rep
            for src, dst, line in rep.edges:
                self.graph.add(src, dst, self.path, line)
        for cname, cls in self.classes.items():
            self._run_class(cname, cls, fn_reports)
        self._interprocedural_edges(fn_reports)
        self._emit_gl012(fn_reports)

    def _walk_fn(self, fn, cls_name, lock_attrs) -> _FnReport:
        resolver = self._make_resolver(cls_name, lock_attrs)
        initial = ()
        guard = self._method_guard(fn, cls_name, lock_attrs)
        if guard:
            initial = (guard,)
        return _FnWalker(resolver, initial).walk(fn)

    def _make_resolver(self, cls_name, lock_attrs):
        def resolve(expr):
            if (isinstance(expr, ast.Attribute)
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"
                    and expr.attr in lock_attrs):
                return f"{self.mod}:{cls_name}.{expr.attr}"
            if isinstance(expr, ast.Name) and expr.id in self.module_locks:
                return self.module_locks[expr.id]
            return None
        return resolve

    def _resolve_guard_name(self, name, cls_name, lock_attrs, line):
        """A ``guarded-by:`` lock name -> canonical id; unknown names
        are GL000 findings (annotations must not typo-rot)."""
        if name in lock_attrs:
            return f"{self.mod}:{cls_name}.{name}"
        if name in self.module_locks:
            return self.module_locks[name]
        self.findings.append(Finding(
            self.path, line, RULES["GL000"],
            f"guarded-by names unknown lock {name!r} (declare the lock "
            "in this module, or fix the annotation)"))
        return None

    def _method_guard(self, fn, cls_name, lock_attrs):
        for line in (fn.lineno, fn.lineno - 1):
            name = self.comments.get(line)
            if name:
                return self._resolve_guard_name(name, cls_name, lock_attrs,
                                                line)
        return None

    # ---- class analysis --------------------------------------------------

    def _run_class(self, cname, cls, fn_reports) -> None:
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        init = methods.get("__init__")
        init_attrs: dict[str, int] = {}
        lock_attrs: set = set()
        annotated: dict[str, str] = {}
        if init is not None:
            for node in ast.walk(init):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    init_attrs.setdefault(t.attr, t.lineno)
                    if node.value is not None \
                            and self._is_lock_ctor(node.value):
                        lock_attrs.add(t.attr)
        # annotations ride the __init__ assignment lines
        for attr, line in init_attrs.items():
            name = self.comments.get(line)
            if name and attr not in lock_attrs:
                guard = self._resolve_guard_name(name, cname, lock_attrs,
                                                 line)
                if guard:
                    annotated[attr] = guard

        reports = {}
        for mname, fn in methods.items():
            rep = self._walk_fn(fn, cname, lock_attrs)
            reports[mname] = rep
            fn_reports[("method", cname, mname)] = rep
            for src, dst, line in rep.edges:
                self.graph.add(src, dst, self.path, line)

        in_scope = self._class_in_scope(methods, reports)
        roots = self._thread_roots(methods, reports)
        reach = self._attr_reachability(methods, reports, roots)
        guards, write_once, shared = self._guard_map(
            init_attrs, lock_attrs, annotated, reports, reach)
        self.class_reports.append(ClassReport(
            self.mod, cname, in_scope, sorted(roots), sorted(
                f"{self.mod}:{cname}.{a}" for a in lock_attrs),
            guards, write_once, shared))
        if in_scope:
            self._emit_gl010(cname, init_attrs, lock_attrs, reports,
                             guards, write_once, shared)

    def _class_in_scope(self, methods, reports) -> bool:
        """Thread-shared classes only: the class spawns threads or a
        reader pool, serves HTTP (one thread per connection), or one of
        its methods acquires a lock (owning a lock IS declaring that
        concurrent callers exist)."""
        if any(_HTTP_METHOD.match(m) for m in methods):
            return True
        return any(r.uses_threads or r.direct_locks
                   for r in reports.values())

    @staticmethod
    def _thread_roots(methods, reports) -> set:
        roots = {m for m in methods
                 if not m.startswith("_") or _HTTP_METHOD.match(m)}
        for rep in reports.values():
            roots.update(t for t in rep.spawn_targets if t in methods)
        roots.discard("__init__")
        return roots

    @staticmethod
    def _attr_reachability(methods, reports, roots) -> dict:
        """attr -> set of roots whose transitive same-class call
        closure touches it (reads or writes; ``__init__`` excluded —
        construction is single-threaded by contract)."""
        out: dict[str, set] = {}
        for root in roots:
            seen = set()
            queue = [root]
            while queue:
                m = queue.pop()
                if m in seen or m not in reports:
                    continue
                seen.add(m)
                rep = reports[m]
                for acc in rep.accesses:
                    out.setdefault(acc.attr, set()).add(root)
                for call in rep.calls:
                    if call.callee[0] == "method" \
                            and call.callee[1] in methods:
                        queue.append(call.callee[1])
        return out

    @staticmethod
    def _guard_map(init_attrs, lock_attrs, annotated, reports, reach):
        """Infer attr -> guard: the most common lock held across the
        attribute's locked non-``__init__`` writes; explicit
        ``guarded-by`` annotations win.  write-once = never directly
        written outside ``__init__``."""
        writes: dict[str, list] = {a: [] for a in init_attrs}
        for mname, rep in reports.items():
            if mname == "__init__":
                continue
            for acc in rep.accesses:
                if acc.write and acc.attr in writes:
                    writes[acc.attr].append(acc)
        guards: dict[str, str] = {}
        write_once: set = set()
        shared: set = set()
        for attr in init_attrs:
            if attr in lock_attrs:
                continue
            if not writes[attr]:
                write_once.add(attr)
            if len(reach.get(attr, ())) >= 2:
                shared.add(attr)
            if attr in annotated:
                guards[attr] = annotated[attr]
                continue
            counts: dict[str, int] = {}
            for acc in writes[attr]:
                for lk in acc.held:
                    counts[lk] = counts.get(lk, 0) + 1
            if counts:
                guards[attr] = max(sorted(counts), key=lambda k: counts[k])
        return guards, write_once, shared

    def _emit_gl010(self, cname, init_attrs, lock_attrs, reports,
                    guards, write_once, shared) -> None:
        emitted: set = set()

        def emit(attr, line, msg):
            if (attr, line) not in emitted:       # one finding per
                emitted.add((attr, line))         # attr-line (a += hits
                self.findings.append(Finding(     # read+write at once)
                    self.path, line, RULES["GL010"], msg))

        for mname, rep in sorted(reports.items()):
            if mname == "__init__":
                continue
            # writes first: a line that both reads and writes reports
            # as the (stronger) write finding
            for acc in sorted(rep.accesses,
                              key=lambda a: (a.line, not a.write)):
                attr = acc.attr
                if attr in lock_attrs or attr not in init_attrs:
                    continue
                guard = guards.get(attr)
                if guard:
                    if acc.write and guard not in acc.held:
                        emit(attr, acc.line,
                             f"{cname}.{attr} written outside its guard "
                             f"{guard} (in {mname}) — racing every "
                             "guarded access")
                    elif (not acc.write and guard not in acc.held
                            and attr not in write_once):
                        emit(attr, acc.line,
                             f"lock-free read of {cname}.{attr} (guard: "
                             f"{guard}, in {mname}) — not write-once, so "
                             "the read races the guarded writes")
                elif attr in shared and acc.write and not acc.held:
                    touched = "/".join(sorted(
                        self._methods_touching(attr, reports)))
                    emit(attr, acc.line,
                         f"unguarded write to shared {cname}.{attr} "
                         f"(in {mname}; touched from {touched}, "
                         "reachable from >= 2 thread roots) — add a lock "
                         "or a guarded-by annotation")

    @staticmethod
    def _methods_touching(attr, reports):
        return {m for m, rep in reports.items()
                if any(a.attr == attr for a in rep.accesses)
                and m != "__init__"}

    # ---- interprocedural lock edges -------------------------------------

    def _interprocedural_edges(self, fn_reports) -> None:
        """Locks acquired by a callee count as acquired at a locked call
        site: ``with A: self.helper()`` where helper takes B adds the
        A -> B edge.  Same-module resolution only (bare names, self
        methods, ClassName() constructors)."""
        memo: dict[tuple, set] = {}

        def locks_of(key, trail):
            if key in memo:
                return memo[key]
            if key in trail or key not in fn_reports:
                return set()
            rep = fn_reports[key]
            out = set(rep.direct_locks)
            for call in rep.calls:
                for ck in self._candidate_keys(key, call):
                    out |= locks_of(ck, trail | {key})
            memo[key] = out
            return out

        for key, rep in fn_reports.items():
            for call in rep.calls:
                if not call.held:
                    continue
                for ck in self._candidate_keys(key, call):
                    for lk in locks_of(ck, {key}):
                        for h in call.held:
                            if h != lk:
                                self.graph.add(h, lk, self.path, call.line)

    def _candidate_keys(self, caller_key, call):
        kind, name = call.callee
        if kind == "method" and caller_key[0] == "method":
            yield ("method", caller_key[1], name)
        elif kind == "name":
            if name in self.module_funcs:
                yield ("func", name)
            if name in self.classes:
                yield ("method", name, "__init__")

    # ---- GL012 -----------------------------------------------------------

    def _emit_gl012(self, fn_reports) -> None:
        for key, rep in sorted(fn_reports.items()):
            where = key[-1] if key[0] != "method" else f"{key[1]}.{key[2]}"
            for b in rep.blocking:
                if b.device and all("dispatch" in h.lower()
                                    for h in b.held):
                    continue    # serializing dispatch is that lock's job
                self.findings.append(Finding(
                    self.path, b.line, RULES["GL012"],
                    f"{b.verb} while holding {b.held[-1]} (in {where}) — "
                    "every contender stalls for the full "
                    + ("device dispatch" if b.device else "blocking call")))


def lint_concurrency_source(src: str, path: str = "<string>"
                            ) -> tuple[list[Finding], LockGraph,
                                       list[ClassReport]]:
    """Pass 3a for one module: (findings [GL010/GL012 + annotation
    GL000s], this module's lock graph, per-class reports).  GL011 cycle
    findings come from the MERGED graph — the caller (astlint) detects
    cycles after merging every module in scope."""
    mp = _ModulePass(src, path)
    mp.run()
    mp.findings.sort(key=lambda f: (f.line, f.rule.id))
    return mp.findings, mp.graph, mp.class_reports
