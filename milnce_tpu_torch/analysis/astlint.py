"""graftlint Pass 1 for the PyTorch port: a pure-AST lint.

It imports no ``torch`` (nor anything but the standard library and the
rule catalogue), so ``python -m milnce_tpu_torch.analysis --check
--no-trace`` costs milliseconds from a cold interpreter.  The analysis
is intra-module and heuristic; audited exceptions carry an inline
suppression with a reason::

    lr = float(x)  # graftlint: disable=GL001(display-cadence, audited)

Scopes the rules rely on:

- **hot region** (GL001): the body of a ``for`` loop over
  ``device_prefetch(...)``, or of a loop that draws its batches with
  ``next()`` from a name bound to ``device_prefetch(...)`` (the port's
  loop, ``train/loop.py``), plus the transitive closure of same-module
  functions called by bare name from inside it.
- **step scope** (GL002, GL003, GL006, GL008): methods named ``forward``
  or ``backward`` (``nn.Module.forward``, ``autograd.Function``), every
  method of a class in ``train/step.py``, and every function nested in a
  ``make_*step`` factory.  Their tensor parameters are tainted (not
  ``self``/``ctx``, not one with a constant default or a non-tensor
  annotation), and so is every name assigned from a tainted expression;
  ``.shape``/``.dtype``/``.device``-like reads, ``len()``/
  ``isinstance()`` and ``is``/``is not`` comparisons break the taint.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass

from milnce_tpu_torch.analysis.rules import RULES, Rule, resolve_rule

# Attribute reads and method calls that give host data of a tensor
# without reading its values.
_TAINT_BREAKERS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_meta",
                   "requires_grad", "grad_fn", "layout", "training",
                   "is_leaf", "names"}
_STATIC_METHODS = {"size", "dim", "numel", "element_size", "is_contiguous",
                   "data_ptr", "stride", "storage_offset", "nelement",
                   "is_floating_point", "get_device"}
_STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "getattr", "id",
                 "callable"}
# annotations that mark a parameter as host data, not a tensor
_HOST_ANNOTATIONS = {"int", "float", "bool", "str", "bytes", "tuple",
                     "list", "dict", "None"}

# Host-sync verbs (GL001).
_SYNC_BARE = {"float", "int", "bool", "complex"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}

# Observability recording verbs (GL008): methods of a registry metric or
# span recorder (obs/).  ``set`` is left out: ``gauge.set(v)`` and
# ``x.set_(v)`` are too common to tell apart without types.
_OBS_RECORDING = {"span", "event", "observe", "inc", "dec", "log_event"}

# GL009: the canonical mesh-dimension names (config.py ParallelConfig);
# a DeviceMesh construction's ``mesh_dim_names`` in the same module
# extends the set.
_CANONICAL_MESH_AXES = {"data", "model"}
_MESH_LOOKUPS = {"get_group", "get_local_rank", "get_coordinate"}

_NP_ROOTS = {"np", "numpy"}
_FLOAT_DEFAULT_CTORS = {"zeros", "ones", "empty", "linspace", "eye",
                        "full", "arange"}

# Entry-level rules (the planner's GL013-GL015, the numerics gates GL016
# and GL018) attach to registered trace entries, never to source lines:
# an inline suppression of one is a GL000.  The sanctioned route is a
# re-pin of the tables in analysis/memplan.py or analysis/numerics.py.
_ENTRY_LEVEL_RULES = frozenset({"GL013", "GL014", "GL015",
                                "GL016", "GL018"})

_SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*disable=(?P<body>.+)$")
_ITEM_RE = re.compile(r"\s*(?P<rule>[A-Za-z0-9_-]+)\s*(?:\((?P<reason>.*)\))?\s*$")


@dataclass
class Suppression:
    line: int
    rule_id: str            # normalized to the GLnnn id
    reason: str
    standalone: bool        # comment-only line: applies to the line below


@dataclass
class Finding:
    path: str
    line: int
    rule: Rule
    message: str
    suppressed: bool = False
    suppress_reason: str = ""

    def format(self) -> str:
        tag = f" [suppressed: {self.suppress_reason}]" if self.suppressed else ""
        return (f"{self.path}:{self.line}: {self.rule.id} "
                f"({self.rule.name}) {self.message}{tag}")


def _comment_tokens(src: str):
    """(lineno, comment_text, standalone) for every real COMMENT token —
    tokenizing (rather than regexing lines) keeps docstrings and strings
    that merely *mention* the suppression syntax from parsing as one."""
    import io
    import tokenize

    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(src).readline))
    except (tokenize.TokenError, SyntaxError):  # pragma: no cover
        return
    for tok in tokens:
        if tok.type == tokenize.COMMENT:
            line_prefix = tok.line[:tok.start[1]]
            yield tok.start[0], tok.string, line_prefix.strip() == ""


def parse_suppressions(src: str, path: str) -> tuple[list[Suppression],
                                                     list[Finding]]:
    """Collect ``# graftlint: disable=RULE(reason)[,...]`` comments.

    Malformed items (unknown rule, missing reason) become GL000 findings —
    a suppression that doesn't document itself suppresses nothing."""
    sups: list[Suppression] = []
    bad: list[Finding] = []
    for lineno, text, standalone in _comment_tokens(src):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        # split on commas OUTSIDE parens so reasons may contain commas
        body, items, depth, cur = m.group("body"), [], 0, ""
        for ch in body:
            depth += ch == "("
            depth -= ch == ")"
            if ch == "," and depth == 0:
                items.append(cur)
                cur = ""
            else:
                cur += ch
        items.append(cur)
        for item in items:
            im = _ITEM_RE.match(item)
            rule = resolve_rule(im.group("rule")) if im else None
            reason = (im.group("reason") or "").strip() if im else ""
            if rule is None:
                bad.append(Finding(path, lineno, RULES["GL000"],
                                   f"unknown rule in suppression: {item.strip()!r}"))
            elif rule.id in _ENTRY_LEVEL_RULES:
                bad.append(Finding(
                    path, lineno, RULES["GL000"],
                    f"suppression of {rule.id} ({rule.name}): entry-level "
                    "planner/numerics rules never fire on source lines — "
                    "re-pin the expectation table in analysis/memplan.py "
                    "or analysis/numerics.py instead"))
            elif not reason:
                bad.append(Finding(path, lineno, RULES["GL000"],
                                   f"suppression of {rule.id} carries no reason "
                                   "(write disable=RULE(reason))"))
            else:
                sups.append(Suppression(lineno, rule.id, reason, standalone))
    return sups, bad


def _terminal_and_root(node: ast.expr) -> tuple[str | None, str | None]:
    """('synchronize', 'torch') for torch.cuda.synchronize; a bare Name
    returns (name, name)."""
    if isinstance(node, ast.Name):
        return node.id, node.id
    if isinstance(node, ast.Attribute):
        terminal = node.attr
        cur = node.value
        while isinstance(cur, ast.Attribute):
            cur = cur.value
        return terminal, (cur.id if isinstance(cur, ast.Name) else None)
    return None, None


class _TaintCheck(ast.NodeVisitor):
    """Does this expression's value depend on a tainted (tensor) name?
    Descent stops at metadata reads, static calls and identity
    comparisons."""

    def __init__(self, tainted: set):
        self.tainted = tainted
        self.hit = False

    def visit_Name(self, node: ast.Name) -> None:
        if node.id in self.tainted:
            self.hit = True

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr in _TAINT_BREAKERS:
            return
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        terminal, _ = _terminal_and_root(node.func)
        if terminal in _STATIC_CALLS:
            return
        if (isinstance(node.func, ast.Attribute)
                and terminal in _STATIC_METHODS):
            return
        self.generic_visit(node)


def _expr_tainted(node: ast.expr, tainted: set) -> bool:
    chk = _TaintCheck(tainted)
    chk.visit(node)
    return chk.hit


def _assigned_names(target: ast.expr):
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            yield n.id


def _tensor_params(fn) -> set:
    """The parameters of ``fn`` taken for tensors: not self/ctx/cls, not
    one with a constant default, not one annotated as host data."""
    args = fn.args
    positional = args.posonlyargs + args.args
    defaults = dict(zip([a.arg for a in positional[len(positional)
                                                   - len(args.defaults):]],
                        args.defaults))
    defaults.update({a.arg: d for a, d in zip(args.kwonlyargs,
                                              args.kw_defaults)
                     if d is not None})
    out = set()
    for a in positional + args.kwonlyargs:
        if a.arg in ("self", "ctx", "cls"):
            continue
        if isinstance(defaults.get(a.arg), ast.Constant):
            continue
        if a.annotation is not None:
            text = ast.unparse(a.annotation)
            if "Tensor" not in text and (
                    set(re.findall(r"\w+", text)) & _HOST_ANNOTATIONS
                    or "Config" in text):
                continue
        out.add(a.arg)
    return out


class _ModuleLint:
    def __init__(self, src: str, path: str):
        self.src = src
        self.path = path
        self.parts = path.replace("\\", "/").split("/")
        self.tree = ast.parse(src)
        self.findings: list[Finding] = []
        self.imports_torch = bool(re.search(
            r"^\s*(import torch|from torch)", src, re.M))
        self.defs: dict[str, list] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs.setdefault(node.name, []).append(node)
        self.step_roots = self._discover_step_scope()

    def _emit(self, rule_id: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(self.path, node.lineno,
                                     RULES[rule_id], message))

    # ---- step scope --------------------------------------------------

    def _discover_step_scope(self) -> list:
        """The outermost step-scope functions (nested defs are walked
        from them)."""
        roots, seen = [], set()
        step_module = self.parts[-2:] == ["train", "step.py"]

        def add(fn):
            if id(fn) not in seen:
                seen.add(id(fn))
                roots.append(fn)

        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if not isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                        continue
                    if item.name == "__init__":
                        continue        # build time, not a step
                    if step_module or item.name in ("forward", "backward"):
                        add(item)
            elif (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and re.fullmatch(r"make_\w*step", node.name)):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        add(item)
        return roots

    def check_step_scope(self) -> None:
        for fn in self.step_roots:
            self._check_step_fn(fn, _tensor_params(fn))

    def _check_step_fn(self, fn, inherited: set) -> None:
        tainted = set(inherited)
        for stmt in fn.body:
            self._walk_step_stmt(stmt, tainted)

    def _walk_step_stmt(self, stmt: ast.stmt, tainted: set) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._check_step_fn(stmt, tainted | _tensor_params(stmt))
            return
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            value = stmt.value
            if value is not None and _expr_tainted(value, tainted):
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    tainted.update(_assigned_names(t))
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._check_step_exprs(item.context_expr, tainted)
        if isinstance(stmt, ast.If) and _expr_tainted(stmt.test, tainted):
            self._emit("GL002", stmt,
                       "Python `if` on a tensor value in step scope: a "
                       "hidden host sync a step — use torch.where or "
                       "decide at build time")
        elif (isinstance(stmt, ast.While)
                and _expr_tainted(stmt.test, tainted)):
            self._emit("GL002", stmt,
                       "Python `while` on a tensor value in step scope: a "
                       "host sync an iteration")
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.stmt):
                self._walk_step_stmt(node, tainted)
            elif isinstance(node, ast.expr):
                self._check_step_exprs(node, tainted)

    def _check_step_exprs(self, node: ast.expr, tainted: set) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.IfExp) and _expr_tainted(sub.test, tainted):
                self._emit("GL002", sub,
                           "conditional expression on a tensor value in "
                           "step scope — use torch.where")
            elif isinstance(sub, ast.Call):
                terminal, _ = _terminal_and_root(sub.func)
                args = list(sub.args) + [k.value for k in sub.keywords]
                hot = any(_expr_tainted(a, tainted) for a in args)
                if (isinstance(sub.func, ast.Name) and terminal == "print"
                        and hot):
                    self._emit("GL006", sub,
                               "print() of a tensor in step scope formats "
                               "its values: a host sync a step")
                elif (isinstance(sub.func, ast.Attribute)
                        and terminal in _OBS_RECORDING and hot):
                    self._emit("GL008", sub,
                               f".{terminal}() of a tensor in step scope "
                               "converts it on the host: a sync a call — "
                               "record at display cadence")
            if isinstance(sub, (ast.ListComp, ast.GeneratorExp,
                                ast.SetComp, ast.DictComp)):
                self._check_state_copy(sub)

    def _check_state_copy(self, comp) -> None:
        """GL003: a comprehension over the parameters, a state_dict or
        the optimizer's state that clones or deep-copies its elements."""
        iters = " ".join(ast.unparse(g.iter) for g in comp.generators)
        if not re.search(r"parameters\(|state_dict\(|\.state\b", iters):
            return
        body = (ast.unparse(comp.value) if isinstance(comp, ast.DictComp)
                else ast.unparse(comp.elt))
        if re.search(r"\.clone\(|deepcopy\(|\.detach\(\)\.copy_\(", body):
            self._emit("GL003", comp,
                       "a per-step copy of the parameters or optimizer "
                       "state in step scope doubles the state's bytes at "
                       "the peak")

    def check_state_deepcopy(self) -> None:
        """GL003's call form in step scope: deepcopy(<...state_dict()...>)
        or deepcopy(<...parameters()...>)."""
        for fn in self.step_roots:
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                terminal, _ = _terminal_and_root(node.func)
                if terminal == "deepcopy" and node.args and re.search(
                        r"parameters\(|state_dict\(|optimizer\.state",
                        ast.unparse(node.args[0])):
                    self._emit("GL003", node,
                               "deepcopy of the parameters or optimizer "
                               "state in step scope")

    # ---- GL001: hot-region host syncs ---------------------------------

    def _prefetch_names(self) -> set:
        names = set()
        for node in ast.walk(self.tree):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and "device_prefetch" in ast.unparse(node.value.func)):
                for t in node.targets:
                    names.update(_assigned_names(t))
        return names

    def check_hot_regions(self) -> None:
        names = self._prefetch_names()
        hot_bodies: list[list[ast.stmt]] = []
        for node in ast.walk(self.tree):
            if isinstance(node, ast.For):
                it = ast.unparse(node.iter)
                if "device_prefetch" in it or it in names:
                    hot_bodies.append(node.body)
            elif isinstance(node, ast.While) and names:
                for sub in ast.walk(node):
                    if (isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Name)
                            and sub.func.id == "next" and sub.args
                            and ast.unparse(sub.args[0]) in names):
                        hot_bodies.append(node.body)
                        break
        if not hot_bodies:
            return
        seen: set[str] = set()
        checked: set[int] = set()
        queue = list(hot_bodies)
        while queue:
            body = queue.pop()
            for call in self._calls_in(body):
                if isinstance(call.func, ast.Name):
                    callee = call.func.id
                    if callee in self.defs and callee not in seen:
                        seen.add(callee)
                        queue.extend(fn.body for fn in self.defs[callee])
            self._check_hot_body(body, checked)

    def _calls_in(self, body: list[ast.stmt]):
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    yield node

    def _check_hot_body(self, body: list[ast.stmt], checked: set) -> None:
        for call in self._calls_in(body):
            if id(call) in checked:      # a nested hot loop's own body
                continue
            checked.add(id(call))
            terminal, root = _terminal_and_root(call.func)
            if (isinstance(call.func, ast.Name)
                    and terminal in _SYNC_BARE
                    and call.args
                    and not isinstance(call.args[0], ast.Constant)):
                self._emit("GL001", call,
                           f"{terminal}() on a (possibly CUDA) tensor in "
                           "the hot loop blocks the host")
            elif (isinstance(call.func, ast.Attribute)
                    and terminal in _SYNC_METHODS and not call.args):
                self._emit("GL001", call,
                           f".{terminal}() in the hot loop blocks the host "
                           "until the card drains its queue")

    # ---- GL004: f64 drift ---------------------------------------------

    @staticmethod
    def _has_dtype_arg(node: ast.Call) -> bool:
        if any(kw.arg == "dtype" for kw in node.keywords):
            return True
        for arg in node.args[1:]:
            for sub in ast.walk(arg):
                name = (sub.attr if isinstance(sub, ast.Attribute)
                        else sub.id if isinstance(sub, ast.Name)
                        else sub.value if (isinstance(sub, ast.Constant)
                                           and isinstance(sub.value, str))
                        else "")
                if isinstance(name, str) and (
                        name.startswith(("float", "int", "uint", "bfloat",
                                         "complex", "bool_"))
                        or "dtype" in name):
                    return True
        return False

    def check_f64(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Attribute) and node.attr in (
                    "float64", "double"):
                _, root = _terminal_and_root(node)
                if root in _NP_ROOTS | {"torch"}:
                    self._emit("GL004", node,
                               f"explicit float64 dtype ({root}."
                               f"{node.attr}) — f64 operands upcast "
                               "everything downstream")
            if not isinstance(node, ast.Call):
                continue
            terminal, root = _terminal_and_root(node.func)
            if (terminal == "double" and isinstance(node.func, ast.Attribute)
                    and not node.args):
                self._emit("GL004", node,
                           ".double() casts to float64")
            elif (terminal == "from_numpy" and root == "torch" and node.args
                    and isinstance(node.args[0], ast.Call)):
                t, r = _terminal_and_root(node.args[0].func)
                if (r in _NP_ROOTS and t in _FLOAT_DEFAULT_CTORS
                        and not self._has_dtype_arg(node.args[0])):
                    self._emit("GL004", node,
                               f"torch.from_numpy({r}.{t}(...)) without "
                               "dtype= is a float64 tensor")
            elif (root in _NP_ROOTS and terminal in _FLOAT_DEFAULT_CTORS
                    and terminal not in ("arange", "full")
                    and not self._has_dtype_arg(node)):
                self._emit("GL004", node,
                           f"{root}.{terminal}() without dtype= defaults "
                           "to float64")

    # ---- GL005: unsynced wall-clock timing ----------------------------

    @staticmethod
    def _own_nodes(fn):
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    _SYNCED = {"synchronize", "elapsed_time", "event_ms", "chained_ms",
               "item", "tolist", "cpu", "numpy"}

    def check_timing(self) -> None:
        """Two or more clock reads in a function that touches CUDA
        (a ``cuda`` name, attribute or device string in its own body)
        with no synchronize, CUDA event or host read among its calls."""
        if not self.imports_torch:
            return
        for name, fns in self.defs.items():
            for fn in fns:
                clock_calls, synced, cuda = [], False, False
                for node in self._own_nodes(fn):
                    if (isinstance(node, ast.Attribute)
                            and "cuda" in node.attr
                            or isinstance(node, ast.Constant)
                            and isinstance(node.value, str)
                            and node.value.startswith("cuda")):
                        cuda = True
                    if not isinstance(node, ast.Call):
                        continue
                    terminal, root = _terminal_and_root(node.func)
                    if root == "time" and terminal in ("time", "perf_counter",
                                                       "monotonic"):
                        clock_calls.append(node)
                    if terminal in self._SYNCED or (
                            isinstance(node.func, ast.Name)
                            and terminal in _SYNC_BARE and node.args):
                        synced = True
                if len(clock_calls) >= 2 and cuda and not synced:
                    clock_calls.sort(key=lambda n: n.lineno)
                    self._emit("GL005", clock_calls[0],
                               f"{name}() reads the wall clock "
                               f"{len(clock_calls)}x around CUDA work with "
                               "no sync or events: the delta measures the "
                               "launches — use utils/timing.py")

    # ---- GL007: swallowed broad except --------------------------------

    _BROAD_EXC = {"Exception", "BaseException"}

    @classmethod
    def _is_broad_handler(cls, handler: ast.ExceptHandler) -> bool:
        if handler.type is None:
            return True
        for node in ast.walk(handler.type):
            name = (node.id if isinstance(node, ast.Name)
                    else node.attr if isinstance(node, ast.Attribute)
                    else None)
            if name in cls._BROAD_EXC:
                return True
        return False

    def check_broad_except(self) -> None:
        """A broad handler must re-raise, use the bound exception, or pass
        ``exc_info`` to a logging call."""
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.ExceptHandler)
                    and self._is_broad_handler(node)):
                continue
            body_nodes = [n for stmt in node.body for n in ast.walk(stmt)]
            reraises = any(isinstance(n, ast.Raise) for n in body_nodes)
            uses_exc = node.name is not None and any(
                isinstance(n, ast.Name) and n.id == node.name
                for n in body_nodes)
            logs_exc_info = any(
                isinstance(n, ast.Call)
                and any(kw.arg == "exc_info" for kw in n.keywords)
                for n in body_nodes)
            if not (reraises or uses_exc or logs_exc_info):
                self._emit("GL007", node,
                           "broad except swallows the error — re-raise, "
                           "record the bound exception, or add a reasoned "
                           "suppression")

    # ---- GL009: phantom mesh axis (parallel/ only) --------------------

    def _declared_axes(self) -> set:
        axes = set(_CANONICAL_MESH_AXES)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg in ("mesh_dim_names", "data_axis",
                                  "model_axis", "axis_name"):
                        for sub in ast.walk(kw.value):
                            if (isinstance(sub, ast.Constant)
                                    and isinstance(sub.value, str)):
                                axes.add(sub.value)
        return axes

    def check_mesh_axes(self) -> None:
        """GL009 in ``parallel/`` and in any module that builds a
        DeviceMesh."""
        if "parallel" not in self.parts and not re.search(
                r"init_device_mesh|DeviceMesh\(", self.src):
            return
        axes = self._declared_axes()
        for node in ast.walk(self.tree):
            names = []
            if (isinstance(node, ast.Subscript)
                    and "mesh" in ast.unparse(node.value).lower()
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)):
                names = [node.slice.value]
            elif isinstance(node, ast.Call):
                terminal, _ = _terminal_and_root(node.func)
                if terminal in _MESH_LOOKUPS:
                    names = [a.value for a in node.args
                             if isinstance(a, ast.Constant)
                             and isinstance(a.value, str)]
            phantoms = sorted(set(names) - axes)
            if phantoms:
                self._emit("GL009", node,
                           f"mesh dimension {phantoms} is declared by no "
                           "DeviceMesh or ParallelConfig in scope")

    # ---- GL017: unstabilized exp domain (losses/ only) ----------------

    _GUARD_CALLS = {"max", "maximum", "amax", "min", "minimum", "clip",
                    "clamp", "logsumexp", "detach", "log_softmax",
                    "softmax"}

    def _guard_names(self) -> set:
        """Names carrying a max/lse-derived bound, by fixed point."""
        def lexical(name: str) -> bool:
            return "max" in name or "lse" in name

        assigns = []
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign):
                names = [n for t in node.targets for n in _assigned_names(t)]
                if names:
                    assigns.append((names, node.value))
        guards: set = set()
        changed = True
        while changed:
            changed = False
            for names, value in assigns:
                if all(n in guards for n in names):
                    continue
                hit = False
                for sub in ast.walk(value):
                    if isinstance(sub, ast.Call):
                        t, _r = _terminal_and_root(sub.func)
                        if t in self._GUARD_CALLS:
                            hit = True
                            break
                    elif isinstance(sub, ast.Name) and (
                            sub.id in guards or lexical(sub.id)):
                        hit = True
                        break
                if hit:
                    for n in names:
                        if n not in guards:
                            guards.add(n)
                            changed = True
        return guards

    def check_exp_stability(self) -> None:
        """GL017's source half, in ``losses/`` modules: ``exp`` whose
        argument shows no subtraction of a guard, and a division whose
        denominator is a bare reduced sum."""
        if "losses" not in self.parts:
            return
        guards = self._guard_names()

        def guard_ref(node: ast.AST) -> bool:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name) and (
                        sub.id in guards or "max" in sub.id
                        or "lse" in sub.id):
                    return True
                if isinstance(sub, ast.Call):
                    t, _r = _terminal_and_root(sub.func)
                    if t in self._GUARD_CALLS:
                        return True
            return False

        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                terminal, _root = _terminal_and_root(node.func)
                target = (node.args[0] if node.args else
                          node.func.value if isinstance(node.func,
                                                        ast.Attribute)
                          else None)
                if terminal == "exp" and target is not None:
                    guarded = (isinstance(target, ast.Name)
                               and target.id in guards)
                    if not guarded:
                        for sub in ast.walk(target):
                            if (isinstance(sub, ast.BinOp)
                                    and isinstance(sub.op, ast.Sub)
                                    and guard_ref(sub.right)):
                                guarded = True
                                break
                    if not guarded:
                        self._emit("GL017", node,
                                   "exp without a max-subtraction guard — "
                                   "overflows f32 past 88 (subtract the row "
                                   "max or reuse the logsumexp bound)")
            elif (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Div)
                    and isinstance(node.right, ast.Call)):
                t, _r = _terminal_and_root(node.right.func)
                if t == "sum":
                    self._emit("GL017", node,
                               "division by a reduced sum without an "
                               "eps/clamp floor — an all-masked row "
                               "divides by zero")

    # ---- run ------------------------------------------------------------

    def run(self) -> list[Finding]:
        self.check_step_scope()
        self.check_state_deepcopy()
        self.check_hot_regions()
        self.check_f64()
        self.check_timing()
        self.check_broad_except()
        self.check_mesh_axes()
        self.check_exp_stability()
        return self.findings


def _parent_functions(tree: ast.Module) -> dict:
    """id(node) -> name of the nearest enclosing function."""
    out: dict[int, str] = {}

    def walk(node, current):
        for child in ast.iter_child_nodes(node):
            name = (child.name
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                    else current)
            out[id(child)] = current
            walk(child, name)

    walk(tree, "")
    return out


# Rules whose findings a suppression can legitimately absorb, per pass.
# Staleness (GL000) is only judged against rules that actually RAN: a
# GL010 suppression is not "stale" under --no-concurrency, it is simply
# unevaluated this invocation.  GL011 is NEVER staleness-judged: a
# cycle's partner edge may live in a module outside the current lint
# scope (a `graft_lint milnce_tpu/serving` narrowed run must not call a
# cross-module cycle's audited suppression stale).
_PASS1_RULES = frozenset({"GL001", "GL002", "GL003", "GL004", "GL005",
                          "GL006", "GL007", "GL008", "GL009", "GL017"})
_PASS3_STALE_RULES = frozenset({"GL010", "GL012"})


def _finalize(findings: list[Finding], sups: list[Suppression],
              bad: list[Finding], path: str,
              evaluated: frozenset) -> list[Finding]:
    """Apply suppressions to one file's findings, then turn every
    well-formed suppression that matched NOTHING (for a rule that was
    evaluated) into a GL000 stale-suppression finding: the audited
    exceptions must never claim one that no longer exists."""
    by_line: dict[tuple[int, str], Suppression] = {}
    for s in sups:
        target = s.line + 1 if s.standalone else s.line
        by_line[(target, s.rule_id)] = s
    matched: set = set()
    for f in findings:
        s = by_line.get((f.line, f.rule.id))
        if s is not None:
            f.suppressed = True
            f.suppress_reason = s.reason
            matched.add((f.line, f.rule.id))
    for (line, rule_id), s in by_line.items():
        if (line, rule_id) in matched or rule_id not in evaluated:
            continue
        findings.append(Finding(
            path, s.line, RULES["GL000"],
            f"stale suppression: {rule_id} no longer fires on this line "
            "— delete it (or re-audit why you expected it to fire)"))
    findings.extend(bad)
    findings.sort(key=lambda f: (f.path, f.line, f.rule.id))
    return findings


def _lint_one(src: str, path: str, concurrency: bool):
    """One file's raw findings + suppressions + (optional) lock graph,
    BEFORE suppression matching (GL011 needs the graphs of every file
    in scope merged first)."""
    sups, bad = parse_suppressions(src, path)
    findings = _ModuleLint(src, path).run()
    graph = None
    if concurrency:
        from milnce_tpu_torch.analysis.concurrency import lint_concurrency_source

        cfindings, graph, _reports = lint_concurrency_source(src, path)
        findings.extend(cfindings)
    return findings, sups, bad, graph


def lint_source(src: str, path: str = "<string>", *,
                concurrency: bool = True) -> list[Finding]:
    """All findings for one module, suppressions applied (suppressed
    findings are RETURNED with .suppressed=True so reports can list the
    audited exceptions; callers gate on the unsuppressed subset).
    ``concurrency=False`` skips Pass 3 (GL010-GL012)."""
    findings, sups, bad, graph = _lint_one(src, path, concurrency)
    if graph is not None:
        findings.extend(graph.cycle_findings())
    evaluated = _PASS1_RULES | (_PASS3_STALE_RULES if concurrency else frozenset())
    return _finalize(findings, sups, bad, path, evaluated)


def _discover_files(paths: list[str]) -> list[str]:
    """Every .py under the given files/directories, sorted.

    A path that matches no Python files raises instead of being
    silently dropped — a typo'd scope argument must fail the gate
    loudly, not let it pass green while checking nothing."""
    files: list[str] = []
    for p in paths:
        found: list[str] = []
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                if "__pycache__" in root:
                    continue
                found.extend(os.path.join(root, n) for n in names
                             if n.endswith(".py"))
        elif os.path.isfile(p) and p.endswith(".py"):
            found.append(p)
        if not found:
            raise FileNotFoundError(
                f"lint scope {p!r} matches no Python files — typo'd path? "
                "(a silently empty scope would pass the gate vacuously)")
        files.extend(found)
    return sorted(files)


def lint_paths_full(paths: list[str], *, concurrency: bool = True):
    """Lint every .py under the given files/directories.

    Returns ``(findings, lock_graph)`` where ``lock_graph`` is the
    MERGED cross-module lock-order graph (None when ``concurrency``
    is off) — GL011 cycles split across files (A->B in one module,
    B->A in another, joined by an imported lock) only exist in the
    union."""
    per_file = []
    merged = None
    for fname in _discover_files(paths):
        with open(fname) as fh:
            findings, sups, bad, graph = _lint_one(fh.read(), fname,
                                                   concurrency)
        per_file.append((fname, findings, sups, bad))
        if graph is not None:
            if merged is None:
                from milnce_tpu_torch.analysis.concurrency import LockGraph

                merged = LockGraph()
            merged.merge(graph)
    cycle_by_path: dict[str, list] = {}
    if merged is not None:
        for f in merged.cycle_findings():
            cycle_by_path.setdefault(f.path, []).append(f)
    evaluated = _PASS1_RULES | (_PASS3_STALE_RULES if concurrency else frozenset())
    out: list[Finding] = []
    for fname, findings, sups, bad in per_file:
        findings.extend(cycle_by_path.pop(fname, []))
        out.extend(_finalize(findings, sups, bad, fname, evaluated))
    # cycles anchored outside the scanned files (can't happen today —
    # anchors are always edge sites in scope — but never drop findings)
    for leftovers in cycle_by_path.values():
        out.extend(leftovers)
    out.sort(key=lambda f: (f.path, f.line, f.rule.id))
    return out, merged


def lint_paths(paths: list[str], *,
               concurrency: bool = True) -> list[Finding]:
    """:func:`lint_paths_full` without the graph (the common caller)."""
    findings, _graph = lint_paths_full(paths, concurrency=concurrency)
    return findings
