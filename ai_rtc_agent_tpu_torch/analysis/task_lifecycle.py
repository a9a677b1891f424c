"""Checker: every spawned task / minted future reaches an owner.

``asyncio`` tasks hold their exception until someone retrieves it; a
task nobody binds, cancels, awaits or registers is an orphan — its
failure is a log line at interpreter exit at best, and on teardown paths
it is a leaked loop (the "_on_cleanup cancels pending pulls" fix,
mechanized).  The sibling bug class is a minted future a caller will
block on that some path abandons unresolved — the inline-batch hang (a future resolved by SLOT order instead of pending
identity left the real submitter waiting out the full 120 s fetch
timeout).  Three rules, all same-module:

* **orphan-spawn** — an ``asyncio.create_task`` / ``ensure_future`` /
  ``loop.create_task`` call whose result is discarded (a bare expression
  statement).  The blessed fire-and-forget spelling is
  ``utils/dispatch.spawn``: it keeps a strong reference in a registry
  and retrieves the exception in a done-callback.
* **path-orphan** — a task bound to a LOCAL name must reach an ownership
  sink on **all** paths (:mod:`.paths` walk): ``.cancel()`` /
  ``.add_done_callback()`` / ``await`` / passed as a call argument
  (registries, ``gather``) / returned / yielded / stored (attribute,
  subscript, or aliased into a value).  An early return that skips the
  registry add, or a rebind while still unowned, is a finding.  The same
  walk covers LOCAL futures (``create_future()`` / ``Future()``) with
  the resolution sinks (``set_result`` / ``set_exception`` / ``result``
  / ``exception`` / ``cancel``) added — a future abandoned on one branch
  is the inline-batch hang shape.  Checks on the value (``t.done()``,
  ``fut is other``) are deliberately NOT sinks: inspecting a task does
  not clean it up.
* **attr-orphan** — a task stored to ``self.<attr>`` must be cancelled,
  awaited, or handed onward (``self.<attr>`` as a call argument)
  somewhere in the same class — the ``stop()``/``close()`` cancel
  discipline every tick loop in this repo follows.  Attribute-held
  FUTURES are exempt: pending-entry futures are routinely resolved by a
  different class (the scheduler dispatcher resolves ``_Pending.future``).

``scripts/``, ``examples/`` and ``bench.py`` are exempt (operator
tooling and process-lifecycle code, the bounded-queue carve-out).
Fixture: tests/fixtures/static_analysis/task_lifecycle_bad.py.
"""

from __future__ import annotations

import ast

from .core import PORT, Finding, attr_of_self, terminal_name
from .paths import PathWalker, StmtTaint, iter_matching

CHECKER = "task-lifecycle"

_TASK_SOURCES = {"create_task", "ensure_future"}
_FUTURE_SOURCES = {"create_future", "Future"}

#: methods whose CALL on the tracked name transfers/cleans ownership
_SINK_METHODS = {
    "cancel", "add_done_callback",  # task cleanup / registry discipline
    "set_result", "set_exception", "result", "exception",  # future resolve
}


def _source_kind(node, groups=frozenset()) -> str | None:
    """'task' / 'future' when ``node`` is a spawning call.  ``groups``
    holds names bound as ``async with asyncio.TaskGroup() as tg:``
    targets — ``tg.create_task(...)`` is structured concurrency (the
    group awaits, propagates and cancels its children) and is never a
    source."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if (
        isinstance(f, ast.Attribute)
        and isinstance(f.value, ast.Name)
        and f.value.id in groups
    ):
        return None
    tail = terminal_name(f)
    if tail in _TASK_SOURCES:
        return "task"
    if tail in _FUTURE_SOURCES:
        return "future"
    return None


def _group_names(fn) -> frozenset:
    """Names bound as TaskGroup context targets anywhere in the function
    (``async with asyncio.TaskGroup() as tg:`` and renamed spellings —
    the terminal callable name is the signal)."""
    out = set()
    for node in ast.walk(fn):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        for item in node.items:
            if (
                isinstance(item.context_expr, ast.Call)
                and terminal_name(item.context_expr.func) == "TaskGroup"
                and isinstance(item.optional_vars, ast.Name)
            ):
                out.add(item.optional_vars.id)
    return frozenset(out)


# -- per-statement event extraction ------------------------------------------
#
# Events, in source order within one statement:
#   ("orphan", line)             bare-expression spawn — discarded result
#   ("sink", name)               qualifying ownership use of a tracked name
#   ("bind", name, kind, line)   local bound from a source call
#   ("rebind", name, line)       local rebound to a non-source value

def _sink_names(expr, out):
    """Collect names in OWNERSHIP positions inside an expression that is
    itself a sink context (call argument, return/assign value, await)."""
    for n in iter_matching(
        expr, lambda x: isinstance(x, ast.Name)
    ):
        out.append(n.id)


def _discarded_sources(expr, groups):
    """Task-source calls in VALUE-DISCARDED positions of a bare
    expression statement: the expression itself, both arms of a ternary,
    ``and``/``or`` operands, tuple displays, and comprehension elements —
    ``cond and ensure_future(c)`` discards the task exactly like the bare
    spelling.  An Await or an enclosing call argument is an escape and
    stops the descent."""
    if _source_kind(expr, groups) == "task":
        yield expr
        return
    if isinstance(expr, ast.BoolOp):
        for v in expr.values:
            yield from _discarded_sources(v, groups)
    elif isinstance(expr, ast.IfExp):
        yield from _discarded_sources(expr.body, groups)
        yield from _discarded_sources(expr.orelse, groups)
    elif isinstance(expr, ast.Tuple):
        for e in expr.elts:
            yield from _discarded_sources(e, groups)
    elif isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
        yield from _discarded_sources(expr.elt, groups)
    elif isinstance(expr, ast.DictComp):
        yield from _discarded_sources(expr.value, groups)


def _stmt_events(stmt, groups=frozenset()):
    sinks: list = []
    binds: list = []

    class _V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):  # nested defs: own scope
            pass

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Lambda(self, node):
            pass

        def visit_ClassDef(self, node):
            pass

        def visit_Call(self, node):
            # receiver of a sink method:  t.cancel()
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in _SINK_METHODS
                and isinstance(f.value, ast.Name)
            ):
                sinks.append(f.value.id)
            # any name inside any argument escapes to another owner:
            # tasks.add(t), gather(*ts, t), append((frame, fut))
            for a in list(node.args) + [k.value for k in node.keywords]:
                _sink_names(a, sinks)
            self.generic_visit(node)

        def visit_Await(self, node):
            _sink_names(node.value, sinks)
            self.generic_visit(node)

        def visit_Return(self, node):
            if node.value is not None:
                _sink_names(node.value, sinks)
            self.generic_visit(node)

        def visit_Yield(self, node):
            if node.value is not None:
                _sink_names(node.value, sinks)
            self.generic_visit(node)

        visit_YieldFrom = visit_Await

        def _assign(self, targets, value, lineno):
            if value is None:
                return
            kind = _source_kind(value, groups)
            names = StmtTaint.target_names(targets)
            if kind is not None:
                for n in names:
                    binds.append(("bind", n, kind, lineno))
                # storing to an ATTRIBUTE/subscript target sinks nothing
                # here: the attr rule (class-level) owns those
            else:
                # the VALUE may alias a tracked name into a container /
                # attribute — that transfers ownership
                _sink_names(value, sinks)
                for n in names:
                    binds.append(("rebind", n, lineno))
            self.generic_visit(value)

        def visit_Assign(self, node):
            self._assign(node.targets, node.value, node.lineno)

        def visit_AnnAssign(self, node):
            self._assign([node.target], node.value, node.lineno)

        def visit_AugAssign(self, node):
            self._assign([], node.value, node.lineno)

        def visit_Expr(self, node):
            discarded = list(_discarded_sources(node.value, groups))
            for call in discarded:
                binds.append(("orphan", call.lineno))
            if not discarded:
                self.generic_visit(node)

    _V().visit(stmt)
    for name in sinks:
        yield ("sink", name)
    yield from binds


class _LocalDomain:
    """Path states: tuples of (name, kind, bind-line) not yet owned."""

    def __init__(self, mod, scope: str, groups=frozenset()):
        self.mod = mod
        self.scope = scope
        self.groups = groups
        self.findings: list = []
        self._seen: set = set()

    def events(self, node):
        # node is one statement or a test/iter expression
        yield from _stmt_events(
            node if isinstance(node, ast.stmt) else ast.Expr(value=node),
            self.groups,
        )

    def _flag(self, line, name, message):
        if (line, name) in self._seen:
            return
        self._seen.add((line, name))
        self.findings.append(
            Finding(CHECKER, self.mod.rel, line, name, message, self.scope)
        )

    def apply(self, state: tuple, ev) -> tuple:
        tag = ev[0]
        if tag == "orphan":
            self._flag(
                ev[1], "<discarded>",
                "fire-and-forget task: the result of create_task/"
                "ensure_future is discarded — its exception is never "
                "retrieved and nothing can cancel it on cleanup; bind it "
                "to a registry (utils/dispatch.spawn) or cancel/await it",
            )
            return state
        if tag == "sink":
            return tuple(e for e in state if e[0] != ev[1])
        if tag == "rebind":
            _, name, line = ev
            for e in state:
                if e[0] == name:
                    self._flag(
                        line, name,
                        f"{e[1]} '{name}' rebound while still unowned — "
                        "the previous one is orphaned (cancel/await/"
                        "register it first)",
                    )
            return tuple(e for e in state if e[0] != name)
        # bind
        _, name, kind, line = ev
        for e in state:
            if e[0] == name:
                self._flag(
                    line, name,
                    f"{e[1]} '{name}' rebound while still unowned — "
                    "the previous one is orphaned (cancel/await/"
                    "register it first)",
                )
        return tuple(e for e in state if e[0] != name) + ((name, kind, line),)

    def with_event(self, ev):
        return ev

    def exit(self, state: tuple, line: int, what: str):
        for name, kind, bind_line in state:
            if kind == "task":
                self._flag(
                    bind_line, name,
                    f"task '{name}' reaches {what} without cancel/await/"
                    "done-callback/registry on this path — an orphan "
                    "whose exception is never retrieved (the cleanup "
                    "path must own it)",
                )
            else:
                self._flag(
                    bind_line, name,
                    f"future '{name}' reaches {what} unresolved on this "
                    "path — a waiter blocks until timeout (the PR 9 "
                    "inline-batch hang: resolve by pending identity on "
                    "EVERY path, or hand the future off)",
                )


# -- class-level attr rule ---------------------------------------------------

def _scan_class(mod, cls, findings):
    sources: dict = {}  # attr -> (line, scope)
    owned: set = set()

    def scan(node, scope):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign):
                if _source_kind(sub.value) == "task":
                    for t in sub.targets:
                        a = attr_of_self(t)
                        if a is not None and a not in sources:
                            sources[a] = (sub.lineno, scope)
            elif isinstance(sub, ast.Call):
                f = sub.func
                # self.x.cancel() / self.x.add_done_callback(...)
                if isinstance(f, ast.Attribute) and f.attr in _SINK_METHODS:
                    a = attr_of_self(f.value)
                    if a is not None:
                        owned.add(a)
                # self.x handed onward: gather(self.x), tasks.add(self.x)
                for arg in list(sub.args) + [k.value for k in sub.keywords]:
                    for n in ast.walk(arg):
                        a = attr_of_self(n)
                        if a is not None:
                            owned.add(a)
            elif isinstance(sub, ast.Await):
                a = attr_of_self(sub.value)
                if a is not None:
                    owned.add(a)

    for meth in cls.body:
        if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan(meth, f"{cls.name}.{meth.name}")
    for attr, (line, scope) in sorted(sources.items()):
        if attr not in owned:
            findings.append(Finding(
                CHECKER, mod.rel, line, attr,
                f"task stored to self.{attr} but no method of {cls.name} "
                "ever cancels/awaits/hands it off — the stop()/close() "
                "path must own the loop it started", scope,
            ))


# -- collector ---------------------------------------------------------------

def _touches_sources(fn) -> bool:
    return any(
        True for stmt in fn.body
        for _ in iter_matching(
            stmt, lambda n: _source_kind(n) is not None
        )
    )


class _Collector(ast.NodeVisitor):
    def __init__(self, mod):
        self.mod = mod
        self.findings: list = []
        self._stack: list = []

    def _visit_fn(self, node):
        self._stack.append(node.name)
        if _touches_sources(node):
            domain = _LocalDomain(
                self.mod, ".".join(self._stack), _group_names(node)
            )
            # handlers from entry/fall-through only: a raise between a
            # bind and the registry add on the very next line is noise,
            # not the orphan class (see paths.py)
            PathWalker(domain, handlers_from_intermediate=False).run(node)
            self.findings.extend(domain.findings)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_ClassDef(self, node):
        self._stack.append(node.name)
        _scan_class(self.mod, node, self.findings)
        self.generic_visit(node)
        self._stack.pop()


def check(project, profile=PORT) -> list:
    findings = []
    for mod in project.modules:
        if profile.tooling(mod.rel):
            continue
        v = _Collector(mod)
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
