"""Checker: thread code stays off the loop; loop code never blocks on threads.

This process is a hybrid: an asyncio front door (agent endpoints, router,
poller, tick loops) drives dispatcher/fetcher/executor THREADS (scheduler
dispatch, per-row readback, encoder actuation, supervised restarts).
Every loop-bound asyncio object — the loop itself, ``asyncio.Queue``,
``asyncio.Event``, a ``create_future()`` future — is mutated safely from
exactly one side; the crossing primitives are ``call_soon_threadsafe``
and ``run_coroutine_threadsafe``.  The three worst shipped bugs were all
violations of this line (the shared flag, the wrong-identity resolve,
the sink reconfigure taking ``_enc_lock`` on the event loop).  Two directions, same-module resolution throughout:

**Thread side** — functions are thread-tainted when referenced as
``threading.Thread(target=...)``, ``asyncio.to_thread(...)`` or
``loop.run_in_executor(...)`` targets (``self._meth`` / bare-name /
nested-def spellings), then transitively through same-class
``self._x()`` and same-module ``x()`` calls.  Inside tainted code:

* ``call_soon`` / ``call_later`` / ``call_at`` / ``create_task`` /
  ``ensure_future`` — loop-only APIs; the threadsafe crossings
  (``call_soon_threadsafe`` / ``run_coroutine_threadsafe``) stay clean;
* ``put_nowait`` / ``get_nowait`` on an attribute the class constructed
  as ``asyncio.Queue`` (``queue.Queue`` is the thread-handoff tier and
  stays clean — same taint discipline as bounded-queue's scope rule);
* ``set`` / ``clear`` on an attribute constructed as ``asyncio.Event``
  (``threading.Event`` clean; the blessed spelling is
  ``loop.call_soon_threadsafe(self._ev.set)`` — media/plane.py);
* ``set_result`` / ``set_exception`` on a name or attribute tainted as
  an ASYNCIO future (assigned from ``create_future()`` /
  ``asyncio.Future()``); ``concurrent.futures.Future`` — the scheduler
  and multipeer handoff discipline — is thread-safe and stays clean.

**Loop side** — lexically inside ``async def`` (nested ``def``s are the
executor-target idiom and exempt, as in async-blocking):

* ``with <lock>:`` where the context manager names a threading lock
  (a ``lock``/``mutex``/``cond``-family snake_case token in the terminal
  identifier, call forms unwrapped — ``async with`` on an
  ``asyncio.Lock`` is a different AST node and never fires): a worker holding that lock across an encode/step stalls
  every session on the loop (the reconfigure incident); holding it ACROSS an
  ``await`` additionally deadlocks against any thread that needs the
  loop to release it.  Actuate via ``run_in_executor`` instead;
* ``.result()`` on a cross-thread future — the receiver is a
  ``run_coroutine_threadsafe(...)`` / executor-``submit`` call or a name
  tainted by one: blocking the loop on a thread that may need the loop
  is the canonical hybrid deadlock.

``scripts/``, ``examples/`` and ``bench.py`` are exempt (operator
tooling).  Fixture: tests/fixtures/static_analysis/loop_affinity_bad.py.
"""

from __future__ import annotations

import ast

from .core import (
    PORT,
    Finding,
    attr_of_self,
    canonical_dotted,
    dotted,
    import_maps,
    lock_terminal,
    lockish_name,
    terminal_name,
)
from .paths import StmtTaint, iter_matching

CHECKER = "loop-affinity"

_LOOP_ONLY_CALLS = {
    "call_soon", "call_later", "call_at", "create_task", "ensure_future",
}
_EXECUTORISH = ("executor", "pool")


# -- module model ------------------------------------------------------------

class _ModuleModel:
    """Same-module resolution: classes, methods, module functions, the
    asyncio-object attributes each class constructs, and the thread-taint
    roots."""

    def __init__(self, tree):
        self._frm, self._mods = import_maps(tree)
        self.module_funcs: dict = {}     # name -> FunctionDef (sync only)
        self.class_methods: dict = {}    # class name -> {meth name -> node}
        self.class_of: dict = {}         # id(fn node) -> class name
        self.queue_attrs: dict = {}      # class -> set of asyncio.Queue attrs
        self.event_attrs: dict = {}      # class -> set of asyncio.Event attrs
        self.future_attrs: dict = {}     # class -> set of create_future attrs
        self.thread_roots: list = []     # (class name | None, target expr)

        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                self.module_funcs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                meths = {}
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        meths[sub.name] = sub
                        self.class_of[id(sub)] = node.name
                self.class_methods[node.name] = meths
                self._scan_attrs(node)
        self._scan_thread_roots(tree)

    def _scan_attrs(self, cls):
        qs, evs, futs = set(), set(), set()
        for sub in ast.walk(cls):
            targets = None
            if isinstance(sub, ast.Assign):
                targets, value = sub.targets, sub.value
            elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                targets, value = [sub.target], sub.value
            if targets is None or not isinstance(value, ast.Call):
                continue
            d = canonical_dotted(value.func, self._frm, self._mods)
            tail = terminal_name(value.func)
            for t in targets:
                a = attr_of_self(t)
                if a is None:
                    continue
                if d == "asyncio.Queue":
                    qs.add(a)
                elif d == "asyncio.Event":
                    evs.add(a)
                elif tail == "create_future" or d == "asyncio.Future":
                    futs.add(a)
        self.queue_attrs[cls.name] = qs
        self.event_attrs[cls.name] = evs
        self.future_attrs[cls.name] = futs

    def _scan_thread_roots(self, tree):
        """Thread-target expressions + the class they were referenced in."""

        def walk(node, cls):
            if isinstance(node, ast.ClassDef):
                cls = node.name
            if isinstance(node, ast.Call):
                tail = terminal_name(node.func)
                target = None
                if tail == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            target = kw.value
                elif tail == "to_thread" and node.args:
                    target = node.args[0]
                elif tail == "run_in_executor" and len(node.args) >= 2:
                    target = node.args[1]
                if target is not None:
                    self.thread_roots.append((cls, target))
            for child in ast.iter_child_nodes(node):
                walk(child, cls)

        walk(tree, None)

    def thread_functions(self) -> set:
        """id()s of function nodes reachable from a thread root through
        same-class / same-module sync calls."""
        marked: list = []
        seen: set = set()

        def mark(fn):
            if fn is None or id(fn) in seen:
                return
            if isinstance(fn, ast.AsyncFunctionDef):
                return  # coroutines never run on the worker side
            seen.add(id(fn))
            marked.append(fn)

        for cls, target in self.thread_roots:
            a = attr_of_self(target)
            if a is not None and cls is not None:
                mark(self.class_methods.get(cls, {}).get(a))
            elif isinstance(target, ast.Name):
                # bare name: module function, or a nested def in any
                # enclosing function of this module
                mark(self.module_funcs.get(target.id))
                for fn in self._all_functions():
                    for sub in ast.walk(fn):
                        if (
                            isinstance(sub, ast.FunctionDef)
                            and sub.name == target.id
                            and sub is not fn
                        ):
                            mark(sub)
        # transitive: self._x() within a marked method, x() within any
        # marked function
        i = 0
        while i < len(marked):
            fn = marked[i]
            i += 1
            cls = self.class_of.get(id(fn))
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Call):
                    continue
                a = attr_of_self(sub.func)
                if a is not None and cls is not None:
                    mark(self.class_methods.get(cls, {}).get(a))
                elif isinstance(sub.func, ast.Name):
                    mark(self.module_funcs.get(sub.func.id))
        return seen

    def _all_functions(self):
        yield from self.module_funcs.values()
        for meths in self.class_methods.values():
            yield from meths.values()


# -- thread-side rules -------------------------------------------------------

def _check_thread_fn(mod, fn, cls, model, findings):
    scope = fn.name if cls is None else f"{cls}.{fn.name}"
    q_attrs = model.queue_attrs.get(cls, set())
    e_attrs = model.event_attrs.get(cls, set())
    f_attrs = model.future_attrs.get(cls, set())
    taint = StmtTaint()

    def flag(node, name, message):
        findings.append(
            Finding(CHECKER, mod.rel, node.lineno, name, message, scope)
        )

    for stmt in fn.body:
        for sub in iter_matching(stmt, lambda n: isinstance(
            n, (ast.Call, ast.Assign, ast.AnnAssign)
        )):
            if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                value = sub.value
                targets = (
                    sub.targets if isinstance(sub, ast.Assign)
                    else [sub.target]
                )
                if value is None:
                    continue
                is_afut = isinstance(value, ast.Call) and (
                    terminal_name(value.func) == "create_future"
                    or canonical_dotted(
                        value.func, model._frm, model._mods
                    ) == "asyncio.Future"
                )
                taint.bind(targets, "afuture" if is_afut else None)
                continue
            tail = terminal_name(sub.func)
            name = dotted(sub.func)
            if tail in _LOOP_ONLY_CALLS:
                flag(
                    sub, name or tail,
                    f"loop-only API {tail}() called from thread-tainted "
                    "code — marshal through call_soon_threadsafe / "
                    "run_coroutine_threadsafe (the loop's internals are "
                    "not thread-safe)",
                )
            elif tail in ("put_nowait", "get_nowait") and isinstance(
                sub.func, ast.Attribute
            ):
                a = attr_of_self(sub.func.value)
                if a in q_attrs:
                    flag(
                        sub, name or tail,
                        f"asyncio.Queue self.{a}.{tail}() from "
                        "thread-tainted code — asyncio queues wake their "
                        "waiters on the loop; cross via "
                        "call_soon_threadsafe or a queue.Queue handoff",
                    )
            elif tail in ("set", "clear") and isinstance(
                sub.func, ast.Attribute
            ):
                a = attr_of_self(sub.func.value)
                if a in e_attrs:
                    flag(
                        sub, name or tail,
                        f"asyncio.Event self.{a}.{tail}() from "
                        "thread-tainted code — the blessed spelling is "
                        f"loop.call_soon_threadsafe(self.{a}.{tail})",
                    )
            elif tail in ("set_result", "set_exception") and isinstance(
                sub.func, ast.Attribute
            ):
                recv = sub.func.value
                a = attr_of_self(recv)
                if (a in f_attrs) or taint.kind(recv) == "afuture":
                    flag(
                        sub, name or tail,
                        f"asyncio future {tail}() from thread-tainted "
                        "code — resolve loop-bound futures via "
                        "loop.call_soon_threadsafe(fut.set_result, ...) "
                        "(concurrent.futures.Future is the thread-safe "
                        "handoff)",
                    )


# -- loop-side rules ---------------------------------------------------------

def _is_cross_thread_future_call(expr, taint) -> bool:
    if isinstance(expr, ast.Call):
        tail = terminal_name(expr.func)
        if tail == "run_coroutine_threadsafe":
            return True
        if tail == "submit" and isinstance(expr.func, ast.Attribute):
            recv = terminal_name(expr.func.value).lower()
            return any(k in recv for k in _EXECUTORISH)
        return False
    return taint.kind(expr) == "xfuture"


def _check_async_fn(mod, fn, scope, findings):
    taint = StmtTaint()

    def flag(node, name, message):
        findings.append(
            Finding(CHECKER, mod.rel, node.lineno, name, message, scope)
        )

    interesting = lambda n: isinstance(  # noqa: E731
        n, (ast.With, ast.Call, ast.Assign, ast.AnnAssign)
    )
    for stmt in fn.body:
        for sub in iter_matching(stmt, interesting):
            if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                value = sub.value
                targets = (
                    sub.targets if isinstance(sub, ast.Assign)
                    else [sub.target]
                )
                if value is None:
                    continue
                taint.bind(
                    targets,
                    "xfuture"
                    if _is_cross_thread_future_call(value, taint)
                    else None,
                )
            elif isinstance(sub, ast.With):
                locked = [
                    i for i in sub.items if lockish_name(i.context_expr)
                ]
                if not locked:
                    continue
                name = lock_terminal(locked[0].context_expr) or "<lock>"
                has_await = any(
                    True for b in sub.body
                    for _ in iter_matching(
                        b, lambda n: isinstance(n, ast.Await)
                    )
                )
                if has_await:
                    flag(
                        sub, name,
                        f"threading lock '{name}' held ACROSS an await on "
                        "the event loop — any thread needing the loop to "
                        "release it deadlocks; actuate via "
                        "run_in_executor (the PR 6 reconfigure fix)",
                    )
                else:
                    flag(
                        sub, name,
                        f"threading lock '{name}' acquired on the event "
                        "loop — a worker holding it across an encode/step "
                        "stalls every session (the PR 6 _enc_lock "
                        "incident); actuate via run_in_executor",
                    )
            elif isinstance(sub, ast.Call):
                if (
                    isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "result"
                    and _is_cross_thread_future_call(sub.func.value, taint)
                ):
                    flag(
                        sub, dotted(sub.func) or "result",
                        "blocking .result() on a cross-thread future "
                        "inside async def — the loop stalls until a "
                        "worker (which may need the loop) finishes: "
                        "await it, or wrap in asyncio.wrap_future",
                    )


# -- collector ---------------------------------------------------------------

class _AsyncCollector(ast.NodeVisitor):
    def __init__(self, mod):
        self.mod = mod
        self.findings: list = []
        self._stack: list = []

    def _named(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _named
    visit_ClassDef = _named

    def visit_AsyncFunctionDef(self, node):
        self._stack.append(node.name)
        _check_async_fn(
            self.mod, node, ".".join(self._stack), self.findings
        )
        self.generic_visit(node)
        self._stack.pop()


def check(project, profile=PORT) -> list:
    findings: list = []
    for mod in project.modules:
        if profile.tooling(mod.rel):
            continue
        model = _ModuleModel(mod.tree)
        thread_ids = model.thread_functions()
        # thread side: every tainted sync function
        done: set = set()
        for cls, meths in model.class_methods.items():
            for fn in meths.values():
                if id(fn) in thread_ids:
                    _check_thread_fn(mod, fn, cls, model, findings)
                    done.add(id(fn))
        for fn in model.module_funcs.values():
            if id(fn) in thread_ids and id(fn) not in done:
                _check_thread_fn(mod, fn, None, model, findings)
                done.add(id(fn))
        # nested-def thread targets (run_in_executor local closures)
        for node in ast.walk(mod.tree):
            if (
                isinstance(node, ast.FunctionDef)
                and id(node) in thread_ids
                and id(node) not in done
                and node.name not in model.module_funcs
            ):
                _check_thread_fn(mod, node, None, model, findings)
        # loop side
        v = _AsyncCollector(mod)
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
