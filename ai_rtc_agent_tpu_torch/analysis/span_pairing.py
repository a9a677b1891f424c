"""Checker: every ``trace.begin(name)`` reaches a matching ``end`` on all paths.

A :class:`~..obs.trace.FrameTrace` span opened with ``begin`` and never
closed silently truncates the frame's timeline — the flight recorder then
shows a hop that "never finished", which is indistinguishable from the
real wedged-step incidents the recorder exists to diagnose.  The fix is
structural: either use the context manager (``with trace.span("x"):`` —
the exit stamps on every path) or prove, per function, that every
``begin`` reaches an ``end`` on **all** paths (early returns, raises,
branches, loops), typically via ``try/finally``.

This checker proves the latter with the shared path-sensitive walk in
:mod:`.paths` (same-function scope — traces don't hand open spans across
calls in this codebase):

* tracked receivers: attribute calls whose receiver's terminal identifier
  contains ``trace`` (``trace.begin``, ``self._trace.begin``,
  ``frame_trace.begin`` …) — same identifier convention as the
  metrics-registry checker's ``stats`` rule;
* ``begin(<literal>)`` pushes the span name (non-literal names become a
  wildcard that any ``end`` may close); ``end()`` closes the innermost
  open span, ``end(<literal>)`` closes that name;
* a ``begin`` used as a ``with`` context expression is itself flagged —
  ``FrameTrace.begin()`` returns None, so that spelling crashes at
  runtime (``with trace.span(...)`` is the context-manager form);
* ``if/else``, ``for``/``while`` (0-or-1 iterations), ``try`` bodies
  (handlers entered from EVERY intermediate state of the body — an
  exception between a ``begin`` and its ``end`` reaches the handler with
  the span open), and ``finally`` blocks applied on every exit path are
  modeled; path states are capped, and a function that overflows the cap
  is FLAGGED rather than silently under-analyzed (dropping states would
  be a false-negative hole).

Flagged: a function exit (return / raise / fall-through) reachable with
open spans, an ``end`` with no open span to close, and a path-state
overflow.  Fixture: tests/fixtures/static_analysis/span_pairing_bad.py.
"""

from __future__ import annotations

import ast

from .core import Finding, const_str, terminal_name
from .paths import PathWalker, iter_matching

CHECKER = "span-pairing"

_WILDCARD = "<dynamic>"


def _is_trace_call(node, attrs=("begin", "end")) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in attrs
        and "trace" in terminal_name(node.func.value).lower()
    )


class _SpanDomain:
    """begin/end pairing semantics over :class:`~.paths.PathWalker`
    states (tuples of open span names)."""

    def __init__(self, mod, scope: str):
        self.mod = mod
        self.scope = scope
        self.findings: list = []
        self._exit_lines: set = set()

    def events(self, node):
        yield from iter_matching(node, _is_trace_call)

    def apply(self, state: tuple, call: ast.Call) -> tuple:
        if call.func.attr == "begin":
            name = const_str(call.args[0]) if call.args else None
            return state + (name if name is not None else _WILDCARD,)
        # end
        if not state:
            self.findings.append(Finding(
                CHECKER, self.mod.rel, call.lineno, "end",
                "trace.end() with no span open on this path — "
                "unbalanced begin/end", self.scope,
            ))
            return state
        name = const_str(call.args[0]) if call.args else None
        if name is None:
            return state[:-1]
        for i in range(len(state) - 1, -1, -1):
            if state[i] in (name, _WILDCARD):
                return state[:i] + state[i + 1:]
        self.findings.append(Finding(
            CHECKER, self.mod.rel, call.lineno, name,
            f"trace.end({name!r}) closes a span not open on this path",
            self.scope,
        ))
        return state

    def with_event(self, call):
        if call.func.attr == "begin":
            # `with trace.begin(...)` CRASHES at runtime: begin() returns
            # None, which is no context manager — the with-form is
            # trace.span()
            self.findings.append(Finding(
                CHECKER, self.mod.rel, call.lineno, "begin",
                "trace.begin() used as a `with` context — begin() returns "
                "None (TypeError at runtime); use `with trace.span(...)`",
                self.scope,
            ))
            return None
        return call

    def exit(self, state: tuple, line: int, what: str):
        if state and line not in self._exit_lines:
            self._exit_lines.add(line)
            self.findings.append(Finding(
                CHECKER, self.mod.rel, line, ",".join(state),
                f"span(s) {', '.join(state)} still open at {what} — "
                "close with end() on every path, or use "
                "`with trace.span(...)`", self.scope,
            ))


class _Collector(ast.NodeVisitor):
    """Analyze each function independently (nested defs get their own
    scope — an open span cannot legally cross a def boundary)."""

    def __init__(self, mod):
        self.mod = mod
        self.findings: list = []
        self._stack: list = []

    def _visit_fn(self, node):
        self._stack.append(node.name)
        scope = ".".join(self._stack)
        # only pay the path walk when the function touches begin/end at all
        if any(
            True for stmt in node.body
            for _ in iter_matching(stmt, _is_trace_call)
        ):
            domain = _SpanDomain(self.mod, scope)
            overflow = PathWalker(domain).run(node)
            if overflow is not None:
                domain.findings.append(Finding(
                    CHECKER, self.mod.rel, overflow, "<state-overflow>",
                    "path-state overflow (>64 open-span states) — begin/end "
                    "balance not provable; simplify the function or use "
                    "`with trace.span(...)`", scope,
                ))
            self.findings.extend(domain.findings)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_ClassDef(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()


def check(project) -> list:
    findings = []
    for mod in project.modules:
        v = _Collector(mod)
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
