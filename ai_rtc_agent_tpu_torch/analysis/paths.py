"""Reusable path-sensitive pairing/taint engine for the checker suite.

Three checkers prove "X on **all** paths" properties over a single
function body: span-pairing (every ``trace.begin`` reaches an ``end``),
task-lifecycle (every bound task/future reaches a cleanup/ownership
sink), and loop-affinity (statement-order name taint).  The walk they
share — branch forks, 0-or-1 loop iterations, ``try`` handlers, stacked
``finally`` blocks applied on every exit, a deterministic path-state cap
that is FLAGGED rather than silently truncated — started life inside
span_pairing.py; this module is that walker generalized behind a small
domain protocol so a new "on all paths" rule is a transfer function, not
a re-derived CFG.

A **domain** supplies the checker-specific semantics:

* ``events(node)`` — the interesting AST events inside one statement or
  expression, in source order (the engine never descends into nested
  ``def``/``lambda``/``class`` bodies — a path property cannot legally
  cross a definition boundary);
* ``apply(state, event) -> state`` — the transfer function over one
  hashable path state (a tuple); findings are recorded by the domain as
  side effects;
* ``exit(state, line, what)`` — called for every reachable state at
  every function exit (``return`` / ``raise`` / fall-through), after the
  enclosing ``finally`` blocks have been applied;
* ``with_event(event) -> event | None`` — an event appearing as a
  ``with`` context expression (span-pairing flags ``with trace.begin``
  here, because ``begin()`` returns ``None`` and crashes at runtime);
  return ``None`` to consume the event.

``handlers_from_intermediate`` selects the ``try`` approximation.  Spans
leak precisely when an exception fires between ``begin`` and ``end``, so
span-pairing enters handlers from EVERY intermediate body state.  Task
binds, by contrast, sink on the very next statement in real code, and
modeling a raise between the bind and its sink only manufactures noise
(the ``create_task`` call itself raising leaves nothing bound) — the
task domain enters handlers from the entry and fall-through states only.

``StmtTaint`` is the taint half: a statement-order name→kind map with
the conventions the device-transfer checker established (direct Name
targets only — an attribute target never taints its base; plain
reassignment clears).
"""

from __future__ import annotations

import ast

#: statements the walk never descends into — a path-sensitive property is
#: same-function by construction
NO_DESCEND = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)

STATE_CAP = 64  # path-state explosion bound; overflow is FLAGGED, not dropped


def iter_matching(node, match):
    """Pre-order (source-position) iterator over nodes satisfying
    ``match``, not descending into nested definitions."""
    if isinstance(node, NO_DESCEND):
        return
    if match(node):
        yield node
    for child in ast.iter_child_nodes(node):
        yield from iter_matching(child, match)


class PathWalker:
    """Walk ONE function body, threading a set of hashable path states
    through the domain's transfer function.  ``run`` returns the line of
    the first path-state overflow (``None`` when the walk was exact) —
    the caller flags it; dropping states silently would let a leaking
    path past the cap scan clean."""

    def __init__(self, domain, state_cap: int = STATE_CAP,
                 handlers_from_intermediate: bool = True):
        self.domain = domain
        self.state_cap = state_cap
        self.handlers_from_intermediate = handlers_from_intermediate
        self.overflow_at: int | None = None

    def run(self, fn) -> int | None:
        remaining = self._walk(fn.body, {()}, ())
        self._exit(remaining, fn.lineno, (), "function exit")
        return self.overflow_at

    # -- state transitions ----------------------------------------------------

    def _apply_node(self, states: set, node) -> set:
        for ev in self.domain.events(node):
            states = {self.domain.apply(st, ev) for st in states}
        return states

    def _exit(self, states: set, line: int, finals: tuple, what: str):
        for fin in reversed(finals):  # enclosing finally blocks still run
            states = self._walk(fin, states, ())
        for st in states:
            self.domain.exit(st, line, what)

    # -- structured walk ------------------------------------------------------

    def _walk(self, stmts, states: set, finals: tuple,
              seen: set | None = None) -> set:
        """-> possible path states at normal fall-through.  ``seen``
        (when walking a try body under the intermediate-state
        approximation) accumulates every intermediate state — an
        exception can fire between any two statements, so the handler is
        entered from all of them."""
        for stmt in stmts:
            if seen is not None:
                seen |= states
            if len(states) > self.state_cap:
                if self.overflow_at is None:
                    self.overflow_at = stmt.lineno
                states = set(sorted(states)[: self.state_cap])
            if isinstance(stmt, (ast.Return, ast.Raise)):
                states = self._apply_node(states, stmt)
                self._exit(
                    states, stmt.lineno, finals,
                    "return" if isinstance(stmt, ast.Return) else "raise",
                )
                return set()
            if isinstance(stmt, ast.If):
                states = self._apply_node(states, stmt.test)
                a = self._walk(stmt.body, states, finals, seen)
                b = self._walk(stmt.orelse, states, finals, seen)
                states = a | b
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                states = self._apply_node(states, stmt.iter)
                once = self._walk(stmt.body, states, finals, seen)
                states = self._walk(stmt.orelse, states | once, finals, seen)
            elif isinstance(stmt, ast.While):
                states = self._apply_node(states, stmt.test)
                once = self._walk(stmt.body, states, finals, seen)
                states = self._walk(stmt.orelse, states | once, finals, seen)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    for ev in self.domain.events(item.context_expr):
                        ev = self.domain.with_event(ev)
                        if ev is not None:
                            states = {
                                self.domain.apply(st, ev) for st in states
                            }
                states = self._walk(stmt.body, states, finals, seen)
            elif isinstance(stmt, ast.Try):
                inner_finals = (
                    finals + (stmt.finalbody,) if stmt.finalbody else finals
                )
                if self.handlers_from_intermediate:
                    body_seen = set(states)
                    body_out = self._walk(
                        stmt.body, states, inner_finals, body_seen
                    )
                    handler_in = body_seen | body_out
                    if seen is not None:  # uncaught exceptions propagate
                        seen |= body_seen
                else:
                    body_out = self._walk(stmt.body, states, inner_finals, seen)
                    handler_in = states | body_out
                outs = self._walk(stmt.orelse, body_out, inner_finals, seen)
                for h in stmt.handlers:
                    outs |= self._walk(h.body, handler_in, inner_finals, seen)
                if stmt.finalbody:
                    outs = self._walk(stmt.finalbody, outs, finals, seen)
                states = outs
            else:
                states = self._apply_node(states, stmt)
        if seen is not None:
            seen |= states
        return states


class StmtTaint:
    """Statement-order name -> kind map (one function scope).

    Only direct Name targets bind (``a = ...``, ``a, b = ...``) — an
    attribute or subscript target never taints its base — and a plain
    reassignment clears.  This is the device-transfer checker's taint
    convention, extracted for the concurrency checkers."""

    def __init__(self):
        self._kinds: dict = {}

    @staticmethod
    def target_names(targets) -> list:
        out = []
        for t in targets:
            if isinstance(t, ast.Name):
                out.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    if isinstance(e, ast.Name):
                        out.append(e.id)
        return out

    def bind(self, targets, kind: str | None):
        """``kind=None`` clears (plain reassignment)."""
        for n in self.target_names(targets):
            if kind is None:
                self._kinds.pop(n, None)
            else:
                self._kinds[n] = kind

    def kind(self, expr) -> str | None:
        """Taint kind of an expression: a Name's binding (subscripts of a
        tainted name count — same value, one index deep)."""
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        if isinstance(expr, ast.Name):
            return self._kinds.get(expr.id)
        return None
