"""Checker: one attribute, one lock discipline per class.

The shipped shared-flag bug in one sentence: sessions share ONE engine, and a
flag the engine wrote lock-free at the top of ``submit`` while also
writing it under ``_submit_lock`` further down was cross-contaminated by
a concurrent session's ``to_thread`` hop (the fix made it thread-local).
The general shape is **mixed discipline**: an attribute written under
``with self._lock:`` in one place is a declaration that the attribute is
shared mutable state — a lock-free write to the same attribute anywhere
else in the class is a race half-fixed.

Per class (same-file, lexical):

* **guarded writes** — ``self.<attr> = ...`` / ``+=`` inside a
  ``with <lock>:`` block, where the context manager names a lock (a
  ``lock``/``mutex``/``cond``-family snake_case token in the terminal
  identifier — shared with loop-affinity via ``core.lockish_name``);
* methods whose name ends in ``_locked`` are treated as guarded
  throughout: the suffix is this repo's caller-holds-the-lock idiom
  (``BatchScheduler._step_batch_locked`` and friends are only ever
  entered with the dispatch lock held);
* ``__init__`` / ``__new__`` / ``__post_init__`` / ``__init_subclass__``
  are exempt — construction happens before the object is shared, and
  demanding a lock there would teach people to take locks that protect
  nothing;
* every remaining lock-free write to an attribute that is guarded
  somewhere else in the class is a finding.  Proven single-thread phases
  (a ``prepare()`` that runs before serving threads exist, a
  thread-local descriptor) are reasoned-suppress sites, not rule
  carve-outs — the proof belongs next to the write.

Reads are deliberately out of scope: lock-free reads of EWMA-ish state
are a documented pattern here (O(1) snapshot paths), and flagging them
would drown the signal.  ``scripts/``, ``examples/`` and ``bench.py``
are exempt (operator tooling).  Fixture:
tests/fixtures/static_analysis/lock_discipline_bad.py.
"""

from __future__ import annotations

import ast

from .core import PORT, Finding, lockish_name

CHECKER = "lock-discipline"

_INIT_METHODS = {"__init__", "__new__", "__post_init__", "__init_subclass__"}


class _MethodWrites(ast.NodeVisitor):
    """self.<attr> writes in one method, tagged guarded/unguarded by the
    enclosing ``with <lock>`` nesting.  Nested defs are skipped (their
    execution context is unknowable lexically — closures get their own
    discipline review)."""

    def __init__(self):
        self.depth = 0
        self.writes: list = []  # (attr, line, guarded)

    def visit_With(self, node):
        locked = any(lockish_name(i.context_expr) for i in node.items)
        if locked:
            self.depth += 1
        self.generic_visit(node)
        if locked:
            self.depth -= 1

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass

    def _target(self, t):
        if (
            isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
        ):
            self.writes.append((t.attr, t.lineno, self.depth > 0))

    def visit_Assign(self, node):
        for t in node.targets:
            self._target(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._target(node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._target(node.target)
        self.generic_visit(node)


def _scan_class(mod, cls, findings):
    guarded: set = set()
    unguarded: dict = {}  # attr -> [(method, line), ...]
    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if meth.name in _INIT_METHODS:
            continue
        caller_holds = meth.name.endswith("_locked")
        v = _MethodWrites()
        for stmt in meth.body:
            v.visit(stmt)
        for attr, line, is_guarded in v.writes:
            if is_guarded or caller_holds:
                guarded.add(attr)
            else:
                unguarded.setdefault(attr, []).append((meth.name, line))
    for attr in sorted(set(unguarded) & guarded):
        for meth_name, line in unguarded[attr]:
            findings.append(Finding(
                CHECKER, mod.rel, line, attr,
                f"mixed lock discipline: self.{attr} is written under a "
                f"lock elsewhere in {cls.name} but lock-free here — a "
                "concurrent writer races this store (the PR 5 shared-flag "
                "bug class); take the lock, make it thread-local, or "
                "prove the single-thread phase in a suppression reason",
                f"{cls.name}.{meth_name}",
            ))


def check(project, profile=PORT) -> list:
    findings: list = []
    for mod in project.modules:
        if profile.tooling(mod.rel):
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                _scan_class(mod, node, findings)
    return findings
