"""Checker: no unbounded asyncio.Queue / collections.deque in package code.

Unbounded buffering is the overload failure mode the control plane
(resilience/overload.py) exists to kill: one slow consumer and the queue
becomes the latency.  Every ``asyncio.Queue`` and ``collections.deque``
constructed in package code must carry an explicit, finite bound —
``maxsize=N`` / ``maxlen=N`` — or name a reason it cannot
(``# tpurtc: allow[bounded-queue] -- <why>``).

Flagged:

* ``asyncio.Queue()`` with no ``maxsize`` (positional or keyword), or an
  explicit ``maxsize=0`` (asyncio's unbounded spelling);
* ``collections.deque(...)`` / imported ``deque(...)`` with no ``maxlen``
  (second positional or keyword), or an explicit ``maxlen=None``;
* renamed spellings of either — ``from asyncio import Queue as Q`` and
  ``import collections as c`` resolve to the same canonical origin.

Not flagged:

* operator scripts, examples and bench.py (process-lifecycle tooling, not
  the serving frame path — same carve-out as env-registry's raw-read
  rule);
* ``queue.Queue`` (thread control queues are not the frame path; the
  step-runner's one-slot handoff lives there deliberately);
* bounds that are expressions (``maxlen=self.bound``) — the rule is
  "explicit", not "literal": a computed bound is still a bound.
"""

from __future__ import annotations

import ast

from .core import PORT, Finding, ScopedVisitor, dotted, import_maps

CHECKER = "bounded-queue"


def _is_unbounded_literal(node) -> bool:
    """True for the explicit unbounded spellings: 0 (Queue) / None (deque)."""
    return isinstance(node, ast.Constant) and node.value in (0, None)


class _Visitor(ScopedVisitor):
    def __init__(self, mod, imports, mod_aliases):
        super().__init__()
        self.mod = mod
        # local name -> (source module, original name): `from asyncio
        # import Queue as Q` binds Q -> ("asyncio", "Queue"), so renamed
        # imports cannot smuggle an unbounded queue past the scan
        self.imports = imports
        self.mod_aliases = mod_aliases  # `import collections as c` -> c
        self.findings = []

    def _flag(self, node, name, what):
        self.findings.append(Finding(
            CHECKER, self.mod.rel, node.lineno, name,
            f"{what} constructed without an explicit finite bound — "
            "unbounded buffering is the overload failure mode "
            "(resilience/overload.py); pass a bound or suppress with a "
            "reason", self.scope,
        ))

    def _origin(self, node) -> str | None:
        """Resolve a call target to its canonical dotted origin, seeing
        through from-import renames and module aliases; None when it is
        not an import-resolvable name (``queue.Queue`` must not be
        mistaken for an imported asyncio Queue)."""
        name = dotted(node.func)
        if isinstance(node.func, ast.Name):
            src = self.imports.get(name)
            return f"{src[0]}.{src[1]}" if src else None
        if isinstance(node.func, ast.Attribute) and name and "." in name:
            head, _, tail = name.partition(".")
            return f"{self.mod_aliases.get(head, head)}.{tail}"
        return None

    def visit_Call(self, node):
        name = dotted(node.func)
        origin = self._origin(node)
        is_aqueue = origin == "asyncio.Queue"
        is_deque = origin == "collections.deque"
        if is_aqueue:
            bound = None
            if node.args:
                bound = node.args[0]
            for kw in node.keywords:
                if kw.arg == "maxsize":
                    bound = kw.value
            if bound is None or _is_unbounded_literal(bound):
                self._flag(node, name or "Queue", "asyncio.Queue")
        elif is_deque:
            bound = None
            if len(node.args) >= 2:
                bound = node.args[1]
            for kw in node.keywords:
                if kw.arg == "maxlen":
                    bound = kw.value
            if bound is None or _is_unbounded_literal(bound):
                self._flag(node, name or "deque", "collections.deque")
        self.generic_visit(node)


def check(project, profile=PORT) -> list:
    findings = []
    for mod in project.modules:
        if profile.tooling(mod.rel):
            continue
        v = _Visitor(mod, *import_maps(mod.tree))
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
