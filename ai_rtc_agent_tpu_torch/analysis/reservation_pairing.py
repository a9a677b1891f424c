"""Checker: every counted reservation reaches a release/consume/handoff.

The repo's single most re-shipped bug class.  The agent leaked admission
slots when ``_end_supervision`` missed an error path; a migration import
took the reservation before the importing-state park and leaked it on the
overlap-reject path; epoch fencing had to re-audit every one of those
sites again.  Each fix was a human reading every exit path of one
function — this checker is that reading, mechanized on the shared
path-sensitive walk in :mod:`.paths`.

Tracked acquisitions (the app-level counted entrypoints — deliberately
NOT the raw ``mp.claim``/``sched.claim`` internals, which live inside
``_claim_pipeline``'s own try/except and would only manufacture noise):

* ``_admission_gate(app, key)`` / ``admission_gate(...)`` — a DAGOR
  admission slot, keyed by the session/stream/token expression;
* ``_admit_or_adopt(app, request, stream_id)`` — gate-or-adopt, keyed
  by the stream id;
* ``_claim_pipeline(app, ...)`` — an engine pipeline slot, unkeyed (the
  bound ``(pipeline, release_fn)`` names carry ownership).

A reservation is **discharged** on a path when ownership provably moves:

* a release/consume call mentioning the key or a bound name — terminals
  containing ``release``, or the consume family (``register_session``,
  ``_end_supervision``, ``adopt_reservation``, ``unregister_session``,
  ``handoff``, ``consume``, ``free``);
* a park: subscript store whose index is the key
  (``imported[token] = ...`` — the reservation now lives in app state);
* a ``return`` whose expression mentions the key or a bound name
  (ownership handed to the caller — the offer success response carries
  ``stream_id`` in its headers);
* a nested ``def``/``lambda`` capturing the key or a bound name (the
  closure owns it now — aiortc event handlers consume the reservation
  long after the request handler returned);
* a ``return`` of the plane's refusal helper discharges *unkeyed* claim
  resources only — ``_claim_pipeline`` returns ``(None, None)`` when
  saturated, so the refusal path holds nothing.  Keyed gates are NOT
  discharged by a refusal return: gating, failing a later step, and
  refusing without ``_release_admission`` is exactly the import leak.

Any function exit (return / raise / fall-through, after ``finally``
blocks) reachable with an undischarged reservation is flagged AT THE
ACQUIRE LINE (one suppression covers all leaking paths).  ``*_locked``
functions, ``__init__``-family methods, and scripts/examples/bench are
exempt; a path-state overflow is flagged, never silently truncated.
Per-file, so it runs in ``--changed``.
"""

from __future__ import annotations

import ast

from .core import PORT, Finding, terminal_name
from .paths import PathWalker, StmtTaint, iter_matching

CHECKER = "reservation-pairing"

_INIT_METHODS = {"__init__", "__new__", "__post_init__", "__init_subclass__"}

#: acquire terminal -> (family, key positional index | None, key kwargs)
_ACQUIRES = {
    "_admission_gate": ("gate", 1, ("key", "session_key")),
    "admission_gate": ("gate", 1, ("key", "session_key")),
    "_admit_or_adopt": ("gate", 2, ("stream_id",)),
    "_claim_pipeline": ("claim", None, ()),
    "claim_pipeline": ("claim", None, ()),
}

#: consume/handoff terminals (exact); terminals *containing* "release"
#: also discharge — `release_pipeline()`, `sess.release()`,
#: `_release_admission(app, key)` all match the convention
_CONSUMES = {
    "register_session", "unregister_session", "_end_supervision",
    "end_supervision", "adopt_reservation", "handoff", "consume", "free",
}

_REFUSAL_HELPERS = {"_overloaded_response", "_refuse_503"}

#: acquire-wrapper definitions exempt from their own walk (ownership
#: escaping to the caller is their contract)
_WRAPPER_HELPERS = {
    "_admission_gate", "admission_gate", "_claim_pipeline",
    "claim_pipeline",
}

_CLOSURES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _names_in(node) -> tuple:
    """Sorted identifiers mentioned anywhere under *node* (Name ids and
    Attribute terminals — ``self._token`` must overlap a key spelled
    ``_token``), descending into closures too."""
    if node is None:
        return ()
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return tuple(sorted(out))


def _unwrap(expr):
    return expr.value if isinstance(expr, ast.Await) else expr


def _is_acquire(node) -> bool:
    return (
        isinstance(node, ast.Call)
        and terminal_name(node.func) in _ACQUIRES
    )


def _is_consume(call: ast.Call) -> bool:
    t = terminal_name(call.func)
    return t in _CONSUMES or "release" in t.lower()


class _ReservationDomain:
    """Path state: a sorted tuple of held resources, each the hashable,
    ORDERABLE tuple ``(family, key_name, bound_names, acquire_line)`` —
    orderable because the walker sorts states on cap overflow."""

    def __init__(self, mod, scope: str):
        self.mod = mod
        self.scope = scope
        self.findings: list = []
        self._flagged: set = set()

    # -- event extraction -----------------------------------------------------

    def events(self, node):
        if isinstance(node, _CLOSURES):
            yield ("clear", _names_in(node))
            return
        if isinstance(node, ast.Return):
            value = _unwrap(node.value) if node.value else None
            refusal = (
                isinstance(value, ast.Call)
                and terminal_name(value.func) in _REFUSAL_HELPERS
            )
            yield ("ret", _names_in(node.value), refusal)
            return
        if isinstance(node, ast.Raise):
            return
        top = None
        bound = ()
        if isinstance(node, ast.Assign):
            top = _unwrap(node.value)
            bound = tuple(sorted(StmtTaint.target_names(node.targets)))
        yield from self._scan(node, top, bound)
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript):  # park into app state
                    yield ("clear", _names_in(t.slice))

    def _scan(self, node, top, bound):
        if isinstance(node, _CLOSURES):
            yield ("clear", _names_in(node))
            return
        if isinstance(node, ast.ClassDef):
            return
        if isinstance(node, ast.Call):
            t = terminal_name(node.func)
            if t in _ACQUIRES:
                family, idx, kwargs = _ACQUIRES[t]
                key = None
                if idx is not None and len(node.args) > idx:
                    key = node.args[idx]
                elif kwargs:
                    for kw in node.keywords:
                        if kw.arg in kwargs:
                            key = kw.value
                yield (
                    "acq",
                    (
                        family,
                        terminal_name(key) if key is not None else "",
                        bound if node is top else (),
                        node.lineno,
                    ),
                )
            elif _is_consume(node):
                yield ("clear", _names_in(node))
        for child in ast.iter_child_nodes(node):
            yield from self._scan(child, top, bound)

    # -- transfer function ----------------------------------------------------

    @staticmethod
    def _discharged(resource, names) -> bool:
        family, key, bound, _line = resource
        ns = set(names)
        return (key != "" and key in ns) or bool(set(bound) & ns)

    def apply(self, state: tuple, event) -> tuple:
        kind = event[0]
        if kind == "acq":
            return state if event[1] in state else state + (event[1],)
        if kind == "clear":
            return tuple(
                r for r in state if not self._discharged(r, event[1])
            )
        # ("ret", names, refusal) — a refusal return discharges unkeyed
        # claims (claim failed -> nothing held) but NEVER a keyed gate:
        # refusing without releasing the gate is the import leak itself
        _, names, refusal = event
        return tuple(
            r for r in state
            if not (
                self._discharged(r, names)
                or (refusal and r[0] == "claim" and r[1] == "")
            )
        )

    def with_event(self, event):
        return event

    def exit(self, state: tuple, line: int, what: str):
        for family, key, bound, acq_line in state:
            if (acq_line, family, key, bound) in self._flagged:
                continue  # one finding (and one suppression) per acquire
            self._flagged.add((acq_line, family, key, bound))
            held = key or ",".join(bound) or family
            self.findings.append(Finding(
                CHECKER, self.mod.rel, acq_line, held,
                f"counted {family} reservation ({held}) acquired here "
                f"never reaches a release/consume/park on a path ending "
                f"in {what} at line {line} — the PR 4/15 admission-leak "
                "class; release it, park it, or hand it off on EVERY "
                "exit (exception edges included)", self.scope,
            ))


class _Collector(ast.NodeVisitor):
    def __init__(self, mod):
        self.mod = mod
        self.findings: list = []
        self._stack: list = []

    def _visit_fn(self, node):
        self._stack.append(node.name)
        scope = ".".join(self._stack)
        exempt = (
            node.name.endswith("_locked")
            or node.name in _INIT_METHODS
            # the thin wrappers over the raw counters are the convention
            # boundary: _admission_gate's whole job is handing the
            # reservation to its caller.  Composite helpers
            # (_admit_or_adopt) are NOT exempt — they take through the
            # wrapper and must carry a reasoned suppression where the
            # handoff is deliberate.
            or node.name in _WRAPPER_HELPERS
        )
        if not exempt and any(
            True for stmt in node.body
            for _ in iter_matching(stmt, _is_acquire)
        ):
            domain = _ReservationDomain(self.mod, scope)
            overflow = PathWalker(domain).run(node)
            if overflow is not None:
                domain.findings.append(Finding(
                    CHECKER, self.mod.rel, overflow, "<state-overflow>",
                    "path-state overflow (>64 reservation states) — "
                    "pairing not provable; simplify the function",
                    scope,
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


def check(project, profile=PORT) -> list:
    findings = []
    for mod in project.modules:
        if profile.tooling(mod.rel):
            continue
        v = _Collector(mod)
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
