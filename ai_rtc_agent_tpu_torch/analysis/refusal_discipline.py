"""Checker: refusals are disciplined — 503s back-pressure, vocab is closed.

The DAGOR-style admission design (docs/admission.md) hinges on one
contract: an overloaded plane says *when to come back*.  A 503 without
``Retry-After`` turns polite clients into a retry storm at the worst
possible moment — and we shipped exactly that (the agent's edge-pull
refusal in ``whep`` built a bare ``web.Response(status=503, ...)``
instead of going through ``_overloaded_response``; that live bug is this
checker's fixture shape).  Two rules:

* **ad-hoc-503** — a literal ``status=503`` (or an
  ``HTTPServiceUnavailable`` constructor) outside the blessed refusal
  helpers (``_overloaded_response`` on the agent, ``_refuse_503`` on the
  router) is a finding: every refusal flows through ONE constructor per
  plane so the Retry-After contract cannot be forgotten one call site at
  a time.
* **helper-missing-retry-after** — inside a blessed helper, the 503
  response must carry a literal ``headers=`` dict with a Retry-After key
  (the ``wire.RETRY_AFTER`` constant or the raw string) — so the helper
  itself can't silently drop the contract.

Plus the webhook vocabulary rule (**unknown-event / unknown-state**):
``Stream*`` event-name literals and SCREAMING state literals in state
contexts must be members of the closed ``EVENT_NAMES`` / ``STATE_NAMES``
frozensets of the profile's events module (server/events.py) — the webhook
plane's analog of metric-cardinality's closed-enum rule (a typo'd state
string silently partitions every downstream dashboard).

Per-file once the vocab sets are loaded, so it runs in ``--changed``.
"""

from __future__ import annotations

import ast
import re

from .core import PORT, Finding, ScopedVisitor, const_str, terminal_name

CHECKER = "refusal-discipline"

#: the ONE refusal constructor per plane (agent / fleet router) — plus
#: fixture-local spellings so precision tests can model both shapes
_REFUSAL_HELPERS = {"_overloaded_response", "_refuse_503"}

_EVENT_RE = re.compile(r"^Stream[A-Z][A-Za-z]+$")
_STATE_RE = re.compile(r"^[A-Z][A-Z_]{2,}$")

_RETRY_AFTER = "Retry-After"


def closed_vocab(project, name: str, profile=PORT) -> frozenset:
    """Members of the literal ``frozenset({...})`` assigned to *name* at
    module level in the profile's server/events.py."""
    mod = project.module(profile.events)
    if mod is None:
        return frozenset()
    for node in mod.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        t = node.targets[0]
        if not (isinstance(t, ast.Name) and t.id == name):
            continue
        v = node.value
        if (
            isinstance(v, ast.Call)
            and terminal_name(v.func) == "frozenset"
            and v.args
            and isinstance(v.args[0], (ast.Set, ast.Tuple, ast.List))
        ):
            return frozenset(
                s for s in (const_str(e) for e in v.args[0].elts)
                if s is not None
            )
    return frozenset()


def _has_retry_after(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg != "headers" or not isinstance(kw.value, ast.Dict):
            continue
        for k in kw.value.keys:
            if const_str(k) == _RETRY_AFTER:
                return True
            if k is not None and terminal_name(k) == "RETRY_AFTER":
                return True
    return False


def _is_503(call: ast.Call) -> bool:
    if terminal_name(call.func) == "HTTPServiceUnavailable":
        return True
    for kw in call.keywords:
        if kw.arg == "status":
            v = kw.value
            return isinstance(v, ast.Constant) and v.value == 503
    return False


class _Visitor(ScopedVisitor):
    def __init__(self, mod, events: frozenset, states: frozenset):
        super().__init__()
        self.mod = mod
        self.events = events
        self.states = states
        self.findings: list = []

    def _flag(self, line, name, message):
        self.findings.append(
            Finding(CHECKER, self.mod.rel, line, name, message, self.scope)
        )

    def _check_state(self, expr, where: str):
        if not self.states:
            return  # events.py outside the scan set: vocab rules degrade
        s = const_str(expr)
        if s is not None and _STATE_RE.match(s) and s not in self.states:
            self._flag(
                expr.lineno, s,
                f"state literal {s!r} ({where}) is not in the closed "
                "STATE_NAMES vocabulary (server/events.py) — a typo'd "
                "state partitions every downstream dashboard",
            )

    def visit_Call(self, node):
        if _is_503(node):
            fn = self.scope.split(".")[-1]
            if fn not in _REFUSAL_HELPERS:
                self._flag(
                    node.lineno, "503",
                    "ad-hoc 503 — route refusals through the plane's "
                    "shared helper (_overloaded_response / _refuse_503) "
                    "so Retry-After cannot be forgotten call-site by "
                    "call-site (the whep edge-refusal bug class)",
                )
            elif not _has_retry_after(node):
                self._flag(
                    node.lineno, "503",
                    f"refusal helper {fn} builds a 503 without a "
                    "Retry-After header — the back-pressure contract "
                    "(docs/admission.md) requires one on every refusal",
                )
        # state contexts: kwarg, literal-dict value, positional of the
        # webhook transition entrypoint
        for kw in node.keywords:
            if kw.arg == "state":
                self._check_state(kw.value, "state= kwarg")
        if terminal_name(node.func) == "handle_session_state":
            args = node.args
            # bound method: (stream_id, room_id, state, ...)
            if len(args) >= 3:
                self._check_state(args[2], "handle_session_state arg")
        self.generic_visit(node)

    def visit_Dict(self, node):
        for k, v in zip(node.keys, node.values):
            if const_str(k) == "state":
                self._check_state(v, 'dict "state" value')
        self.generic_visit(node)

    def visit_Compare(self, node):
        operands = [node.left, *node.comparators]
        stateish = any(
            any(w in terminal_name(o).lower() for w in ("state", "status"))
            for o in operands
            if isinstance(o, (ast.Name, ast.Attribute, ast.Subscript))
        )
        if stateish:
            for o in operands:
                if isinstance(o, (ast.Tuple, ast.List, ast.Set)):
                    for e in o.elts:
                        self._check_state(e, "state comparison")
                else:
                    self._check_state(o, "state comparison")
        self.generic_visit(node)

    def visit_Assign(self, node):
        if any(
            isinstance(t, ast.Attribute) and t.attr == "state"
            for t in node.targets
        ):
            self._check_state(node.value, ".state assignment")
        self.generic_visit(node)

    def visit_Constant(self, node):
        v = node.value
        if (
            self.events
            and isinstance(v, str)
            and _EVENT_RE.match(v)
            and v not in self.events
        ):
            self._flag(
                node.lineno, v,
                f"event-name literal {v!r} is not in the closed "
                "EVENT_NAMES vocabulary (server/events.py) — webhook "
                "consumers dispatch on exact names",
            )
        self.generic_visit(node)


def check(project, profile=PORT) -> list:
    events = closed_vocab(project, "EVENT_NAMES", profile)
    states = closed_vocab(project, "STATE_NAMES", profile)
    findings = []
    for mod in project.modules:
        if profile.tooling(mod.rel):
            continue
        # modules with their OWN closed state machines on the wire (the DTLS
        # handshake's WAIT_* states) are exempt from the WEBHOOK vocabulary
        # rules only; the 503 refusal rules still apply everywhere
        if mod.rel.startswith(profile.vocab_exempt):
            v = _Visitor(mod, frozenset(), frozenset())  # 503 rules only
        else:
            v = _Visitor(mod, events, states)
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
