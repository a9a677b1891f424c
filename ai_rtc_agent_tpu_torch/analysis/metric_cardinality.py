"""Checker: metric label values must come from closed enums.

Prometheus-style labels multiply series: one labeled family costs
``|label domain|`` time series *forever* on every scrape.  A label fed a
per-session key, per-frame id or per-packet sequence number is an
unbounded-cardinality leak — the scrape grows until the TSDB falls over,
which is the observability plane failing exactly when it matters.  The
repo rule (obs/promexport.py): label values come ONLY from closed enums
(the STAGES taxonomy, literal strings); per-session/per-frame detail
belongs at ``/health`` and in the JSON snapshot, never as a label.

Sites: calls to a ``labeled(name, labels, value)`` helper (obs/promexport
owns the only one today) and any call carrying a ``labels=`` keyword.
For each label pair in the dict display:

* **key** must be a literal string;
* **value** is clean when it is a literal string, or a name bound **in
  the same function scope** by a ``for`` target (statement or
  comprehension) iterating an ALL-CAPS module constant (``STAGES``-style
  closed enum — same-module or imported) or a literal tuple/list of
  strings; a closed loop in one function never whitelists a same-named
  open-domain variable in another;
* the ``le`` key is exempt — histogram bucket-bound labels are closed by
  ``BUCKET_BOUNDS_MS`` construction (the conformance test pins the set);
* anything else is a finding; values whose expression names a
  session/frame/packet/seq/ssrc/snapshot identity get the sharper
  message (that is the leak this checker exists to kill).

A non-dict ``labels`` expression is flagged too: cardinality that cannot
be read off the call site cannot be reviewed either.  Suppress with a
reason when a domain is provably closed some other way.
"""

from __future__ import annotations

import ast
import re

from .core import PORT, Finding, ScopedVisitor, dotted, terminal_name

CHECKER = "metric-cardinality"

_ENUM_NAME_RE = re.compile(r"^[A-Z][A-Z0-9_]+$")
_IDENTITY_FRAGMENTS = (
    "session", "frame", "packet", "seq", "ssrc", "snap", "stream_id",
    "peer", "conn",
)
_EXEMPT_KEYS = {"le"}  # histogram bucket bounds: closed by construction


def _is_closed_iter(node) -> bool:
    """An iterable whose member set is fixed at build time."""
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in node.elts
        )
    # sorted(STAGES) / list(STAGES) wrappers keep the domain closed
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in ("sorted", "list", "tuple", "set", "reversed")
        and len(node.args) == 1
    ):
        return _is_closed_iter(node.args[0])
    return bool(_ENUM_NAME_RE.match(terminal_name(node)))


class _Visitor(ScopedVisitor):
    def __init__(self, mod):
        super().__init__()
        self.mod = mod
        self.sites = []  # (labels-expr-node, line, scope)
        # (scope, name) for-targets over closed iterables — scoped PER
        # FUNCTION: a `for stage in STAGES` in one function must not
        # whitelist a same-named open-domain loop variable elsewhere in
        # the module (that is exactly the leak this checker hunts)
        self.closed_names: set = set()

    def _bind_target(self, target, it):
        if not _is_closed_iter(it):
            return
        if isinstance(target, ast.Name):
            self.closed_names.add((self.scope, target.id))
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                if isinstance(e, ast.Name):
                    self.closed_names.add((self.scope, e.id))

    def visit_For(self, node):
        self._bind_target(node.target, node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node):
        for gen in node.generators:
            self._bind_target(gen.target, gen.iter)
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp

    def visit_Call(self, node):
        labels = None
        if terminal_name(node.func) == "labeled" and len(node.args) >= 2:
            labels = node.args[1]
        for kw in node.keywords:
            if kw.arg == "labels":
                labels = kw.value
        if labels is not None:
            self.sites.append((labels, node.lineno, self.scope))
        self.generic_visit(node)


def _value_ok(node, closed_names: set, scope: str) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True
    if isinstance(node, ast.Name) and (scope, node.id) in closed_names:
        return True
    return False


def _identity_message(node) -> str | None:
    text = dotted(node) or (
        ast.unparse(node) if hasattr(ast, "unparse") else ""
    )
    low = text.lower()
    for frag in _IDENTITY_FRAGMENTS:
        if frag in low:
            return (
                f"label value {text!r} carries a per-{frag.rstrip('_id')} "
                "identity — unbounded series cardinality; keep it in "
                "/health or the JSON snapshot, never a label"
            )
    return None


def check(project, profile=PORT) -> list:
    findings = []
    for mod in project.modules:
        # operator tooling composes ad-hoc report lines, not scrape surfaces;
        # the rule guards what a Prometheus TSDB will actually ingest
        if profile.tooling(mod.rel):
            continue
        v = _Visitor(mod)
        v.visit(mod.tree)
        for labels, line, scope in v.sites:
            if not isinstance(labels, ast.Dict):
                findings.append(Finding(
                    CHECKER, mod.rel, line, "<labels>",
                    "label set is not a literal dict — cardinality cannot "
                    "be read off the call site; inline the dict or "
                    "suppress with a reason", scope,
                ))
                continue
            for k, val in zip(labels.keys, labels.values):
                if not (
                    isinstance(k, ast.Constant) and isinstance(k.value, str)
                ):
                    findings.append(Finding(
                        CHECKER, mod.rel, line, "<label-key>",
                        "label KEY must be a literal string", scope,
                    ))
                    continue
                if k.value in _EXEMPT_KEYS:
                    continue
                if _value_ok(val, v.closed_names, scope):
                    continue
                msg = _identity_message(val) or (
                    f"label {k.value!r} value is not provably from a "
                    "closed enum — use a literal or iterate an ALL-CAPS "
                    "constant tuple (suppress with a reason if the domain "
                    "is closed another way)"
                )
                findings.append(Finding(
                    CHECKER, mod.rel, line, k.value, msg, scope,
                ))
    return findings
