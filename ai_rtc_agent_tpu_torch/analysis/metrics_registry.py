"""Checker: /metrics name grammar + collision freedom.

utils/profiling.py derives /metrics keys from registered names:
counters append ``_total``; stages fan out to ``_p50_ms``/``_p90_ms``
(snapshot) and ``_p50_us``/``_p90_us``/``_p99_us``/``_count``
(stage_snapshot_us); gauges land verbatim.  Two registrations whose
derived keys overlap silently shadow each other in the merged snapshot
dict — no exception, just a wrong dashboard.  Rules:

* **grammar** — literal names must match ``snake_case``
  (``^[a-z][a-z0-9]*(_[a-z0-9]+)*$``).
* **kind-conflict** — one name, one kind (counter | gauge | stage)
  repo-wide.  The same name at many sites with one kind is one metric
  and fine.
* **key-collision** — a registration's derived key set must not
  intersect another name's derived keys (e.g. a gauge literally named
  ``tx_packets_total`` collides with counter ``tx_packets``).
* **dynamic-name** — non-literal names defeat the registry; suppress
  with a reason when the name space is provably closed (enum states).

Registration sites: ``.count(name)`` / ``.gauge(name)`` /
``.record_stage(name)`` calls whose receiver names a stats object
(``stats`` in the identifier) — utils/profiling.py FrameStats is the
only provider.
"""

from __future__ import annotations

import ast
import re

from .core import Finding, ScopedVisitor, const_str, terminal_name

CHECKER = "metrics-registry"

_NAME_RE = re.compile(r"^[a-z][a-z0-9]*(_[a-z0-9]+)*$")
_KINDS = {"count": "counter", "gauge": "gauge", "record_stage": "stage"}

_STAGE_SUFFIXES = ("_p50_ms", "_p90_ms", "_p50_us", "_p90_us", "_p99_us",
                   "_count")


def derived_keys(name: str, kind: str) -> set:
    if kind == "counter":
        return {f"{name}_total"}
    if kind == "stage":
        return {f"{name}{s}" for s in _STAGE_SUFFIXES}
    return {name}


class _Visitor(ScopedVisitor):
    def __init__(self, mod):
        super().__init__()
        self.mod = mod
        self.sites = []  # (name|None, kind, line, scope)

    def visit_Call(self, node):
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _KINDS
            and "stats" in terminal_name(node.func.value).lower()
            and node.args
        ):
            self.sites.append((
                const_str(node.args[0]),
                _KINDS[node.func.attr],
                node.lineno,
                self.scope,
            ))
        self.generic_visit(node)


def check(project) -> list:
    findings = []
    registry = {}  # name -> (kind, first site)
    sites = []
    for mod in project.modules:
        v = _Visitor(mod)
        v.visit(mod.tree)
        for name, kind, line, scope in v.sites:
            if name is None:
                findings.append(Finding(
                    CHECKER, mod.rel, line, f"<dynamic-{kind}>",
                    f"non-literal {kind} name defeats the /metrics "
                    "registry — use a literal or suppress with a reason",
                    scope,
                ))
                continue
            sites.append((name, kind, mod.rel, line, scope))
    for name, kind, rel, line, scope in sites:
        if not _NAME_RE.match(name):
            findings.append(Finding(
                CHECKER, rel, line, name,
                f"metric name {name!r} is not snake_case "
                "(^[a-z][a-z0-9]*(_[a-z0-9]+)*$)", scope,
            ))
        prev = registry.get(name)
        if prev is None:
            registry[name] = (kind, rel, line)
        elif prev[0] != kind:
            findings.append(Finding(
                CHECKER, rel, line, name,
                f"metric {name!r} registered as {kind} here but as "
                f"{prev[0]} at {prev[1]}:{prev[2]} — one name, one kind",
                scope,
            ))
    # derived-key collisions across distinct names
    key_owner = {}
    for name in sorted(registry):
        kind = registry[name][0]
        for k in derived_keys(name, kind):
            other = key_owner.get(k)
            if other is not None and other != name:
                okind, orel, oline = registry[other]
                rel, line = registry[name][1], registry[name][2]
                findings.append(Finding(
                    CHECKER, rel, line, name,
                    f"/metrics key {k!r} from {kind} {name!r} collides "
                    f"with {okind} {other!r} ({orel}:{oline}) — rename",
                    "<registry>",
                ))
            else:
                key_owner[k] = name
    return findings
