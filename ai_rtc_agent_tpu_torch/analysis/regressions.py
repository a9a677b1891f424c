"""Regression rules distilled from shipped bugs (ROADMAP Open Items).

These two rules exist because the exact pattern each flags reached main
and had to be fixed by hand; the analyzer now holds the line.  Both are
deliberately narrow — they encode the shape of a bug this codebase
actually shipped, not a general theory.

**retry-4xx** (server/worker.py default_publish, ROADMAP item 3):
``urllib.request.urlopen`` raises ``HTTPError`` — a ``URLError``
subclass — *before* any status-code check runs, so a retry wrapper with
``retry_on=(URLError, ...)`` around an urlopen body re-POSTs permanent
4xx rejections until the attempt budget burns out.  Flagged: a
``.run(...)`` / ``.arun(...)`` retry call whose ``retry_on`` tuple names
``URLError`` retrying a same-module callable that calls ``urlopen``
without handling ``HTTPError`` itself.

**restart-defaults** (stream/pipeline.py restart(), ROADMAP item 2):
a recovery path that re-applies module-level ``DEFAULT_*`` constants
silently reverts every runtime ``/config`` update the moment a fault
heals.  Flagged: keyword arguments whose value is a ``DEFAULT_*`` name
inside a function named ``restart``/``_restart*`` — recovery must
snapshot and restore live values.
"""

from __future__ import annotations

import ast

from .core import Finding, dotted

_DEFAULT_RE_PREFIX = "DEFAULT_"


def _names_in(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)} | {
        n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)
    }


def check_retry_4xx(project) -> list:
    CHECKER = "retry-4xx"
    findings = []
    for mod in project.modules:
        # local defs by name (module + nested), for resolving the retried fn
        defs = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, node)
        for call in [n for n in ast.walk(mod.tree) if isinstance(n, ast.Call)]:
            tail = dotted(call.func).split(".")[-1]
            if tail not in ("run", "arun"):
                continue
            retry_on = next(
                (k.value for k in call.keywords if k.arg == "retry_on"), None
            )
            if retry_on is None or "URLError" not in _names_in(retry_on):
                continue
            if not call.args:
                continue
            target = call.args[0]
            fn = defs.get(target.id) if isinstance(target, ast.Name) else None
            if fn is None:
                continue
            body_names = _names_in(fn)
            if "urlopen" in body_names and "HTTPError" not in body_names:
                findings.append(Finding(
                    CHECKER, mod.rel, call.lineno, fn.name,
                    f"retry of {fn.name}() on URLError also retries "
                    "HTTPError (a URLError subclass) — permanent 4xx "
                    "responses burn the whole attempt budget; catch "
                    "HTTPError in the callable and treat 4xx as terminal",
                    fn.name,
                ))
    return findings


def check_restart_defaults(project) -> list:
    CHECKER = "restart-defaults"
    findings = []
    for mod in project.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not (
                node.name == "restart" or node.name.startswith("_restart")
            ):
                continue
            for call in [n for n in ast.walk(node) if isinstance(n, ast.Call)]:
                for kw in call.keywords:
                    v = kw.value
                    if (
                        isinstance(v, ast.Name)
                        and v.id.startswith(_DEFAULT_RE_PREFIX)
                    ):
                        findings.append(Finding(
                            CHECKER, mod.rel, v.lineno, v.id,
                            f"{node.name}() re-applies compile-time "
                            f"{v.id} — a recovery restart silently "
                            "reverts runtime /config updates; snapshot "
                            "the live value and restore that",
                            node.name,
                        ))
    return findings
