"""Checker: the HTTP wire surface <-> docs/http-api.md + server/wire.py
(the profile's ``http_doc`` and ``wire``).

The agent grew a real distributed control plane: ~21 agent routes, ~15
router routes, and header names crossing four process boundaries.  None
of it was machine-checked the way env knobs and metric names are — the
router's ``_PASS_HEADERS`` tuple carried its own copies of the header
strings, and an agent header the tuple didn't know about was silently
dropped at the proxy.  Three rules, same shape as env-registry:

* **undocumented-route / stale-route** — every ``app.router.add_*``
  route in package code must appear in the docs/http-api.md registry
  (method + path), and every documented row must have a code route —
  both directions, so the catalog can never rot.  A module-level table
  named by the profile's ``route_table`` (``ROUTES``: literal
  ``(METHOD, path[, handler])`` rows) registers its rows when some loop
  over it calls ``app.router.add_*``; a row that is not such a literal is
  a finding, as a dynamic knob name is.
* **unregistered-client-path** — client call sites must target
  registered routes: a literal path tail at an HTTP-verb call
  (``http.post(base + "/broadcast/pull")``), the router's proxy/migrate
  helpers (``_migrate_call``/``_place_and_proxy``/``_routed_delete``
  carry their path as a literal argument), and loopback URL literals
  (the worker's ``f"http://127.0.0.1:{port}/capacity"`` poll) — a typo'd
  client path 404s in production, not in review.  Dynamic tails are
  unresolvable and skipped.
* **wire-constant / unregistered-header** — cross-process header names
  come from the profile's server/wire.py (the ONE closed
  constants module): a raw literal equal to a wire header name anywhere
  outside wire.py, or an ``X-*`` literal in a headers context that
  wire.py doesn't know, is a finding — the ``_PASS_HEADERS`` drift
  class, mechanized.  ``Content-Type``/``Authorization`` are universal
  HTTP vocabulary and stay free.

Cross-file by construction (code <-> doc <-> wire.py), so ``--changed``
partial scans skip it, like env/metrics-registry.
"""

from __future__ import annotations

import ast
import re

from .core import PORT, Finding, ScopedVisitor, const_str, dotted, terminal_name

CHECKER = "http-contract"

#: table rows: | `METHOD` \| `METHOD+METHOD` | `/path` | ...
_DOC_ROW_RE = re.compile(
    r"^\s*\|\s*`?([A-Z+]+)`?\s*\|\s*`(/[^`]*)`"
)

_ADD_METHODS = {
    "add_get": "GET", "add_post": "POST", "add_delete": "DELETE",
    "add_put": "PUT", "add_patch": "PATCH", "add_head": "HEAD",
}

#: HTTP-verb call terminals whose first argument may carry a path tail
_VERB_TERMINALS = {"get", "post", "delete", "put", "patch"}

#: repo client helpers that carry a route path as a literal argument:
#: terminal -> (method | arg index holding the literal method, path arg
#: index, suffix appended to the path before lookup)
_CLIENT_HELPERS = {
    "_migrate_call": (1, 3, ""),
    "_place_and_proxy": ("POST", 1, ""),
    "_routed_delete": ("DELETE", 1, "/{session}"),
}

#: headers free of the wire contract (universal HTTP vocabulary)
_FREE_HEADERS = {"Content-Type", "Authorization"}


def documented_routes(doc_text: str) -> dict:
    """(METHOD, path) -> first doc line number, from table rows only.
    A method cell may name several verbs joined with ``+``."""
    out = {}
    for i, line in enumerate(doc_text.splitlines(), start=1):
        m = _DOC_ROW_RE.match(line)
        if not m:
            continue
        for method in m.group(1).split("+"):
            if method and method != "METHOD":  # header row guard
                out.setdefault((method, m.group(2)), i)
    return out


def wire_headers(project, profile=PORT) -> dict:
    """name -> constant value from server/wire.py module-level string
    assignments (the closed set; tuple members like Content-Type are
    deliberately not enforced)."""
    mod = project.module(profile.wire)
    out = {}
    if mod is None:
        return out
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            v = const_str(node.value)
            if isinstance(t, ast.Name) and v is not None:
                out[t.id] = v
    return out


def _literal_tail(expr):
    """The trailing literal string of a Constant / f-string / ``+``
    concat — None when the tail is dynamic."""
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        return _literal_tail(expr.right)
    if isinstance(expr, ast.JoinedStr):
        if expr.values and isinstance(expr.values[-1], ast.Constant):
            v = expr.values[-1].value
            return v if isinstance(v, str) else None
        return None
    return const_str(expr)


def _full_literal(expr) -> str:
    """Best-effort flattening of Constant/JoinedStr (dynamic parts become
    ``{}``), for loopback-URL detection."""
    if isinstance(expr, ast.JoinedStr):
        parts = []
        for v in expr.values:
            s = const_str(v)
            parts.append(s if s is not None else "{}")
        return "".join(parts)
    return const_str(expr) or ""


def _path_candidate(expr):
    """-> (path | None): a literal route-path tail at a client call
    argument.  Query strings are stripped; a dynamic tail is None."""
    full = _full_literal(expr)
    if full.startswith(("http://", "https://")):
        # only SELF-targeting URLs are our wire surface (the worker's
        # loopback poll) — external services (Twilio, model CDNs) have
        # their own contracts
        rest = full.split("://", 1)[1]
        host, sep, path = rest.partition("/")
        if "127.0.0.1" not in host and "localhost" not in host:
            return None
        if not sep:
            return None  # host-only literal, path appended elsewhere
        p = "/" + path.split("?")[0]
        return None if "{}" in p else p  # dynamic segment: unresolvable
    tail = _literal_tail(expr)
    if tail is None or not tail.startswith("/") or len(tail) < 2:
        return None
    return tail.split("?")[0]


class _Visitor(ScopedVisitor):
    def __init__(self, mod):
        super().__init__()
        self.mod = mod
        self.routes = []   # (method, path, line, scope)
        self.clients = []  # (method|None, path, line, scope)
        self.header_literals = []   # (value, line, scope) — everywhere
        self.header_contexts = []   # (value, line, scope) — headers ctx

    # -- routes + client calls ------------------------------------------------

    def visit_Call(self, node):
        func = node.func
        if isinstance(func, ast.Attribute):
            recv = dotted(func.value)
            if func.attr in _ADD_METHODS and recv.endswith(".router"):
                path = const_str(node.args[0]) if node.args else None
                if path is not None:
                    self.routes.append(
                        (_ADD_METHODS[func.attr], path, node.lineno,
                         self.scope)
                    )
            elif func.attr == "add_route" and recv.endswith(".router"):
                if len(node.args) >= 2:
                    method = const_str(node.args[0])
                    path = const_str(node.args[1])
                    if method and path:
                        self.routes.append(
                            (method.upper(), path, node.lineno, self.scope)
                        )
            elif func.attr in _VERB_TERMINALS and node.args:
                path = _path_candidate(node.args[0])
                if path is not None:
                    self.clients.append(
                        (func.attr.upper(), path, node.lineno, self.scope)
                    )
            self._headers_call(node, func)
        helper = _CLIENT_HELPERS.get(terminal_name(func))
        if helper is not None:
            method_spec, path_idx, suffix = helper
            method = (
                method_spec if isinstance(method_spec, str)
                else (const_str(node.args[method_spec])
                      if len(node.args) > method_spec else None)
            )
            path = (
                const_str(node.args[path_idx])
                if len(node.args) > path_idx else None
            )
            if method and path:
                self.clients.append(
                    (method.upper(), path + suffix, node.lineno, self.scope)
                )
        # loopback URL literals OUTSIDE verb calls (f-string assigned to
        # a variable, urlopen'd later) ride generic_visit via
        # visit_JoinedStr below
        for kw in node.keywords:
            if kw.arg == "headers" and isinstance(kw.value, ast.Dict):
                for k in kw.value.keys:
                    s = const_str(k)
                    if s is not None:
                        self.header_contexts.append(
                            (s, k.lineno, self.scope)
                        )
        self.generic_visit(node)

    def _headers_call(self, node, func):
        """``X.headers.get/pop/setdefault("Name")`` and bare
        ``headers.get(...)`` on a local dict named *headers*."""
        if func.attr not in ("get", "pop", "setdefault", "add"):
            return
        if not terminal_name(func.value).lower().endswith("headers"):
            return
        if node.args:
            s = const_str(node.args[0])
            if s is not None:
                self.header_contexts.append((s, node.lineno, self.scope))

    # -- loopback URL literals -------------------------------------------------

    def _url_literal(self, node):
        full = _full_literal(node)
        if full.startswith(("http://", "https://")):
            path = _path_candidate(node)
            if path is not None and path != "/":
                self.clients.append((None, path, node.lineno, self.scope))

    def visit_JoinedStr(self, node):
        self._url_literal(node)
        self.generic_visit(node)

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            if node.value.startswith(("http://", "https://")):
                self._url_literal(node)
            self.header_literals.append(
                (node.value, node.lineno, self.scope)
            )
        self.generic_visit(node)

    # -- headers contexts ------------------------------------------------------

    def visit_Subscript(self, node):
        if terminal_name(node.value).lower().endswith("headers"):
            s = const_str(node.slice)
            if s is not None:
                self.header_contexts.append((s, node.lineno, self.scope))
        self.generic_visit(node)

    def visit_Assign(self, node):
        for t in node.targets:
            name = terminal_name(t)
            if "HEADERS" in name.upper() and isinstance(
                node.value, (ast.Tuple, ast.List)
            ):
                for e in node.value.elts:
                    s = const_str(e)
                    if s is not None:
                        self.header_contexts.append(
                            (s, e.lineno, self.scope)
                        )
        self.generic_visit(node)


def _match_route(method, path, registry: dict) -> bool:
    """Concrete client path vs registered (possibly templated) routes.
    ``method=None`` (URL-literal rule) matches any verb."""
    for (m, p), _ in registry.items():
        if method is not None and m != method:
            continue
        if p == path:
            return True
        segs_p, segs_c = p.split("/"), path.split("/")
        if len(segs_p) == len(segs_c) and all(
            sp == sc or (sp.startswith("{") and sp.endswith("}"))
            for sp, sc in zip(segs_p, segs_c)
        ):
            return True
    return False


def route_table(mod, name: str) -> tuple:
    """-> (rows, bad) of the module-level table ``name = (...)``: its literal
    ``(METHOD, path[, handler])`` rows as (method, path, line), and the lines
    of rows that are not such literals."""
    rows, bad = [], []
    for node in mod.tree.body:
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and terminal_name(node.targets[0]) == name
        ):
            continue
        if not isinstance(node.value, (ast.Tuple, ast.List)):
            bad.append(node.lineno)
            continue
        for e in node.value.elts:
            lit = isinstance(e, ast.Tuple) and len(e.elts) in (2, 3)
            method = const_str(e.elts[0]) if lit else None
            path = const_str(e.elts[1]) if lit else None
            if method and path:
                rows.append((method.upper(), path, e.lineno))
            else:
                bad.append(e.lineno)
    return rows, bad


def _registers(tree, name: str) -> bool:
    """Does a ``for`` loop over ``name`` (``ROUTES`` / ``routing.ROUTES``)
    call ``<app>.router.add_*`` in its body?"""
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor)) and terminal_name(node.iter) == name:
            for sub in ast.walk(node):
                f = sub.func if isinstance(sub, ast.Call) else None
                if (
                    isinstance(f, ast.Attribute)
                    and (f.attr in _ADD_METHODS or f.attr == "add_route")
                    and dotted(f.value).endswith(".router")
                ):
                    return True
    return False


def _exempt(mod, profile) -> bool:
    # the analysis package quotes wire vocabulary in order to check it
    return profile.tooling(mod.rel) or mod.rel.startswith(profile.analysis)


def check(project, profile=PORT) -> list:
    doc_path = profile.http_doc
    doc_text = project.doc_text(doc_path)
    registry = documented_routes(doc_text)
    wire = wire_headers(project, profile)
    enforced = {v: k for k, v in wire.items()}  # value -> constant name
    findings = []
    code_routes = {}
    scanned = [
        mod for mod in project.modules
        if not _exempt(mod, profile) and mod.rel != profile.wire
    ]
    table = profile.route_table
    tabled = table is not None and any(_registers(m.tree, table) for m in scanned)
    for mod in scanned:
        v = _Visitor(mod)
        v.visit(mod.tree)
        routes = list(v.routes)
        if tabled:
            rows, bad = route_table(mod, table)
            routes += [(method, path, line, "<module>") for method, path, line in rows]
            for line in bad:
                findings.append(Finding(
                    CHECKER, mod.rel, line, "<dynamic-route>",
                    f"{table} row is not a literal (METHOD, path[, handler]) "
                    "tuple — a computed route defeats the registry; use "
                    "literals or suppress with a reason",
                ))
        for method, path, line, scope in routes:
            code_routes.setdefault((method, path), (mod.rel, line))
            if doc_text and (method, path) not in registry:
                findings.append(Finding(
                    CHECKER, mod.rel, line, f"{method} {path}",
                    f"route {method} {path} is registered here but not "
                    f"documented in {doc_path} — add a table row", scope,
                ))
        for method, path, line, scope in v.clients:
            if registry and not _match_route(method, path, registry):
                what = method or "any-method"
                findings.append(Finding(
                    CHECKER, mod.rel, line, f"{what} {path}",
                    f"client call targets {what} {path}, which is not a "
                    f"registered route in {doc_path} — typo'd paths 404 "
                    "in production, not in review", scope,
                ))
        seen_ctx = set()
        for value, line, scope in v.header_contexts:
            seen_ctx.add((value, line))
            if value in _FREE_HEADERS:
                continue
            if value in enforced:
                continue  # reported once by the literal sweep below
            if value.startswith("X-"):
                findings.append(Finding(
                    CHECKER, mod.rel, line, value,
                    f"cross-process header {value!r} is not in "
                    "server/wire.py — register it there and use the "
                    "constant (the _PASS_HEADERS drift class)", scope,
                ))
        for value, line, scope in v.header_literals:
            if value in enforced:
                findings.append(Finding(
                    CHECKER, mod.rel, line, value,
                    f"raw header literal {value!r} — use "
                    f"wire.{enforced[value]} (server/wire.py is the one "
                    "closed header vocabulary)", scope,
                ))
    if doc_text:
        for (method, path), line in sorted(registry.items()):
            if (method, path) not in code_routes:
                findings.append(Finding(
                    CHECKER, doc_path, line, f"{method} {path}",
                    f"documented route {method} {path} has no "
                    "app.router.add_* registration in the scan set — "
                    "stale doc row or dead route", "<doc>",
                ))
    elif code_routes:
        (method, path), (rel, line) = sorted(code_routes.items())[0]
        findings.append(Finding(
            CHECKER, rel, line, doc_path,
            f"{doc_path} is missing but routes are registered — create "
            "the registry (see docs/static-analysis.md)",
        ))
    return findings
