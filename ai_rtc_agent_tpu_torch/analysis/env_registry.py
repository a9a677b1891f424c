"""Checker: env knobs <-> the knob registries, in both directions.

The reference repo's config story was "grep the source"; this repo's is
docs/environment.md — useful exactly as long as it is complete.  The
profile names the registries (``env_docs``: docs/environment.md, and the
port's own ai_rtc_agent_tpu_torch/environment.md beside it).  The rules
that keep them complete:

* **undocumented-knob** — every ``env.get_*("NAME", ...)`` call site
  (including the canonical accessors inside utils/env.py and the
  ``get_*_aliased`` legacy names) must name a knob documented in a
  registry.
* **unread-knob** — every knob documented there must have at least one
  read site anywhere in the scan set (typed accessor, ``os.getenv``,
  ``os.environ.get``/``[...]`` all count), unless the registry's
  ``env_unread_heading`` section lists it with its reason.
* **stale-exemption** — a knob listed in that section must be documented
  in another table and must have no read site: the list only shrinks.
* **raw-read** — inside the profile's package (its env tier itself
  exempt), env reads must go through the typed accessor tier;
  bare ``os.getenv``/``os.environ`` reads reintroduce exactly the
  unconverted-string class of bug (the reference's WARMUP_FRAMES
  TypeError) the tier exists to kill.  Operator scripts and bench.py may
  read raw (their knobs are process-lifecycle, not serving config).
* **dynamic-knob** — a non-literal knob name defeats the registry;
  suppress with a reason if truly needed.

A registry is not python, so its findings (unread-knob, stale-exemption)
cannot be inline-suppressed; fix the doc (or the code) instead.
"""

from __future__ import annotations

import ast
import re

from .core import PORT, Finding, ScopedVisitor, const_str, dotted

CHECKER = "env-registry"

_DOC_NAME_RE = re.compile(r"`([A-Z][A-Z0-9_]{2,})`")
_GETTERS = {
    "get_str", "get_int", "get_float", "get_bool",
    "get_str_aliased", "get_int_aliased",
}
# knobs consumed by external tooling (the doc documents them for
# operators even though no code in the scan set reads them)
_EXTERNAL_OK = {"HF_HUB_CACHE"}


def documented_knobs(doc_text: str) -> dict:
    """knob name -> first doc line number, from table rows only."""
    out = {}
    for i, line in enumerate(doc_text.splitlines(), start=1):
        if not line.lstrip().startswith("|"):
            continue
        cell = line.split("|")[1] if line.count("|") >= 2 else line
        for m in _DOC_NAME_RE.finditer(cell):
            out.setdefault(m.group(1), i)
    return out


def knob_tables(doc_text: str, heading) -> tuple:
    """-> (documented, exempt): :func:`documented_knobs` of the doc outside
    and inside the section titled ``heading`` (None: no such section).
    Line numbers are the doc's own."""
    outside, inside, in_section = [], [], False
    for line in doc_text.splitlines():
        if line.startswith("#"):
            in_section = heading is not None and line.lstrip("#").strip() == heading
        (inside if in_section else outside).append(line)
        (outside if in_section else inside).append("")
    return documented_knobs("\n".join(outside)), documented_knobs("\n".join(inside))


class _Visitor(ScopedVisitor):
    def __init__(self, mod):
        super().__init__()
        self.mod = mod
        self.reads = []  # (name, line, scope, via_typed)
        self.dynamic = []  # (line, scope, call repr)
        self.raw = []  # (name_or_?, line, scope)

    def visit_Call(self, node):
        name = dotted(node.func)
        tail = name.split(".")[-1] if name else ""
        if tail in _GETTERS and isinstance(node.func, ast.Attribute):
            lits = []
            for a in node.args[: 2 if tail.endswith("_aliased") else 1]:
                s = const_str(a)
                if s is not None:
                    lits.append(s)
                elif a is node.args[0]:
                    self.dynamic.append((node.lineno, self.scope, name))
            for s in lits:
                self.reads.append((s, node.lineno, self.scope))
        elif tail in _GETTERS and isinstance(node.func, ast.Name):
            # `from ..utils.env import get_str` style — same rules
            s = const_str(node.args[0]) if node.args else None
            if s is None:
                self.dynamic.append((node.lineno, self.scope, tail))
            else:
                self.reads.append((s, node.lineno, self.scope))
        elif name in ("os.getenv", "os.environ.get"):
            s = const_str(node.args[0]) if node.args else None
            self.raw.append((s or "?", node.lineno, self.scope))
        self.generic_visit(node)

    def visit_Subscript(self, node):
        if (
            dotted(node.value) == "os.environ"
            and isinstance(node.ctx, ast.Load)
        ):
            s = const_str(node.slice)
            self.raw.append((s or "?", node.lineno, self.scope))
        self.generic_visit(node)


def check(project, profile=PORT) -> list:
    documented, exempt = {}, {}  # name -> (doc path, doc line)
    for path in profile.env_docs:
        docs, unread = knob_tables(project.doc_text(path), profile.env_unread_heading)
        for table, rows in ((documented, docs), (exempt, unread)):
            for name, line in rows.items():
                table.setdefault(name, (path, line))
    where = " or ".join(profile.env_docs)
    findings = []
    read_names = set()
    for mod in project.modules:
        v = _Visitor(mod)
        v.visit(mod.tree)
        in_pkg = mod.rel.startswith(profile.package)
        is_env_tier = mod.rel == profile.env_tier
        for name, line, scope in v.reads:
            read_names.add(name)
            if name not in documented:
                findings.append(Finding(
                    CHECKER, mod.rel, line, name,
                    f"env knob {name} is read here but not documented in "
                    f"{where} — add a table row", scope,
                ))
        for line, scope, call in v.dynamic:
            if is_env_tier:
                # the accessor tier's own plumbing (get_*_aliased
                # forwarding `name`) is the one legitimate dynamic reader
                continue
            findings.append(Finding(
                CHECKER, mod.rel, line, "<dynamic>",
                f"{call} with a non-literal knob name defeats the "
                "registry — use a literal or suppress with a reason",
                scope,
            ))
        for name, line, scope in v.raw:
            if name != "?":
                read_names.add(name)
            if in_pkg and not is_env_tier:
                findings.append(Finding(
                    CHECKER, mod.rel, line, name,
                    f"raw env read of {name} — use the typed accessor "
                    "tier (utils/env.py) so parse bugs cannot exist",
                    scope,
                ))
    for name, (path, line) in sorted(documented.items()):
        if name not in read_names and name not in _EXTERNAL_OK and name not in exempt:
            findings.append(Finding(
                CHECKER, path, line, name,
                f"documented env knob {name} has no read site in the "
                "scan set — stale doc row or dead knob",
                "<doc>",
            ))
    for name, (path, line) in sorted(exempt.items()):
        if name in read_names or name not in documented:
            why = ("now has a read site" if name in read_names
                   else "is documented in no other table")
            findings.append(Finding(
                CHECKER, path, line, name,
                f"stale exemption: env knob {name} is listed as unread but "
                f"{why} — delete its row", "<doc>",
            ))
    return findings

