"""Shared analyzer plumbing: project loading, findings, suppressions.

A finding's :meth:`Finding.key` deliberately excludes the line number, so
the checked-in baseline survives unrelated edits above a finding; the
line is still reported for humans.  Suppressions are per-finding inline
comments with a mandatory reason::

    pkts = self._hold(view)  # tpurtc: allow[pooled-view] -- copied in _hold

placed on the flagged line or the line directly above.  A reasonless or
unused suppression is itself a finding (checker id ``suppression``) —
the allowlist can never silently rot.

Every path and name a rule needs of the tree it scans (the env tier, the
registries, the wire and events modules, the codec tier, the exempt
tooling, the staging and readback helpers, the capture entry points and
step factories) comes from a :class:`Profile`; :data:`PORT`, the default, is this
package's.  The same rules, given another tree's profile, check that tree.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path

SUPPRESSION_RE = re.compile(
    r"#\s*tpurtc:\s*allow\[([a-z0-9_,-]+)\]\s*(?:--\s*(\S.*))?$"
)

# directories never scanned (fixtures are known-bad on purpose)
SKIP_PARTS = {"__pycache__", ".git", "tests", "node_modules"}

DEFAULT_ROOTS = ("ai_rtc_agent_tpu_torch",)


@dataclass(frozen=True)
class Profile:
    """The tree-specific half of the rules: every repo-relative path,
    prefix and name a checker would otherwise hard-code."""

    roots: tuple  # what a full scan loads
    package: str  # prefix inside which env reads must use the typed tier
    env_tier: str  # the typed accessor module (the one dynamic knob reader)
    env_docs: tuple  # knob registries: markdown tables, read together
    env_unread_heading: str | None  # section listing documented knobs left unread
    http_doc: str  # the route registry
    wire: str  # the closed cross-process header vocabulary
    events: str  # the closed webhook vocabulary (EVENT_NAMES / STATE_NAMES)
    codec: tuple  # the codec tier and its loader: tr_h264_* calls live there
    vocab_exempt: tuple  # prefixes with their own wire state machines
    route_table: str | None  # module-level literal (METHOD, path[, handler]) tables
    analysis: str  # the analyzer itself (quotes wire vocabulary to check it)
    tooling_prefixes: tuple = ("scripts/", "examples/")
    tooling_files: tuple = ("bench.py", "__graft_entry__.py")
    # device-transfer: (file, qualname) scopes whose job is a crossing (a
    # class blesses its methods), files exempt wholesale, and the names that
    # taint a value as a step output or a captured step
    transfer_blessed: tuple = ()
    transfer_exempt: tuple = ()
    staging_calls: tuple = ()  # their result is a staged device frame
    step_attrs: tuple = ()  # self.<attr>(...) / self.<attr>[k](...) runs a step
    step_getters: tuple = ()  # their result is a captured step (so is a capture call's)
    # capture-purity: (call name, position, keyword) of the function a
    # capture call records; dotted suffixes of ``get(key, build)`` calls
    # whose build returns (fn, inputs); (file, name) of step factories
    capture_calls: tuple = ()
    capture_build_calls: tuple = ()
    step_factories: tuple = ()

    def tooling(self, rel: str) -> bool:
        """Operator tooling and process-lifecycle code, exempt from the
        serving-code rules."""
        return rel.startswith(self.tooling_prefixes) or rel in self.tooling_files


_PKG = "ai_rtc_agent_tpu_torch/"

PORT = Profile(
    roots=DEFAULT_ROOTS,
    package=_PKG,
    env_tier=_PKG + "utils/env.py",
    env_docs=("docs/environment.md", _PKG + "environment.md"),
    env_unread_heading="Knobs the port does not read",
    http_doc="docs/http-api.md",
    wire=_PKG + "server/wire.py",
    events=_PKG + "server/events.py",
    codec=(_PKG + "media/codec.py", _PKG + "media/native.py"),
    vocab_exempt=(_PKG + "server/secure/",),
    route_table="ROUTES",
    analysis=_PKG + "analysis/",
    tooling_files=("bench.py", "__graft_entry__.py", "chip_smoke.py"),
    transfer_blessed=(
        (_PKG + "stream/engine.py", "stage_into"),
        (_PKG + "stream/engine.py", "_Readback"),
        (_PKG + "stream/engine.py", "StreamEngine.follow_step"),
        (_PKG + "parallel/multipeer.py", "stage_rows"),
        (_PKG + "parallel/multipeer.py", "_upload"),
        (_PKG + "parallel/multipeer.py", "Readback"),
        (_PKG + "parallel/multipeer.py", "ShardedReadback"),
        (_PKG + "parallel/multipeer.py", "replicate"),
        (_PKG + "parallel/serving.py", "LockstepEngine._send_step"),
    ),
    transfer_exempt=(
        _PKG + "aot/cache.py",
        _PKG + "parallel/sharding.py",
        _PKG + "parallel/trainer.py",
        _PKG + "parallel/checkpoint.py",
        _PKG + "models/loader.py",
        _PKG + "models/lora.py",
        _PKG + "bridge.py",
    ),
    staging_calls=("stage_rows", "stage_into"),
    step_attrs=("_steps", "_step"),
    step_getters=("step_for",),
    capture_calls=(("CapturedStep", 1, "fn"),),
    capture_build_calls=("graph_cache.get",),
    step_factories=((_PKG + "stream/engine.py", "make_step_fn"),
                    (_PKG + "stream/engine.py", "make_session_step_fn")),
)


@dataclass
class Finding:
    checker: str
    path: str  # repo-relative, '/'-separated
    line: int
    name: str  # the offending symbol / knob / metric
    message: str
    scope: str = "<module>"  # enclosing function qualname

    def key(self) -> str:
        """Stable baseline identity (no line number — survives drift)."""
        return f"{self.checker}:{self.path}:{self.scope}:{self.name}"

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}: [{self.checker}] {self.message}"
            f" (in {self.scope})"
        )


@dataclass
class Suppression:
    line: int
    checkers: tuple
    reason: str | None
    used: bool = False


@dataclass
class Module:
    path: Path
    rel: str
    source: str
    tree: ast.Module
    suppressions: list = field(default_factory=list)

    def suppression_for(self, checker: str, line: int):
        """The suppression covering ``checker`` at ``line`` (same line or
        the line directly above), or None."""
        for s in self.suppressions:
            if s.line in (line, line - 1) and checker in s.checkers:
                return s
        return None


@dataclass
class Project:
    root: Path
    modules: list

    def module(self, rel: str):
        for m in self.modules:
            if m.rel == rel:
                return m
        return None

    def doc_text(self, rel: str) -> str:
        p = self.root / rel
        return p.read_text() if p.exists() else ""


def _parse_suppressions(source: str) -> list:
    """Real COMMENT tokens only — a suppression example quoted in a
    docstring must not become a live allow."""
    out = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = SUPPRESSION_RE.search(tok.string)
            if m:
                checkers = tuple(c.strip() for c in m.group(1).split(","))
                out.append(Suppression(tok.start[0], checkers, m.group(2)))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass  # ast.parse accepted it; lose suppressions, not the run
    return out


def load_module(path: Path, root: Path):
    """-> (Module | None, Finding | None): unparseable files become a
    ``parse-error`` finding instead of killing the run."""
    try:
        rel = path.relative_to(root).as_posix()
    except ValueError:  # outside the repo (fixture / probe runs)
        rel = path.as_posix()
    source = path.read_text(errors="replace")
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return None, Finding(
            "parse-error", rel, e.lineno or 1, path.name,
            f"cannot parse: {e.msg}",
        )
    except ValueError as e:  # e.g. NUL bytes in the source
        return None, Finding(
            "parse-error", rel, 1, path.name, f"cannot parse: {e}",
        )
    return Module(path, rel, source, tree, _parse_suppressions(source)), None


def iter_py_files(root: Path, roots=DEFAULT_ROOTS):
    for r in roots:
        p = root / r
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                # skip-list applies to REPO-relative parts only — a
                # checkout under a directory named tests/ must not
                # skip the whole repo
                if not (set(f.relative_to(root).parts) & SKIP_PARTS):
                    yield f


def load_project(root, roots=DEFAULT_ROOTS, files=None):
    """Load the scan set.  ``files`` (explicit paths, e.g. --changed mode)
    overrides ``roots``.  -> (Project, [parse-error findings])."""
    root = Path(root).resolve()
    errors = []
    modules = []
    paths = (
        [Path(f).resolve() for f in files]
        if files is not None
        else iter_py_files(root, roots)
    )
    for p in paths:
        if not p.exists() or p.suffix != ".py":
            continue
        mod, err = load_module(p, root)
        if err is not None:
            errors.append(err)
        else:
            modules.append(mod)
    return Project(root, modules), errors


def apply_suppressions(project: Project, findings: list, ran=None) -> list:
    """Drop findings covered by an inline allow; then add suppression-
    hygiene findings (missing reason, unused allow).  ``ran`` is the set
    of checkers that actually executed — an allow for a checker that was
    skipped this run (--changed / explicit files) cannot be proven
    unused."""
    for mod in project.modules:  # a project may be checked more than once
        for s in mod.suppressions:
            s.used = False
    kept = []
    for f in findings:
        mod = project.module(f.path)
        s = mod.suppression_for(f.checker, f.line) if mod else None
        if s is not None:
            s.used = True
            if s.reason:  # reasonless allows do NOT suppress
                continue
        kept.append(f)
    for mod in project.modules:
        for s in mod.suppressions:
            if not s.reason:
                kept.append(Finding(
                    "suppression", mod.rel, s.line,
                    ",".join(s.checkers),
                    "suppression without a reason — append "
                    "'-- <why this is safe>'",
                ))
            elif not s.used and (
                ran is None or set(s.checkers) & set(ran)
            ):
                kept.append(Finding(
                    "suppression", mod.rel, s.line,
                    ",".join(s.checkers),
                    "unused suppression — the finding it allowed is gone; "
                    "delete the comment",
                ))
    return kept


def run_checkers(project: Project, checkers=None, profile: Profile = PORT) -> list:
    from functools import partial

    from . import (
        async_blocking,
        bounded_queues,
        device_transfers,
        encoder_reconfig,
        env_registry,
        http_contract,
        lock_discipline,
        loop_affinity,
        metric_cardinality,
        metrics_registry,
        pooled_views,
        refusal_discipline,
        regressions,
        reservation_pairing,
        span_pairing,
        task_lifecycle,
        trace_purity,
    )

    def profiled(check):
        return partial(check, profile=profile)

    registry = {
        "async-blocking": async_blocking.check,
        "bounded-queue": profiled(bounded_queues.check),
        "encoder-reconfig": profiled(encoder_reconfig.check),
        "lock-discipline": profiled(lock_discipline.check),
        "loop-affinity": profiled(loop_affinity.check),
        "metric-cardinality": profiled(metric_cardinality.check),
        "pooled-view": pooled_views.check,
        "span-pairing": span_pairing.check,
        "task-lifecycle": profiled(task_lifecycle.check),
        "env-registry": profiled(env_registry.check),
        "metrics-registry": metrics_registry.check,
        "retry-4xx": regressions.check_retry_4xx,
        "restart-defaults": regressions.check_restart_defaults,
        "http-contract": profiled(http_contract.check),
        "refusal-discipline": profiled(refusal_discipline.check),
        "reservation-pairing": profiled(reservation_pairing.check),
        "device-transfer": profiled(device_transfers.check),
        "capture-purity": profiled(trace_purity.check),
    }
    findings = []
    ran = tuple(checkers or registry)
    for name in ran:
        findings.extend(registry[name](project))
    findings = apply_suppressions(project, findings, ran=ran)
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    return findings


ALL_CHECKERS = (
    "async-blocking",
    "bounded-queue",
    "encoder-reconfig",
    "lock-discipline",
    "loop-affinity",
    "metric-cardinality",
    "pooled-view",
    "span-pairing",
    "task-lifecycle",
    "env-registry",
    "metrics-registry",
    "retry-4xx",
    "restart-defaults",
    "http-contract",
    "refusal-discipline",
    "reservation-pairing",
    "device-transfer",
    "capture-purity",
)

#: cross-file registry rules: a partial scan (``--changed``, explicit files)
#: cannot prove them, so it runs the rest
REGISTRY_CHECKERS = ("env-registry", "metrics-registry", "http-contract")


# -- shared AST helpers ------------------------------------------------------

def dotted(node) -> str:
    """Best-effort dotted name of an expression ('time.sleep',
    'self._pool.acquire'); '' when it has no static name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        parts.append("?")
    return ".".join(reversed(parts))


def terminal_name(node) -> str:
    """Rightmost identifier of a Name/Attribute ('self._pool' -> '_pool')."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def const_str(node):
    """The literal string value of a node, or None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def attr_of_self(expr):
    """'x' for ``self.x``, else None (the shared instance-attribute
    convention of the concurrency checkers)."""
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        return expr.attr
    return None


_LOCK_TOKENS = {"lock", "locks", "rlock", "mutex", "cond", "condition", "cv"}


def lock_terminal(expr) -> str:
    """Terminal identifier of a lock expression, unwrapping call forms
    (``self._lock_for(key)`` names ``_lock_for``)."""
    while isinstance(expr, ast.Call):
        expr = expr.func
    return terminal_name(expr)


def lockish_name(expr) -> bool:
    """Does the expression's terminal identifier name a lock?  Shared by
    lock-discipline and loop-affinity so the two checkers can never
    disagree about what counts as a lock.  Matching is per snake_case
    TOKEN, not substring — ``_submit_lock``/``_ring_lock``/``_cv`` hit,
    while ``_blocking_guard``/``_per_second``/``_clock`` do not (a
    substring match would flag every ``block`` and ``seconds``)."""
    tokens = lock_terminal(expr).lower().split("_")
    return any(t in _LOCK_TOKENS for t in tokens)


def import_maps(tree):
    """-> (local name -> (module, original name), module alias -> module):
    `from asyncio import Queue as Q` binds Q -> ("asyncio", "Queue") and
    `import collections as c` binds c -> "collections", so renamed
    imports cannot smuggle a flagged construct past a dotted-name scan."""
    frm, mods = {}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                frm[a.asname or a.name] = (node.module, a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    mods[a.asname] = a.name
    return frm, mods


def canonical_dotted(func, frm, mods) -> str:
    """``dotted(func)`` with the leading segment resolved through the
    module's import aliases: ``Q(...)`` -> "asyncio.Queue",
    ``aio.Event(...)`` -> "asyncio.Event"."""
    d = dotted(func)
    if not d:
        return ""
    parts = d.split(".")
    if parts[0] in frm:
        module, orig = frm[parts[0]]
        parts = module.split(".") + [orig] + parts[1:]
    elif parts[0] in mods:
        parts = mods[parts[0]].split(".") + parts[1:]
    return ".".join(parts)


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor tracking the enclosing function qualname in
    ``self.scope`` ('Class.method' / '<module>')."""

    def __init__(self):
        self._stack = []

    @property
    def scope(self) -> str:
        return ".".join(self._stack) or "<module>"

    def _in_named(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _in_named
    visit_AsyncFunctionDef = _in_named
    visit_ClassDef = _in_named
