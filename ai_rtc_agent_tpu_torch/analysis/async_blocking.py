"""Checker: blocking calls lexically inside ``async def`` bodies.

One wedged coroutine starves the whole media plane — the event loop runs
RTP RX, RTCP timers, signaling and the supervisor watchdogs for every
session in the process.  The reference shipped exactly this bug
(blocking ``requests.post`` on the loop, SURVEY.md section 5); this
checker makes the regression impossible.

Flagged inside an ``async def`` (but NOT inside a nested ``def`` — those
are routinely shipped to executors via ``asyncio.to_thread`` /
``run_in_executor``):

* ``time.sleep`` (use ``asyncio.sleep``)
* raw-socket I/O: ``recv*``/``send``/``sendto``/``sendall``/``accept``/
  ``connect`` on a receiver that *names a socket* (``sock`` in the
  identifier).  asyncio transports also expose ``sendto`` — those are
  non-blocking and not flagged.
* ``urllib.request.urlopen`` (use aiohttp)
* ``subprocess.run/call/check_output/check_call`` and ``os.system``
* unbounded ``.read()`` on a handle ``open()``-ed in the same function
* ``.acquire()`` without a timeout on a receiver that names a lock
  (``lock`` in the identifier) — a held lock parks the loop, a timeout
  at least bounds the damage (or hold it in a worker thread)
"""

from __future__ import annotations

import ast

from .core import Finding, ScopedVisitor, dotted, terminal_name

CHECKER = "async-blocking"

_SUBPROCESS = {"run", "call", "check_output", "check_call"}
_SOCKET_OPS = {
    "recv", "recvfrom", "recv_into", "recvfrom_into", "recvmsg",
    "recvmsg_into", "send", "sendall", "sendto", "accept", "connect",
}


def _names_socket(recv: str) -> bool:
    return "sock" in recv.lower()


def _names_lock(recv: str) -> bool:
    return "lock" in recv.lower()


class _AsyncBodyVisitor(ast.NodeVisitor):
    """Walks one async function body; stops at nested function defs."""

    def __init__(self, checker, mod, scope, imports):
        self.checker = checker
        self.mod = mod
        self.scope = scope
        self.imports = imports
        self.findings = []
        self.open_handles = set()

    # nested defs are separate execution contexts (often worker-thread
    # bodies); nested async defs get their own top-level visit
    def visit_FunctionDef(self, node):
        pass

    def visit_AsyncFunctionDef(self, node):
        pass

    def visit_Lambda(self, node):
        pass

    def _flag(self, node, name, message):
        self.findings.append(Finding(
            CHECKER, self.mod.rel, node.lineno, name, message, self.scope
        ))

    def visit_Assign(self, node):
        # track `f = open(...)` so later unbounded reads resolve
        v = node.value
        if isinstance(v, ast.Call) and dotted(v.func) in (
            "open", "io.open", "builtins.open"
        ):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.open_handles.add(t.id)
        self.generic_visit(node)

    def visit_With(self, node):
        for item in node.items:
            c = item.context_expr
            if (
                isinstance(c, ast.Call)
                and dotted(c.func) in ("open", "io.open", "builtins.open")
                and isinstance(item.optional_vars, ast.Name)
            ):
                self.open_handles.add(item.optional_vars.id)
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    def visit_Call(self, node):
        name = dotted(node.func)
        tail = terminal_name(node.func)
        recv = (
            dotted(node.func.value)
            if isinstance(node.func, ast.Attribute)
            else ""
        )
        if name == "time.sleep" or (
            tail == "sleep" and self.imports.get("sleep") == "time"
        ):
            self._flag(node, "time.sleep",
                       "time.sleep blocks the event loop — await "
                       "asyncio.sleep instead")
        elif name == "urllib.request.urlopen" or (
            tail == "urlopen"
            and self.imports.get("urlopen") == "urllib.request"
        ):
            self._flag(node, "urlopen",
                       "urllib urlopen blocks the event loop — use aiohttp "
                       "or asyncio.to_thread")
        elif name.startswith("subprocess.") and tail in _SUBPROCESS:
            self._flag(node, name,
                       f"{name} blocks the event loop — use "
                       "asyncio.create_subprocess_exec")
        elif name == "os.system":
            self._flag(node, name,
                       "os.system blocks the event loop — use "
                       "asyncio.create_subprocess_shell")
        elif tail in _SOCKET_OPS and recv and _names_socket(recv):
            self._flag(node, f"{recv}.{tail}",
                       f"raw-socket {tail} on the event loop can block — "
                       "use loop.sock_* / a transport, or a non-blocking "
                       "socket with a drain")
        elif tail == "read" and isinstance(node.func, ast.Attribute):
            base = node.func.value
            if (
                isinstance(base, ast.Name)
                and base.id in self.open_handles
                and not node.args
            ):
                self._flag(node, f"{base.id}.read",
                           "unbounded file read on the event loop — bound "
                           "it or use asyncio.to_thread")
        elif tail == "acquire" and recv and _names_lock(recv):
            kwnames = {k.arg for k in node.keywords}
            if not node.args and not ({"timeout", "blocking"} & kwnames):
                self._flag(node, f"{recv}.acquire",
                           "lock acquire without a timeout can park the "
                           "event loop — pass timeout= or move the wait to "
                           "a thread")
        self.generic_visit(node)


class _Visitor(ScopedVisitor):
    def __init__(self, mod, imports):
        super().__init__()
        self.mod = mod
        self.imports = imports
        self.findings = []

    def visit_AsyncFunctionDef(self, node):
        self._stack.append(node.name)
        body = _AsyncBodyVisitor(CHECKER, self.mod, self.scope, self.imports)
        for stmt in node.body:
            body.visit(stmt)
        self.findings.extend(body.findings)
        # nested async defs still need their own walk
        self.generic_visit(node)
        self._stack.pop()


def _import_map(tree) -> dict:
    """name -> source module for `from X import name` (sleep, urlopen)."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = node.module
    return out


def check(project) -> list:
    findings = []
    for mod in project.modules:
        v = _Visitor(mod, _import_map(mod.tree))
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
