"""Checker: pool-returned memoryviews escaping frame scope.

The zero-copy host plane hands out views into rotating buffer pools
(media/rtp.py packetizers, media/sockio.py DatagramDrain, media/ring.py
pooled pop, media/plane.py H264Sink.consume).  The contract (media/rtp.py
module docstring): a view is valid until the pool wraps — holders beyond
frame scope MUST copy.  The chaos-TX bug was exactly this invariant
broken by hand-off to the fault injector, which can hold packets across
calls; this checker mechanizes the rule.

Taint sources (call sites):
* ``<x>.packetize(...)``                       (any receiver)
* ``<sink>.consume(...)``    when the receiver names a sink
* ``<pool>.acquire(...)``    when the receiver names a pool
* ``<ring>.pop(...)``        when the receiver names a ring
* the first parameter of a callback passed to ``<drain>.drain(...)``

Escapes (sinks) for a tainted value:
* stored into an attribute (``self.x = v`` / ``self.x[k] = v``)
* ``.append/.add/.extend/.insert`` onto an attribute-held container
* handed to deferred execution: ``call_later`` / ``call_soon[_threadsafe]``
  / ``put_nowait`` / ``put`` / ``ensure_future``
* handed to a fault injector's ``.apply`` (holds packets across calls —
  the shipped chaos-TX bug)
* called through an opaque callback parameter

Stabilizers (clear taint): ``bytes(v)``, ``bytearray(v)``, ``v.tobytes()``,
``v.copy()``, ``np.array(v)``.  Taint follows simple assignment, tuple
unpacking, ``for`` targets, subscripts/slices, and one level of
same-module calls (tainted argument -> callee parameter, depth-bounded).

The analysis is flow-insensitive per function but processed in statement
order with an optimistic reassignment rule: ``pkt = bytes(pkt)`` clears
``pkt`` — the idiom the host plane uses at every legitimate hold point.
"""

from __future__ import annotations

import ast

from .core import Finding, dotted, terminal_name

CHECKER = "pooled-view"

_DEFER_CALLS = {
    "call_later", "call_soon", "call_soon_threadsafe", "put_nowait",
    "put", "ensure_future",
}
_CONTAINER_ADD = {"append", "add", "extend", "insert", "appendleft"}
_STABILIZE_FUNCS = {"bytes", "bytearray"}
_STABILIZE_METHODS = {"tobytes", "copy"}
_MAX_DEPTH = 3


def _is_source(call: ast.Call) -> bool:
    if not isinstance(call.func, ast.Attribute):
        return False
    attr = call.func.attr
    recv = terminal_name(call.func.value).lower()
    if attr == "packetize":
        return True
    if attr == "consume" and "sink" in recv:
        return True
    if attr == "acquire" and "pool" in recv:
        return True
    if attr == "pop" and "ring" in recv:
        return True
    return False


class _FunctionIndex:
    """Module-wide map of functions/methods for same-module call
    resolution: 'name' -> def node (module level), and method name ->
    def node (any class — receiver types are not tracked, so a method
    name is resolved when unambiguous)."""

    def __init__(self, tree):
        self.module_funcs = {}
        self.methods = {}
        self.qual = {}
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.module_funcs[node.name] = node
                self.qual[id(node)] = node.name
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self.methods.setdefault(item.name, []).append(item)
                        self.qual[id(item)] = f"{node.name}.{item.name}"

    def resolve(self, func_expr):
        """Callee def node for `name(...)` or `self.name(...)`, or None."""
        if isinstance(func_expr, ast.Name):
            return self.module_funcs.get(func_expr.id)
        if (
            isinstance(func_expr, ast.Attribute)
            and isinstance(func_expr.value, ast.Name)
            and func_expr.value.id in ("self", "cls")
        ):
            cands = self.methods.get(func_expr.attr, [])
            if len(cands) == 1:
                return cands[0]
        return None

    def qualname(self, node) -> str:
        return self.qual.get(id(node), getattr(node, "name", "<fn>"))


def _params(node):
    a = node.args
    names = [p.arg for p in a.posonlyargs + a.args]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    return names


class _FuncTaint:
    """Statement-order taint walk over one function body."""

    def __init__(self, mod, index, node, tainted_params, findings, queue,
                 depth):
        self.mod = mod
        self.index = index
        self.node = node
        self.scope = index.qualname(node)
        self.findings = findings
        self.queue = queue
        self.depth = depth
        self.tainted = set(tainted_params)
        self.param_names = set(_params(node)) | {
            p.arg for p in node.args.kwonlyargs
        }

    # -- expression taint ---------------------------------------------------

    def is_tainted(self, expr) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.tainted
        if isinstance(expr, ast.Subscript):
            return self.is_tainted(expr.value)
        if isinstance(expr, ast.Starred):
            return self.is_tainted(expr.value)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_tainted(e) for e in expr.elts)
        if isinstance(expr, ast.IfExp):
            return self.is_tainted(expr.body) or self.is_tainted(expr.orelse)
        if isinstance(expr, ast.Call):
            f = expr.func
            if isinstance(f, ast.Name) and f.id in _STABILIZE_FUNCS:
                return False
            if isinstance(f, ast.Attribute) and f.attr in _STABILIZE_METHODS:
                return False
            if isinstance(f, ast.Name) and f.id == "memoryview":
                return any(self.is_tainted(a) for a in expr.args)
            if _is_source(expr):
                return True
            return False
        return False

    def _flag(self, node, name, message):
        self.findings.append(Finding(
            CHECKER, self.mod.rel, node.lineno, name, message, self.scope
        ))

    # -- statements ---------------------------------------------------------

    def run(self):
        self._block(self.node.body)

    def _block(self, stmts):
        for s in stmts:
            self._stmt(s)

    def _stmt(self, s):
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # separate scope; sources there get their own walk
        if isinstance(s, ast.Assign):
            self._assign(s.targets, s.value)
            self._expr(s.value)
        elif isinstance(s, ast.AnnAssign) and s.value is not None:
            self._assign([s.target], s.value)
            self._expr(s.value)
        elif isinstance(s, ast.AugAssign):
            self._expr(s.value)
        elif isinstance(s, ast.Expr):
            self._expr(s.value)
        elif isinstance(s, (ast.If,)):
            self._expr(s.test)
            self._block(s.body)
            self._block(s.orelse)
        elif isinstance(s, (ast.For, ast.AsyncFor)):
            self._expr(s.iter)
            if self.is_tainted(s.iter):
                for n in ast.walk(s.target):
                    if isinstance(n, ast.Name):
                        self.tainted.add(n.id)
            # two passes so back-edge taint reaches earlier statements
            self._block(s.body)
            self._block(s.body)
            self._block(s.orelse)
        elif isinstance(s, ast.While):
            self._expr(s.test)
            self._block(s.body)
            self._block(s.body)
            self._block(s.orelse)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self._expr(item.context_expr)
            self._block(s.body)
        elif isinstance(s, ast.Try):
            self._block(s.body)
            for h in s.handlers:
                self._block(h.body)
            self._block(s.orelse)
            self._block(s.finalbody)
        elif isinstance(s, ast.Return) and s.value is not None:
            self._expr(s.value)
        # other statements carry no taint flow we track

    def _assign(self, targets, value):
        tainted = self.is_tainted(value)
        for t in targets:
            if isinstance(t, ast.Name):
                if tainted:
                    self.tainted.add(t.id)
                else:
                    self.tainted.discard(t.id)  # optimistic reassignment
            elif isinstance(t, ast.Tuple) and tainted:
                for n in t.elts:
                    if isinstance(n, ast.Name):
                        self.tainted.add(n.id)
            elif isinstance(t, ast.Attribute) and tainted:
                self._flag(
                    t, dotted(t),
                    f"pooled view stored into attribute {dotted(t)} — it "
                    "outlives the pool slot; stabilize with .tobytes()/"
                    "bytes() first",
                )
            elif isinstance(t, ast.Subscript) and tainted:
                base = t.value
                if isinstance(base, ast.Attribute):
                    self._flag(
                        t, dotted(base),
                        f"pooled view stored into container {dotted(base)} "
                        "— it outlives the pool slot; stabilize first",
                    )

    # -- calls: sinks + propagation ----------------------------------------

    def _expr(self, e):
        for call in [n for n in ast.walk(e) if isinstance(n, ast.Call)]:
            self._call(call)

    def _call(self, call: ast.Call):
        tainted_pos = [
            i for i, a in enumerate(call.args) if self.is_tainted(a)
        ]
        if not tainted_pos:
            return
        f = call.func
        name = dotted(f)
        if isinstance(f, ast.Attribute):
            recv = f.value
            attr = f.attr
            if attr in _STABILIZE_METHODS:
                return
            if attr in _CONTAINER_ADD and isinstance(recv, ast.Attribute):
                self._flag(
                    call, dotted(recv),
                    f"pooled view {attr}ed to {dotted(recv)} — the "
                    "container outlives the pool slot; stabilize first",
                )
                return
            if attr in _DEFER_CALLS:
                self._flag(
                    call, name,
                    f"pooled view handed to {attr} — it is consumed after "
                    "this frame returns, when the pool may have wrapped; "
                    "stabilize first",
                )
                return
            if attr == "apply" and "fault" in terminal_name(recv).lower():
                self._flag(
                    call, name,
                    "pooled view handed to a fault injector — injected "
                    "reorder/delay holds packets across calls (the PR 2 "
                    "chaos-TX bug); stabilize first",
                )
                return
        callee = self.index.resolve(f)
        if callee is not None:
            params = _params(callee)
            seed = frozenset(
                params[i] for i in tainted_pos if i < len(params)
            )
            if seed:
                self.queue.append((callee, seed, self.depth + 1))
            return
        if isinstance(f, ast.Name) and f.id in self.param_names:
            self._flag(
                call, f.id,
                f"pooled view passed to opaque callback {f.id}() — the "
                "callee may hold it past frame scope; stabilize or "
                "document via the pool contract",
            )


def _seed_drain_callbacks(mod, index, queue):
    """`<drain>.drain(sock, cb)` -> taint cb's first parameter."""
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr != "drain" or len(node.args) < 2:
            continue
        if "drain" not in terminal_name(node.func.value).lower():
            continue
        cb = index.resolve(node.args[1])
        if cb is not None:
            params = _params(cb)
            if params:
                queue.append((cb, frozenset({params[0]}), 1))


def check(project) -> list:
    findings = []
    for mod in project.modules:
        index = _FunctionIndex(mod.tree)
        queue = []
        # every function gets a no-seed walk (sources may be local)
        funcs = list(index.module_funcs.values())
        for cands in index.methods.values():
            funcs.extend(cands)
        for fn in funcs:
            queue.append((fn, frozenset(), 0))
        _seed_drain_callbacks(mod, index, queue)
        seen = set()
        while queue:
            fn, seed, depth = queue.pop()
            key = (id(fn), seed)
            if key in seen or depth > _MAX_DEPTH:
                continue
            seen.add(key)
            _FuncTaint(mod, index, fn, seed, findings, queue, depth).run()
    # a (scope, name, line) can be reached via several seeds — dedupe
    uniq = {}
    for f in findings:
        uniq[(f.path, f.line, f.name, f.message)] = f
    return list(uniq.values())
