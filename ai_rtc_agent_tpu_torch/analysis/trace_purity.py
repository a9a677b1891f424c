"""Checker ``capture-purity``: a function that a CUDA graph captures must not
read the host.  It stands for the JAX package's ``trace-purity`` rule.

A CUDA graph freezes a step as a JAX trace does: :class:`~..aot.cache.CapturedStep`
runs the step function once under capture, and every replay launches what
that one call recorded.  A value the function read from the host (an env
knob, a clock, a host RNG draw, a file) is frozen into the graph, so a knob
flip "does nothing"; a host crossing (``.item()``, ``.cpu()``, a
``torch.cuda.synchronize``) fails the capture on the card or is baked into
it; ``torch.from_numpy`` / ``torch.tensor`` of host data records one H2D
copy of whatever the host held at capture.  On the CPU the captured steps
run eagerly, so only this rule holds that line before the card does.

Seeds — a function is captured when it is:

* the ``fn`` handed to a capture call (``CapturedStep(key, fn, inputs)``,
  the profile's ``capture_calls``);
* the first element of what the ``build`` handed to a graph cache's
  ``get`` returns (``graph_cache.get(key, build)``, ``capture_build_calls``);
* as in JAX's factory rule, every def nested in a factory whose result such
  a function calls: a same-module function, or one of the profile's
  ``step_factories`` in its own module (``make_step_fn``,
  ``make_session_step_fn``), reached through a name or ``self`` attribute
  bound to the factory's call (``self._steps = {v: make_step_fn(...)}``,
  ``fn = self._steps[v]``; composed wrappers such as
  ``_sp_wrapped(make_step_fn(...))`` seed both).

The closure is then walked through same-module calls (``helper(x)`` /
``self.helper(x)``); impurities are reported where they lexically occur.
Documented limits, as in JAX: calls into other modules are not followed
(the ops and models a step calls are torch code over its arguments), and
impure modules are matched by their canonical names.  A partial scan
(``--changed``) still seeds and walks over the whole tree, and reports only
in the files it scans, so it agrees with a full scan there.

Flagged: ``os.environ`` / ``os.getenv`` reads and any call of the env
tier (``env.get_*`` and the named accessors such as ``env.attn_impl()``:
every function there reads the environment), ``time.*`` clocks and sleeps,
``np.random.*`` / ``random.*`` host RNG, ``open()``, ``print()``,
``subprocess``; ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
``.to("cpu")``, ``torch.cuda.synchronize``, ``torch.from_numpy`` /
``torch.as_tensor`` / ``torch.tensor`` of host data, and the implicit syncs:
a tensor's truth value (``if t.any():``) and ``float`` / ``int`` / ``bool``
of a tensor, where the tensor is a ``torch.*`` call, a reduction, or a name
bound to one (a bare parameter has no type here, so ``float(t)`` of an
argument passes).
Device RNG with an explicit ``torch.Generator`` (``torch.randn(...,
generator=g)``), the counterpart of ``jax.random``, is allowed.
"""

from __future__ import annotations

import ast

from .core import PORT, Finding, dotted, iter_py_files, load_module, terminal_name

CHECKER = "capture-purity"

_TIME_FNS = {
    "time", "monotonic", "perf_counter", "process_time", "time_ns",
    "monotonic_ns", "perf_counter_ns", "sleep",
}
_CROSSING_METHODS = {"item", "tolist", "cpu", "numpy"}
_TENSOR_FROM = {"torch.as_tensor", "torch.tensor", "torch.asarray"}
_HOST_BUILTINS = {"float", "int", "bool", "list", "tuple", "len", "range"}
_CASTS = {"float", "int", "bool"}
_REDUCTIONS = {"any", "all", "sum", "mean", "max", "min", "amax", "amin", "prod", "norm",
               "std", "var", "count_nonzero", "equal", "allclose"}
_HOST_MODULES = {"np", "numpy", "math", "operator", "builtins"}
# tensor methods that give the host a Python value without a sync
_HOST_METHODS = {"size", "dim", "numel", "element_size", "stride", "data_ptr",
                 "get_device", "is_contiguous", "is_floating_point", "item", "tolist"}


def _host_data(expr) -> bool:
    """Data that lives on the host: a literal, a display, a numpy call or
    a Python builtin's result."""
    if isinstance(expr, (ast.Constant, ast.List, ast.Tuple, ast.Set, ast.Dict, ast.ListComp)):
        return True
    if isinstance(expr, ast.Call):
        name = dotted(expr.func)
        return name.split(".")[0] in ("np", "numpy") or name in _HOST_BUILTINS
    return False


def _impurity(call: ast.Call, env_modules) -> str | None:
    """Why this call must not run inside a captured function, or None."""
    name = dotted(call.func)
    if not name:
        return None
    parts = name.split(".")
    if name in ("os.getenv", "os.environ.get"):
        return "env read is frozen into the graph at capture"
    if (len(parts) == 2 and parts[0] in env_modules) or (len(parts) == 1 and name in env_modules):
        # every function of the env tier reads the environment: get_* and
        # the named accessors (attn_impl(), mesh_shape(), ...) alike
        return "typed env accessor read is frozen into the graph at capture"
    if parts[0] == "time" and len(parts) == 2 and parts[1] in _TIME_FNS:
        return "host clock is frozen into the graph at capture"
    if len(parts) >= 3 and parts[0] in ("np", "numpy") and parts[1] == "random":
        return "host RNG draws once at capture; use torch RNG with a torch.Generator"
    if parts[0] == "random" and len(parts) == 2:
        return "host RNG draws once at capture; use torch RNG with a torch.Generator"
    if name == "open":
        return "host file I/O inside a captured function"
    if name == "print":
        return "host print runs at capture only"
    if parts[0] == "subprocess":
        return "host subprocess inside a captured function"
    if name == "torch.cuda.synchronize":
        return "a device sync inside a capture fails it"
    if name == "torch.from_numpy" or (name in _TENSOR_FROM and call.args
                                      and _host_data(call.args[0])):
        return "an H2D copy of host data baked into the graph at capture"
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in _CROSSING_METHODS:
            return f"a host crossing (.{attr}()) inside a captured step"
        if attr == "to" and any(isinstance(a, ast.Constant) and a.value == "cpu"
                                for a in [*call.args, *(k.value for k in call.keywords
                                                        if k.arg == "device")]):
            return 'a host crossing (.to("cpu")) inside a captured step'
    return None


def _tensorish(expr, names) -> bool:
    """An expression whose value is a device tensor: a ``torch.*`` call,
    a tensor reduction, a tensor method's result, a name bound to one, or
    an operation on one.  A bare parameter is not seen (there are no
    types), so ``float(t)`` of an argument passes."""
    if isinstance(expr, ast.Name):
        return expr.id in names
    if isinstance(expr, ast.Call):
        name = dotted(expr.func)
        if name.startswith("torch.") and not name.startswith(
                ("torch.cuda.", "torch.distributed.", "torch.backends.")):
            return not name.split(".")[-1].startswith(("is_", "get_", "Size"))
        if (isinstance(expr.func, ast.Attribute) and expr.func.attr not in _HOST_METHODS
                and name.split(".")[0] not in _HOST_MODULES):
            return expr.func.attr in _REDUCTIONS or _tensorish(expr.func.value, names)
        return False
    if isinstance(expr, ast.Subscript):
        return _tensorish(expr.value, names)
    if isinstance(expr, ast.BinOp):
        return _tensorish(expr.left, names) or _tensorish(expr.right, names)
    if isinstance(expr, ast.UnaryOp):
        return _tensorish(expr.operand, names)
    if isinstance(expr, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in expr.ops):
            return False
        return any(_tensorish(e, names) for e in (expr.left, *expr.comparators))
    return False


def _tensor_names(fn) -> set:
    """The names ``fn`` binds to a tensor (:func:`_tensorish`), to a fixpoint."""
    assigns = [(t.id, n.value) for n in ast.walk(fn) if isinstance(n, ast.Assign)
               for t in n.targets if isinstance(t, ast.Name)]
    names: set = set()
    while more := {t for t, v in assigns if t not in names and _tensorish(v, names)}:
        names |= more
    return names


def _implicit_syncs(fn):
    """-> [(node, name, why)]: a tensor's truth value (``if t.any():``) or
    a cast of a tensor to a Python number (``float(t.sum())``), each a
    device sync that a capture fails on."""
    names = _tensor_names(fn)
    out = []
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in _CASTS and node.args and _tensorish(node.args[0], names)):
            out.append((node, node.func.id, f"{node.func.id}() of a tensor syncs the device"))
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            tests = [node.test]
            while tests:
                t = tests.pop()
                if isinstance(t, ast.BoolOp):
                    tests.extend(t.values)
                elif isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not):
                    tests.append(t.operand)
                elif _tensorish(t, names):
                    out.append((t, "bool", "a tensor's truth value syncs the device"))
    return out


def _impure_subscript(node) -> str | None:
    """os.environ[...] subscript reads."""
    if isinstance(node, ast.Subscript) and dotted(node.value) == "os.environ":
        return "env read is frozen into the graph at capture"
    return None


def _nested_defs(fn) -> list:
    return [n for n in ast.walk(fn) if n is not fn
            and isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


class _ModuleFuncs:
    """A module's defs by name (module functions, methods, nested defs:
    the first of a name wins after module level), its qualnames, and
    what each name and ``self`` attribute is bound to."""

    def __init__(self, mod):
        self.mod = mod
        self.defs: dict = {}
        self.qualnames: dict = {}
        self.bindings: dict = {}  # ("name", id) / ("attr", X) -> [value expressions]
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs[node.name] = node
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self.defs.setdefault(item.name, item)
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for inner in _nested_defs(node):
                    self.defs.setdefault(inner.name, inner)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)) and node.value is not None:
                for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                    for key in self._keys(t):
                        self.bindings.setdefault(key, []).append(node.value)
        self._qualify(mod.tree, [])

    @staticmethod
    def _keys(target) -> list:
        if isinstance(target, ast.Name):
            return [("name", target.id)]
        if (isinstance(target, ast.Attribute) and isinstance(target.value, ast.Name)
                and target.value.id in ("self", "cls")):
            return [("attr", target.attr)]
        if isinstance(target, (ast.Tuple, ast.List)):
            return [k for e in target.elts for k in _ModuleFuncs._keys(e)]
        return []

    def _qualify(self, node, stack):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                self.qualnames[id(child)] = ".".join([*stack, child.name])
                self._qualify(child, [*stack, child.name])
            else:
                self._qualify(child, stack)

    def resolve(self, expr):
        if isinstance(expr, ast.Name):
            return self.defs.get(expr.id)
        if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
                and expr.value.id in ("self", "cls")):
            return self.defs.get(expr.attr)
        return None

    def bound(self, expr) -> list:
        """The expressions a name or ``self`` attribute is bound to."""
        if isinstance(expr, ast.Name):
            return self.bindings.get(("name", expr.id), [])
        if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
                and expr.value.id in ("self", "cls")):
            return self.bindings.get(("attr", expr.attr), [])
        return []


class _Captured:
    """The captured set of a project: (module, def or lambda) pairs."""

    def __init__(self, project, profile):
        self.profile = profile
        self.funcs = {m.rel: _ModuleFuncs(m) for m in project.modules}
        # a partial scan still seeds from the whole tree: a capture in one
        # file reaches a step factory in another
        for path in iter_py_files(project.root, profile.roots):
            rel = path.relative_to(project.root).as_posix()
            if rel not in self.funcs and (mod := load_module(path, project.root)[0]):
                self.funcs[rel] = _ModuleFuncs(mod)
        self.factories = {}  # factory name -> (module rel, def)
        for rel, name in profile.step_factories:
            fn = self.funcs.get(rel)
            node = fn.defs.get(name) if fn else None
            if node is not None:
                self.factories[name] = (rel, node)
        self.seeds: list = []
        for rel, funcs in self.funcs.items():
            self._seed_module(rel, funcs)

    def _add(self, rel, node):
        self.seeds.append((rel, node))

    def _seed_factory(self, rel, funcs, call: ast.Call, depth: int):
        """A factory's call: every def nested in it is captured, in its own
        module; composed wrappers seed the factories in their arguments."""
        factory = funcs.resolve(call.func)
        if factory is not None:
            for inner in _nested_defs(factory):
                self._add(rel, inner)
        elif terminal_name(call.func) in self.factories:
            frel, fnode = self.factories[terminal_name(call.func)]
            for inner in _nested_defs(fnode):
                self._add(frel, inner)
        for a in [*call.args, *(k.value for k in call.keywords)]:
            self.from_callee(rel, funcs, a, depth + 1)

    def from_callee(self, rel, funcs, expr, depth=0):
        """Seed from an expression that a captured function calls, or that
        names the captured function: a def, a lambda, a factory's call, or
        a name or ``self`` attribute bound to one of those (through
        subscripts and dict or list comprehensions)."""
        if depth > 6 or expr is None:
            return
        if isinstance(expr, ast.Lambda):
            self._add(rel, expr)
        elif isinstance(expr, ast.Call):
            self._seed_factory(rel, funcs, expr, depth)
        elif isinstance(expr, ast.Subscript):
            self.from_callee(rel, funcs, expr.value, depth + 1)
        elif isinstance(expr, ast.DictComp):
            self.from_callee(rel, funcs, expr.value, depth + 1)
        elif isinstance(expr, (ast.ListComp, ast.GeneratorExp)):
            self.from_callee(rel, funcs, expr.elt, depth + 1)
        elif isinstance(expr, ast.Dict):
            for v in expr.values:
                self.from_callee(rel, funcs, v, depth + 1)
        elif isinstance(expr, (ast.Name, ast.Attribute)):
            node = funcs.resolve(expr)
            if node is not None:
                self._add(rel, node)
            for value in funcs.bound(expr):
                self.from_callee(rel, funcs, value, depth + 1)

    def _built(self, funcs, build) -> list:
        """What a ``build`` callable returns: a lambda's body, or a def's
        return values."""
        if isinstance(build, ast.Lambda):
            return [build.body]
        node = funcs.resolve(build)
        if node is None:
            return []
        return [r.value for r in ast.walk(node) if isinstance(r, ast.Return) and r.value]

    def _seed_module(self, rel, funcs):
        calls = {name: (pos, kw) for name, pos, kw in self.profile.capture_calls}
        for call in [n for n in ast.walk(funcs.mod.tree) if isinstance(n, ast.Call)]:
            name = dotted(call.func)
            tail = terminal_name(call.func)
            if tail in calls:
                pos, kw = calls[tail]
                fn = call.args[pos] if len(call.args) > pos else next(
                    (k.value for k in call.keywords if k.arg == kw), None)
                self.from_callee(rel, funcs, fn)
            elif any(name == b or name.endswith("." + b) for b in self.profile.capture_build_calls):
                build = call.args[1] if len(call.args) > 1 else next(
                    (k.value for k in call.keywords if k.arg == "build"), None)
                for value in self._built(funcs, build):
                    if isinstance(value, ast.Tuple) and value.elts:
                        self.from_callee(rel, funcs, value.elts[0])

    def closure(self):
        """-> {(rel, id(node)): (rel, node)}: the seeds and every function
        they reach through same-module calls or bound factories."""
        seen: dict = {}
        queue = list(self.seeds)
        while queue:
            rel, fn = queue.pop()
            if (rel, id(fn)) in seen:
                continue
            seen[(rel, id(fn))] = (rel, fn)
            funcs = self.funcs[rel]
            before = len(self.seeds)
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and _impurity(node, ()) is None:
                    callee = funcs.resolve(node.func)
                    if callee is not None:
                        queue.append((rel, callee))
                    elif funcs.bound(node.func) or isinstance(node.func, ast.Subscript):
                        self.from_callee(rel, funcs, node.func)
            queue.extend(self.seeds[before:])
        return seen

    def qualname(self, rel, node) -> str:
        if isinstance(node, ast.Lambda):
            return "<lambda>"
        return self.funcs[rel].qualnames.get(id(node), node.name)


def captured(project, profile=PORT) -> set:
    """{(file, qualname)} of every captured function (lambdas as
    ``<lambda>``) in ``project``."""
    cap = _Captured(project, profile)
    return {(rel, cap.qualname(rel, node)) for rel, node in cap.closure().values()}


def _env_module_aliases(tree) -> set:
    """Local names of the env tier: the module ('env', 'env_util') and any
    accessor imported from it by name."""
    out = {"env"}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module.endswith("utils") or node.module.endswith("utils.env")):
            for a in node.names:
                if a.name == "env" or node.module.endswith(".env"):
                    out.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            out.update(a.asname for a in node.names
                       if a.asname and a.name.endswith("utils.env"))
    return out


def check(project, profile=PORT) -> list:
    cap = _Captured(project, profile)
    env_modules = {m.rel: _env_module_aliases(m.tree) for m in project.modules}
    findings = {}
    for rel, fn in cap.closure().values():
        if rel not in env_modules:  # a module outside a partial scan
            continue
        scope = cap.qualname(rel, fn)
        hits = list(_implicit_syncs(fn))
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and (why := _impurity(node, env_modules[rel])):
                hits.append((node, dotted(node.func) or terminal_name(node.func), why))
            elif why := _impure_subscript(node):
                hits.append((node, "os.environ", why))
        for node, name, why in hits:
            findings[(rel, node.lineno, name)] = Finding(
                CHECKER, rel, node.lineno, name,
                f"{name} inside a captured function: {why}", scope)
    return list(findings.values())
