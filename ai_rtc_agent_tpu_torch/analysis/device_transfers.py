"""Checker: frames cross between the host and the card only through the
staging and readback helpers — counterpart of the JAX package's
``device-transfer`` rule, rewritten for torch.

The port's frame path has one H2D discipline and one D2H discipline, each
held by a few helpers (the profile's ``transfer_blessed`` scopes): host
frames go to the card through ``stream/engine.stage_into`` and
``parallel/multipeer.stage_rows`` (pinned memory, ``non_blocking``, metered
by obs/devtel.py), and a step's output comes back through ``_Readback`` /
``Readback`` / ``ShardedReadback``: pinned buffers per row, queued right
after the step on its stream, one event.  A crossing anywhere else is
unmetered, and a ``.cpu()`` of a whole step output is the bug class the
JAX rule was written for: every session's fetch billing all the others.
Four sub-rules:

* **stray-h2d** — a host array made a tensor and sent to a device outside
  the staging helpers: ``torch.from_numpy(x).to(dev)`` / ``.cuda()`` /
  ``.pin_memory().to(...)``, a ``copy_`` from such a tensor, or
  ``torch.as_tensor`` / ``torch.tensor`` of a numpy value with a
  ``device=``.  Decided by taint from a host array (same function,
  statement order): a dtype-only ``.to()``, and any ``.to()`` of a tensor
  not known to live on the host (parameters, device buffers), stay clean.
* **stray-d2h** — ``.cpu()``, ``.numpy()``, ``.item()``, ``.tolist()`` or
  ``.to("cpu")`` outside the readback helpers (numpy's own ``.item()`` /
  ``.tolist()`` of a value tainted as a numpy array stay clean).
* **stray-async-d2h** — ``.to("cpu", non_blocking=True)``, or
  ``.copy_(..., non_blocking=True)`` into host memory (a pinned or
  ``device="cpu"`` tensor, or a name whose words say ``host``/``pinned``),
  outside the readback helpers.
* **batch-drain** — ``.cpu()``, ``.numpy()``, ``np.asarray`` or ``np.array``
  of a value tainted as a step output (subscripts included): the result of
  a captured step's ``.run()`` (``step.run()``, ``step_for(...).run()``,
  ``CapturedStep(...).run()``), of a call of a step attribute
  (``self._steps[v](...)``, ``self._step(...)``), or of a staging call
  (``stage_rows(...)`` / ``stage_into(...)``).

Blessed scopes (file, qualname; a class blesses its methods, a function its
nested defs) and the exempt tiers (export, mesh layout, training, weight
load, and ``Profile.tooling``) come from the profile.  Every other site is
triaged: fixed, or suppressed inline with a reason.
"""

from __future__ import annotations

import ast

from .core import PORT, Finding, ScopedVisitor, dotted, terminal_name

CHECKER = "device-transfer"

_D2H_METHODS = {"cpu", "numpy", "item", "tolist"}
_NUMPY_ROOTS = ("np", "numpy")
_HOST_CAST = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}
_TENSOR_FROM = {"torch.as_tensor", "torch.tensor", "torch.asarray"}
_PINNABLE = {"torch.empty", "torch.zeros", "torch.ones", "torch.full", "torch.empty_like",
             "torch.zeros_like", "torch.ones_like", "torch.full_like", "torch.empty_strided"}
_DTYPES = {
    "float", "float16", "float32", "float64", "bfloat16", "half", "double", "int8", "int16",
    "int32", "int64", "uint8", "bool", "long", "int", "short", "complex64", "complex128",
    "float8_e4m3fn", "float8_e5m2",
}


def _words(expr) -> set:
    return set(terminal_name(expr).lower().strip("_").split("_"))


def _kw(call: ast.Call, name: str):
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _is_cpu(expr) -> bool:
    if isinstance(expr, ast.Constant):
        return expr.value == "cpu"
    return (isinstance(expr, ast.Call) and dotted(expr.func) == "torch.device" and bool(expr.args)
            and _is_cpu(expr.args[0]))


def _is_true(expr) -> bool:
    return isinstance(expr, ast.Constant) and expr.value is True


def _dtype_like(expr) -> bool:
    """A ``.to()`` argument that names a dtype (``torch.float32``,
    ``x.dtype``, ``dtype``, ``dt``), not a device."""
    name = dotted(expr)
    if not name:
        return False
    tail = name.split(".")[-1]
    if name.startswith("torch.") and tail in _DTYPES:
        return True
    return bool({"dtype", "dt"} & set(tail.lower().strip("_").split("_")))


def _to_target(call: ast.Call):
    """Where a ``.to(...)`` call sends its tensor: ``"cpu"``, ``"device"``
    (any other device, or a tensor whose device it takes) or ``None``
    (a dtype-only cast, or no argument)."""
    dev = _kw(call, "device")
    if dev is None and call.args and not _dtype_like(call.args[0]):
        dev = call.args[0]
    if dev is None or (isinstance(dev, ast.Constant) and dev.value is None):
        return None
    return "cpu" if _is_cpu(dev) else "device"


def _blessed(scope: str, blessed) -> bool:
    return any(scope == q or scope.startswith(q + ".") for q in blessed)


class _Visitor(ScopedVisitor):
    def __init__(self, mod, blessed, profile):
        super().__init__()
        self.mod = mod
        self.blessed = blessed
        self.staging = set(profile.staging_calls)
        self.step_attrs = set(profile.step_attrs)
        self.step_getters = {*profile.step_getters, *profile.capture_build_calls,
                             *(name for name, _, _ in profile.capture_calls)}
        self.findings = []
        # per-function taint, statement order: name -> "np" (a numpy array),
        # "host" (a host tensor), "step" (a captured step) or "device" (a
        # step's output or a staged frame)
        self._taint_stack = [{}]

    def _in_function(self, node):
        self._taint_stack.append({})
        self._in_named(node)
        self._taint_stack.pop()

    visit_FunctionDef = _in_function
    visit_AsyncFunctionDef = _in_function

    @property
    def _taint(self) -> dict:
        return self._taint_stack[-1]

    def _flag(self, node, name, message):
        self.findings.append(Finding(CHECKER, self.mod.rel, node.lineno, name, message,
                                     self.scope))

    # -- what a value is --------------------------------------------------------

    def _np(self, expr) -> bool:
        """A host numpy value: an ``np.*`` call, a name bound to one, a
        method result or a subscript of one."""
        if isinstance(expr, ast.Name):
            return self._taint.get(expr.id) == "np"
        if isinstance(expr, ast.Subscript):
            return self._np(expr.value)
        if isinstance(expr, ast.Call):
            if dotted(expr.func).split(".")[0] in _NUMPY_ROOTS:
                return True
            if isinstance(expr.func, ast.Attribute) and expr.func.attr not in _D2H_METHODS:
                return self._np(expr.func.value)
        return False

    def _host(self, expr) -> bool:
        """A tensor in host memory: ``torch.from_numpy``, a tensor made from
        a numpy value with no device, a pinned or ``device="cpu"``
        allocation, ``.pin_memory()`` / ``.cpu()`` / ``.to("cpu")``, a name
        bound to one, or a view or dtype cast of one."""
        if isinstance(expr, ast.Name):
            return self._taint.get(expr.id) == "host"
        if isinstance(expr, ast.Subscript):
            return self._host(expr.value)
        if not isinstance(expr, ast.Call):
            return False
        name = dotted(expr.func)
        if name == "torch.from_numpy":
            return True
        if name in _TENSOR_FROM:
            dev = _kw(expr, "device")
            return (dev is None or _is_cpu(dev)) and bool(expr.args) and self._np(expr.args[0])
        if name in _PINNABLE:
            return _is_true(_kw(expr, "pin_memory")) or _is_cpu(_kw(expr, "device"))
        if isinstance(expr.func, ast.Attribute):
            attr = expr.func.attr
            if attr in ("pin_memory", "cpu"):
                return True
            if attr == "cuda":
                return False
            if attr == "to":
                target = _to_target(expr)
                return target == "cpu" or (target is None and self._host(expr.func.value))
            return self._host(expr.func.value)
        return False

    def _step(self, expr) -> bool:
        """A captured step: a name bound to one, ``step_for(...)``, a
        graph-cache ``get``, a name whose words say ``step``, or an item of
        a call that returns steps (``self._static_steps_locked()[v]``)."""
        if isinstance(expr, ast.Name) and self._taint.get(expr.id) == "step":
            return True
        if isinstance(expr, (ast.Name, ast.Attribute)):
            return bool({"step", "steps"} & _words(expr))
        if isinstance(expr, ast.Subscript):
            inner = expr.value
            if isinstance(inner, ast.Call):
                inner = inner.func
            return self._step(inner)
        if isinstance(expr, ast.Call):
            name = dotted(expr.func)
            return (terminal_name(expr.func) in self.step_getters
                    or any(name == g or name.endswith("." + g) for g in self.step_getters))
        return False

    def _device_out(self, expr) -> bool:
        """A step's output or a staged frame (or a subscript, view or cast
        of one)."""
        if isinstance(expr, ast.Name):
            return self._taint.get(expr.id) == "device"
        if isinstance(expr, ast.Subscript):
            return self._device_out(expr.value)
        if not isinstance(expr, ast.Call):
            return False
        f = expr.func
        if terminal_name(f) in self.staging:
            return True
        if isinstance(f, ast.Attribute) and f.attr == "run" and self._step(f.value):
            return True
        # a call of a step attribute: self._step(...), self._steps[v](...)
        target = f.value if isinstance(f, ast.Subscript) else f
        if isinstance(target, ast.Attribute) and target.attr in self.step_attrs:
            return True
        if isinstance(f, ast.Attribute) and f.attr not in _D2H_METHODS and f.attr != "to":
            return self._device_out(f.value)
        return False

    def _host_dest(self, expr) -> bool:
        return self._host(expr) or bool({"host", "pinned"} & _words(
            expr.value if isinstance(expr, ast.Subscript) else expr))

    # -- taint ------------------------------------------------------------------

    @staticmethod
    def _target_names(targets) -> list:
        """Directly bound names only (``a``, ``a, b = ...``), never the base
        of an attribute or subscript target."""
        out = []
        for t in targets:
            if isinstance(t, ast.Name):
                out.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                out.extend(e.id for e in t.elts if isinstance(e, ast.Name))
        return out

    def _kind(self, value):
        if self._device_out(value):
            return "device"
        if self._host(value):
            return "host"
        if self._np(value):
            return "np"
        if self._step(value) and not isinstance(value, ast.Name):
            return "step"
        return None

    def _bind(self, targets, value):
        kind = self._kind(value) if value is not None else None
        for n in self._target_names(targets):
            if kind is None:
                self._taint.pop(n, None)  # a plain rebinding clears the taint
            else:
                self._taint[n] = kind

    def visit_Assign(self, node):
        self.generic_visit(node)
        self._bind(node.targets, node.value)

    def visit_AnnAssign(self, node):
        self.generic_visit(node)
        self._bind([node.target], node.value)

    # -- the four sub-rules -----------------------------------------------------

    def visit_Call(self, node):
        if not _blessed(self.scope, self.blessed):
            self._check(node)
        self.generic_visit(node)

    def _check(self, node: ast.Call):
        f = node.func
        name = dotted(f)
        if name in _HOST_CAST and node.args and self._device_out(node.args[0]):
            self._drain(node, name)
            return
        if name in _TENSOR_FROM:
            dev = _kw(node, "device")
            if (dev is not None and not _is_cpu(dev) and node.args
                    and (self._np(node.args[0]) or self._host(node.args[0]))):
                self._flag(node, name, f"stray H2D: {name} of a host array onto a device "
                           "outside the staging helpers; stage frames through "
                           "stream/engine.stage_into or parallel/multipeer.stage_rows")
            return
        if not isinstance(f, ast.Attribute):
            return
        attr, recv = f.attr, f.value
        if attr in ("cpu", "numpy") and self._device_out(recv):
            self._drain(node, name or attr)
        elif attr == "to":
            target = _to_target(node)
            if target == "device" and self._host(recv):
                self._flag(node, name or attr, "stray H2D: a host array's tensor sent to a "
                           "device outside the staging helpers; stage frames through "
                           "stream/engine.stage_into or parallel/multipeer.stage_rows")
            elif target == "cpu" and not self._host(recv):
                if _is_true(_kw(node, "non_blocking")):
                    self._async_d2h(node, name or attr)
                else:
                    self._d2h(node, name or attr, '.to("cpu")')
        elif attr == "cuda" and self._host(recv):
            self._flag(node, name or attr, "stray H2D: .cuda() of a host array's tensor "
                       "outside the staging helpers")
        elif attr == "copy_" and node.args:
            if self._host(node.args[0]) and not self._host_dest(recv):
                self._flag(node, name or attr, "stray H2D: copy_ from a host array's tensor "
                           "into a device buffer outside the staging helpers")
            elif _is_true(_kw(node, "non_blocking")) and self._host_dest(recv):
                self._async_d2h(node, name or attr)
        elif attr in _D2H_METHODS and not (self._np(recv) or self._host(recv)):
            self._d2h(node, name or attr, f".{attr}()")

    def _d2h(self, node, name, what):
        self._flag(node, name, f"stray D2H: {what} outside the readback helpers; read step "
                   "outputs back through the per-row readback (stream/engine._Readback, "
                   "parallel/multipeer.Readback)")

    def _async_d2h(self, node, name):
        self._flag(node, name, "stray async D2H: a non_blocking copy into host memory outside "
                   "the readback helpers, which queue it right after the step and own its event")

    def _drain(self, node, name):
        self._flag(node, name, "whole-batch host drain of a step output outside the readback "
                   "helpers: every session's fetch would pay for all of them; read rows "
                   "through the per-row readback")


def check(project, profile=PORT) -> list:
    blessed: dict = {}
    for rel, qual in profile.transfer_blessed:
        blessed.setdefault(rel, set()).add(qual)
    findings = []
    for mod in project.modules:
        if profile.tooling(mod.rel) or mod.rel in profile.transfer_exempt:
            continue
        v = _Visitor(mod, blessed.get(mod.rel, set()), profile)
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
