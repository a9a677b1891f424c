"""The port's two device rules (ai_rtc_agent_tpu_torch/analysis/), on the CPU.

* ``device-transfer`` (analysis/device_transfers.py): each sub-rule on
  sources written inline, a case that fires and a case that does not (a
  blessed scope, an exempt tier, a dtype-only ``.to()``, parameter
  placement), and its suppressions.
* ``capture-purity`` (analysis/trace_purity.py): a copy of ``make_step_fn``
  with one impurity of each kind planted in ``step``, the same calls in an
  uncaptured function, device RNG with a generator, the seeds (a capture
  call, a graph cache's build, factories across modules), suppressions; over
  the real tree, the captured set holds ``stream/engine.py``'s two ``step``
  defs and a planted impurity in either fires.
* Every call that JAX's ``trace-purity`` flags in its fixture, the port's
  classifier flags too.
"""

import ast
import re
import shutil
from pathlib import Path

import pytest

from ai_rtc_agent_tpu.analysis import trace_purity as J_TP
from ai_rtc_agent_tpu_torch.analysis import core as P_CORE
from ai_rtc_agent_tpu_torch.analysis import trace_purity as P_TP

REPO = Path(__file__).resolve().parents[1]
PKG = "ai_rtc_agent_tpu_torch/"
ENGINE = PKG + "stream/engine.py"
MULTIPEER = PKG + "parallel/multipeer.py"


def _tree(root: Path, files: dict) -> Path:
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return root


def _scan(root: Path, rules) -> list:
    project, errs = P_CORE.load_project(root)
    assert not errs
    return P_CORE.run_checkers(project, rules)


def _line(text: str, marker: str) -> int:
    (n,) = [i for i, ln in enumerate(text.splitlines(), 1) if marker in ln]
    return n


# -- device-transfer ----------------------------------------------------------------------

TRANSFERS = '''\
import numpy as np
import torch


def h2d(frame, dev, buf):
    a = torch.from_numpy(frame).to(dev)  # H2D-1
    b = torch.from_numpy(frame).cuda()  # H2D-2
    c = torch.from_numpy(frame).pin_memory().to(dev, non_blocking=True)  # H2D-3
    t = torch.from_numpy(np.ascontiguousarray(frame))
    d = t.reshape(-1).to(device=dev)  # H2D-4
    e = torch.as_tensor(np.zeros(3), device=dev)  # H2D-5
    buf.copy_(t)  # H2D-6
    return a, b, c, d, e


def h2d_clean(params, x, dev, frame):
    w = params["w"].to(dev)  # a parameter's placement
    y = x.to(torch.float32)  # dtype only
    z = torch.from_numpy(frame).to(x.dtype)  # dtype only, still on the host
    s = torch.as_tensor(1.5, device=dev)  # a scalar, no host array
    return w, y, z, s


def d2h(x):
    return (x.cpu(),  # D2H-1
            x.numpy(),  # D2H-2
            x.sum().item(),  # D2H-3
            x.tolist(),  # D2H-4
            x.to("cpu"))  # D2H-5


def d2h_clean(frame):
    arr = np.asarray(frame)
    return arr.tolist(), np.zeros(2).item(), torch.from_numpy(arr).numpy()


def async_d2h(out):
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)  # ASYNC-1
    return host, out.to("cpu", non_blocking=True)  # ASYNC-2


def async_clean(out, dev_buf):
    dev_buf.copy_(out, non_blocking=True)  # device to device
    return dev_buf


class Engine:
    def drain(self, step, frames, v, dev):
        out = step.run()
        a = out.cpu()  # DRAIN-1
        b = np.asarray(out[0])  # DRAIN-2
        c = self._steps[v](None, None, frames).numpy()  # DRAIN-3
        staged = stage_rows(frames, dev)
        d = np.array(staged)  # DRAIN-4
        e = self.step_for(None, None, 1).run().cpu()  # DRAIN-5
        return a, b, c, d, e

    def drain_clean(self, frames):
        rows = np.asarray(frames)  # a host array
        out = np.asarray(rows[0])
        return out


def stage_rows(frames, dev):
    return torch.from_numpy(frames).to(dev)
'''

SUB_RULES = {"H2D": "stray H2D", "D2H": "stray D2H", "ASYNC": "stray async D2H",
             "DRAIN": "whole-batch host drain"}


def test_device_transfer_sub_rules(tmp_path):
    fs = _scan(_tree(tmp_path, {PKG + "mod.py": TRANSFERS}), ("device-transfer",))
    got = {f.line: f for f in fs}
    lines = TRANSFERS.splitlines()
    want = {i: re.search(r"# (H2D|D2H|ASYNC|DRAIN)-\d", ln).group(1)
            for i, ln in enumerate(lines, 1) if re.search(r"# (H2D|D2H|ASYNC|DRAIN)-\d", ln)}
    # the module's own stage_rows is no blessed scope here (only stream/engine's
    # and parallel/multipeer's are): its upload is a finding too
    want[_line(TRANSFERS, "return torch.from_numpy(frames).to(dev)")] = "H2D"
    assert sorted(got) == sorted(want), [(f.line, f.message) for f in fs]
    for line, kind in want.items():
        assert got[line].message.startswith(SUB_RULES[kind]), (line, got[line].message)
    assert len(want) == 19


def test_blessed_scopes_and_exempt_tiers(tmp_path):
    # the staging and readback helpers at their own paths and qualnames
    helpers = {
        ENGINE: "import numpy as np\nimport torch\n\n\n"
                "def stage_into(buf, frames):\n"
                "    t = torch.from_numpy(np.ascontiguousarray(frames)).pin_memory()\n"
                "    return buf.copy_(t, non_blocking=True)\n\n\n"
                "class _Readback:\n"
                "    def __init__(self, out):\n"
                "        self.host = torch.empty(out.shape, pin_memory=True)\n"
                "        self.host.copy_(out, non_blocking=True)\n\n"
                "    def result(self):\n"
                "        return self.host.numpy()\n",
        MULTIPEER: "import torch\n\n\n"
                   "class Readback:\n"
                   "    def __init__(self, out, n):\n"
                   "        self.host = [torch.empty(out.shape[1:], pin_memory=True) for _ in "
                   "range(n)]\n"
                   "        for i, h in enumerate(self.host):\n"
                   "            h.copy_(out[i], non_blocking=True)\n\n"
                   "    def row(self, i):\n"
                   "        return self.host[i].numpy()\n",
    }
    root = _tree(tmp_path / "helpers", helpers)
    assert _scan(root, ("device-transfer",)) == []
    # the same readback under another name is no helper: its crossings are findings
    stray = helpers[ENGINE].replace("class _Readback", "class Other")
    assert [f.line for f in _scan(_tree(tmp_path / "stray", {ENGINE: stray}),
                                  ("device-transfer",))] == [13, 16]
    # every exempt tier takes the whole bad module; the port's profile lists them
    exempt = P_CORE.PORT.transfer_exempt
    assert {PKG + "aot/cache.py", PKG + "models/loader.py", PKG + "bridge.py"} <= set(exempt)
    root = _tree(tmp_path / "exempt", {rel: TRANSFERS for rel in exempt})
    assert _scan(root, ("device-transfer",)) == []
    assert P_CORE.PORT.tooling("chip_smoke.py") and P_CORE.PORT.tooling("scripts/x.py")


def test_device_transfer_suppressions(tmp_path):
    src = ("import torch\n\n\ndef f(x, out):\n"
           "    # tpurtc: allow[device-transfer] -- a reasoned allow\n"
           "    a = x.cpu()\n"
           "    b = out.item()  # tpurtc: allow[device-transfer]\n"
           "    # tpurtc: allow[device-transfer] -- nothing crosses on the next line\n"
           "    return a, b\n")
    fs = _scan(_tree(tmp_path, {PKG + "mod.py": src}), ("device-transfer",))
    assert sorted((f.checker, f.line) for f in fs) == [
        ("device-transfer", 7), ("suppression", 7), ("suppression", 8)]


# -- capture-purity -----------------------------------------------------------------------

# a copy of stream/engine.make_step_fn's shape: a factory whose nested step a
# graph cache's build captures through ``self._steps``
STEP_MODULE = '''\
import os
import random
import subprocess
import time

import numpy as np
import torch

from ..utils import env


def unet_runner(models):
    def run(params, x):
        return models.unet(params, x)

    return run


def make_step_fn(models, cfg):
    run = unet_runner(models)

    def step(params, state, frame_u8):
        x = frame_u8.float()
        # PLANT
        return state, run(params, x)

    return step


def plain(params, state, frame_u8):
    x = frame_u8.float()
    # PLANT
    return state, x


class StreamEngine:
    def __init__(self, models, cfg):
        self._steps = {v: make_step_fn(models, cfg) for v in ("full",)}

    def capture(self, key, v):
        return self.graph_cache.get(key, lambda v=v: (
            lambda inputs: self._steps[v](self.params, self.state, inputs["frame"])[1],
            {"frame": None}))
'''

IMPURITIES = {
    "item": "s = x.sum().item()",
    "tolist": "s = x.tolist()",
    "cpu": "s = x.cpu()",
    "numpy": "s = x.numpy()",
    "to-cpu": 's = x.to("cpu")',
    "sync": "torch.cuda.synchronize()",
    "from-numpy": "s = torch.from_numpy(np.zeros(3))",
    "tensor-of-host": "s = torch.tensor([1.0, 2.0], device=x.device)",
    "environ": 's = os.environ["GUIDANCE"]',
    "getenv": 's = os.getenv("GUIDANCE")',
    "env-accessor": 's = env.get_float("GUIDANCE", 1.0)',
    "env-named-accessor": "s = env.attn_impl()",
    "truth-value": "s = 1 if x.any() else 0",
    "assert-on-tensor": "assert not torch.isnan(x).any()",
    "cast": "s = float(x.sum())",
    "clock": "s = time.perf_counter()",
    "sleep": "time.sleep(0.001)",
    "np-random": "s = np.random.rand()",
    "random": "s = random.random()",
    "open": 's = open("/dev/null")',
    "print": "print(x)",
    "subprocess": 'subprocess.run(["true"])',
}


def _plant(src: str, stmt: str, where: str) -> str:
    """``stmt`` in place of the ``# PLANT`` marker of ``where`` (``step`` or
    ``plain``)."""
    head, tail = src.split(f"def {where}(", 1)
    return head + f"def {where}(" + tail.replace("# PLANT", stmt, 1)


@pytest.mark.parametrize("kind", sorted(IMPURITIES))
def test_an_impurity_in_a_captured_step_fires(tmp_path, kind):
    stmt = IMPURITIES[kind]
    src = _plant(STEP_MODULE, stmt, "step")
    fs = _scan(_tree(tmp_path / "captured", {ENGINE: src}), ("capture-purity",))
    assert [(f.line, f.scope) for f in fs] == [(_line(src, stmt), "make_step_fn.step")]
    # the same call in a function no capture reaches is no finding
    src = _plant(STEP_MODULE, stmt, "plain")
    assert _scan(_tree(tmp_path / "plain", {ENGINE: src}), ("capture-purity",)) == []


def test_host_values_of_a_tensor_are_no_sync(tmp_path):
    src = _plant(STEP_MODULE, "n = int(x.shape[0]) + int(x.size(0)) + int(x.ndim)\n"
                 "        s = x if state is not None else None\n"
                 "        b = bool(len(x.shape)) and float(0.5) > 0", "step")
    assert _scan(_tree(tmp_path, {ENGINE: src}), ("capture-purity",)) == []


def test_device_rng_with_a_generator_is_pure(tmp_path):
    src = _plant(STEP_MODULE, "g = torch.Generator(device=x.device).manual_seed(0)\n"
                 "        s = torch.randn(x.shape, generator=g, device=x.device)", "step")
    assert _scan(_tree(tmp_path, {ENGINE: src}), ("capture-purity",)) == []


def test_capture_seeds(tmp_path):
    # CapturedStep(key, fn, inputs) captures fn, and the closure follows
    # same-module calls to where the impurity lies
    direct = ("import time\n\n\ndef _helper(x):\n    time.sleep(0.001)\n    return x\n\n\n"
              "def fn(inputs):\n    return _helper(inputs['x'])\n\n\n"
              "def build(CapturedStep):\n    return CapturedStep('k', fn, {'x': None})\n")
    fs = _scan(_tree(tmp_path / "direct", {PKG + "m.py": direct}), ("capture-purity",))
    assert [(f.line, f.scope) for f in fs] == [(5, "_helper")]
    # a build def returning (fn, inputs) to a graph cache, through a name bound
    # to an imported step factory: the factory's nested defs in their own module
    engine = _plant(STEP_MODULE, "s = x.item()", "step").replace(
        "def make_step_fn(", "def make_session_step_fn(").replace(
        "self._steps = {v: make_step_fn(models, cfg)", "self._unused = {v: None")
    multipeer = ("from ..stream.engine import make_session_step_fn\n\n\n"
                 "class BucketStep:\n"
                 "    def __init__(self, models, cfg):\n"
                 "        self._steps = {v: make_session_step_fn(models, cfg) for v in ('a',)}\n\n"
                 "    def step_for(self, params, states, k, variant):\n"
                 "        fn = self._steps[variant]\n\n"
                 "        def build():\n"
                 "            inputs = {'frames': None}\n"
                 "            return (lambda b: fn(params, states, b['frames']), inputs)\n\n"
                 "        return self.graph_cache.get(k, build)\n")
    root = _tree(tmp_path / "cross", {ENGINE: engine, MULTIPEER: multipeer})
    fs = _scan(root, ("capture-purity",))
    assert [(f.path, f.line, f.scope) for f in fs] == [
        (ENGINE, _line(engine, "x.item()"), "make_session_step_fn.step")]
    # a partial scan of either file agrees with the full scan there
    for rel, want in ((ENGINE, fs), (MULTIPEER, [])):
        project, _ = P_CORE.load_project(root, files=[root / rel])
        assert P_CORE.run_checkers(project, ("capture-purity",)) == want
    # without the capture in the other module nothing reaches the factory
    (root / MULTIPEER).write_text(multipeer.replace("self.graph_cache.get(k, build)", "build"))
    assert _scan(root, ("capture-purity",)) == []


def test_capture_purity_suppressions(tmp_path):
    src = _plant(STEP_MODULE, "# tpurtc: allow[capture-purity] -- a reasoned allow\n"
                 "        s = time.perf_counter()\n"
                 "        t = x.item()  # tpurtc: allow[capture-purity]", "step")
    fs = _scan(_tree(tmp_path, {ENGINE: src}), ("capture-purity",))
    line = _line(src, "x.item()")
    assert sorted((f.checker, f.line) for f in fs) == [("capture-purity", line),
                                                      ("suppression", line)]


# -- the real tree ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_project():
    project, errs = P_CORE.load_project(REPO)
    assert not errs
    return project


def test_the_captured_set_holds_the_engine_steps(port_project):
    got = P_TP.captured(port_project)
    assert {(ENGINE, "make_step_fn.step"), (ENGINE, "make_session_step_fn.step")} <= got
    assert (ENGINE, "StreamEngine.submit") not in got


def _real(tmp_path) -> Path:
    for rel in (ENGINE, MULTIPEER):
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / rel, dst)
    return tmp_path


def _insert_first(src: str, qualname: str, stmt: str) -> tuple:
    """``stmt`` as the first statement of the def ``qualname`` (its
    docstring kept first) -> (new source, its line)."""
    tree = ast.parse(src)
    node = tree
    for part in qualname.split("."):
        node = next(n for n in ast.walk(node) if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and n.name == part
            and n is not node)
    body = node.body
    first = body[1] if (isinstance(body[0], ast.Expr)
                        and isinstance(body[0].value, ast.Constant)) else body[0]
    lines = src.splitlines(keepends=True)
    indent = lines[first.lineno - 1][:first.col_offset]
    lines.insert(first.lineno - 1, indent + stmt + "\n")
    return "".join(lines), first.lineno


REAL_PLANTS = {
    "item": "_planted = frame_u8.float().sum().item()",
    "environ": '_planted = os.environ["GUIDANCE"]',
    "clock": "_planted = time.perf_counter()",
    "from-numpy": "_planted = torch.from_numpy(np.zeros(3))",
    "env-named-accessor": "_planted = env.attn_impl()",
    "cast": "_planted = float(frame_u8.float().sum())",
}


@pytest.mark.parametrize("step", ["make_step_fn.step", "make_session_step_fn.step"])
@pytest.mark.parametrize("kind", sorted(REAL_PLANTS))
def test_an_impurity_planted_in_the_real_steps_fires(tmp_path, step, kind):
    root = _real(tmp_path)
    src = (root / ENGINE).read_text()
    src, line = _insert_first(src, step, REAL_PLANTS[kind])
    (root / ENGINE).write_text(src)
    fs = _scan(root, ("capture-purity",))
    assert [(f.path, f.line) for f in fs] == [(ENGINE, line)], [f.render() for f in fs]


def test_a_drained_step_output_in_the_real_engine_fires(tmp_path):
    root = _real(tmp_path)
    assert _scan(root, ("device-transfer",)) == []
    src = (root / ENGINE).read_text()
    anchor = '            self._last_submitted = (_Readback(step.run()), squeeze)\n'
    assert src.count(anchor) == 1
    src = src.replace(anchor, anchor + "            _drained = step.run().cpu()\n")
    (root / ENGINE).write_text(src)
    fs = _scan(root, ("device-transfer",))
    assert [(f.line, f.scope, f.message.split(":")[0]) for f in fs] == [
        (_line(src, "_drained = step.run().cpu()"), "StreamEngine.submit",
         "whole-batch host drain of a step output outside the readback helpers")]


def test_the_port_classifier_flags_every_jax_impurity_of_its_fixture():
    path = REPO / "tests" / "fixtures" / "static_analysis" / "trace_purity_bad.py"
    tree = ast.parse(path.read_text())
    env_modules = J_TP._env_module_aliases(tree)
    flagged = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
               and J_TP._impurity(c, env_modules)]
    assert len(flagged) == 4
    for call in flagged:
        assert P_TP._impurity(call, env_modules), ast.unparse(call)
    # and the port passes what JAX passes: jax.random and plain arithmetic
    passed = [c for c in ast.walk(tree) if isinstance(c, ast.Call)
              and not J_TP._impurity(c, env_modules)]
    assert passed and not any(P_TP._impurity(c, env_modules) for c in passed)
