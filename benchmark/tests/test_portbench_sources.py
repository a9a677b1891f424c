"""What the benchmark runs imports: no module whose top-level name is jax,
jaxlib, flax or the JAX package (compared whole: the port's name begins
with the JAX package's), and a reference that imports nothing of the
program under test."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ai_rtc_agent_tpu"}
PROGRAM = "ai_rtc_agent_tpu_torch"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts) -> list:
    return sorted(p for p in BENCH.joinpath(*parts).rglob("*.py") if "tests" not in p.parts)


def test_no_jax_in_the_harness_or_the_reference():
    found = {str(p.relative_to(BENCH)): _imports(p) & FORBIDDEN for p in _sources()}
    assert not {p: n for p, n in found.items() if n}


def test_reference_imports_nothing_of_the_program():
    found = {str(p.relative_to(BENCH)): n for p in _sources("reference")
             if PROGRAM in (n := _imports(p))}
    assert not found
    # nor does anything they import: every module of reference/ (each family
    # module with it), loaded on its own
    mods = [".".join(p.relative_to(BENCH.parent).with_suffix("").parts).removesuffix(".__init__")
            for p in _sources("reference")]
    assert {"benchmark.reference.sd_unet", "benchmark.reference.stream"} <= set(mods)
    code = (f"import sys, importlib; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = {m.split('.')[0] for m in sys.modules} & set("
            f"{sorted(FORBIDDEN | {PROGRAM})!r}); "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=""), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_comparison_imports_nothing_of_the_program():
    for name in ("compare.py", "camera.py", "roofline.py", "trace.py", "readings.py",
                 "families.py"):
        assert PROGRAM not in _imports(BENCH / name), name
