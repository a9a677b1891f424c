"""A tiny cell of the program's hermetic tiny family, for rehearsals of the
harness on the CPU: the configuration and traffic beside this file, the
benchmark's own metric readers, a root laid out as a checkout's."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent

E2E = [("served_fps", "frames/s"), ("frame_ms_p95", "ms"), ("session_fps_min", "frames/s"),
       ("setup_s", "s")]
PER_LAYER = [("submit_ms_p50", "ms", "host_clock"),
             ("slots_filled", "frames/step", "program_counter"),
             ("window_wait_ms_p50", "ms", "program_counter"),
             ("launches_per_step", "kernels/step", "device_trace"),
             ("busy_ms_per_step", "ms", "device_trace"), ("mfu", "%", "host_clock"),
             ("pointwise_ms_per_step", "ms", "device_trace"),
             ("attention_roofline", "%", "device_trace"),
             ("device_idle_share", "%", "device_trace")]
DEVICE_METRICS = {"launches_per_step", "busy_ms_per_step", "mfu", "pointwise_ms_per_step",
                  "attention_roofline", "device_idle_share"}
WORKLOAD = "tiny-ring.tiny2"


def config(**limits) -> dict:
    cfg = json.loads((HERE / "tiny-ring.json").read_text())
    cfg["limits"].update(limits)
    return cfg


def traffic(**over) -> dict:
    t = json.loads((HERE / "tiny2.json").read_text())
    t.update(over)
    return t


def metrics(trace: bool) -> list:
    if trace:
        return [{"name": n, "unit": u} for n, u, _ in PER_LAYER]
    return [{"name": n, "unit": u} for n, u in E2E]


def checkout(root: Path, cfg: dict | None = None, seconds_traffic: dict | None = None) -> Path:
    """A checkout-shaped root holding BENCHMARK.json with the tiny cell, its
    configuration and traffic files, the metric readers and the family
    modules (reference/)."""
    for sub in ("configs", "traffic"):
        (root / "benchmark" / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "reference"):
        shutil.copytree(BENCH / sub, root / "benchmark" / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (root / "benchmark" / "configs" / "tiny-ring.json").write_text(json.dumps(cfg or config()))
    (root / "benchmark" / "traffic" / "tiny2.json").write_text(
        json.dumps(seconds_traffic or traffic()))
    bench = {
        "command": ["python3", "-m", "benchmark.run"], "paths": ["benchmark"], "run_seconds": 2,
        "configs": [{"name": "tiny-ring", "source": "tiny",
                     "file": "benchmark/configs/tiny-ring.json",
                     "reduced": [], "why": "tiny"}],
        "workloads": [{"name": WORKLOAD, "config": "tiny-ring", "traffic": "tiny2", "chips": 1,
                       "why": "tiny"}],
        "end_to_end": [{"name": n, "unit": u, "better": "higher", "bound": 0.25,
                        "source": "host_clock"} for n, u in E2E],
        "per_layer": [{"name": n, "unit": u, "better": "higher", "source": s, "layer": "x",
                       "moves": "served_fps"} for n, u, s in PER_LAYER],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
