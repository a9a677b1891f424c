"""The yardstick's numbers: each configuration's FLOPs a frame, recounted
over the plain reference on the meta device; the attention bound of an
sd-turbo UNet pass (0.1412 ms, PERF.md's kernel table); the trace
reduction's arithmetic."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import roofline as RF
from benchmark import trace as TR

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = sorted((BENCH / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_flops_per_frame_recounted(path):
    cfg = json.loads(path.read_text())
    assert cfg["flops_per_frame"] == RF.frame_flops(cfg)


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_attention_launches_per_pass(path):
    cfg = json.loads(path.read_text())
    assert len(RF.attention_shapes(cfg, 1)) == 32


def test_sd_turbo_attention_bound():
    cfg = json.loads((BENCH / "configs" / "sd-turbo-512.json").read_text())
    assert round(RF.attention_bound_s(cfg, 1) * 1e3, 4) == 0.1412
    ring = json.loads((BENCH / "configs" / "sd15-lcm-ring-512.json").read_text())
    assert round(RF.attention_bound_s(ring, 16) * 1e3, 3) == 2.259  # 12e at B=16


def test_trace_reduction():
    s = TR.SETTLE_US
    recs = [("kernel_warmup", 0.0, 10.0)]
    for k in range(4):  # four steps of 100 us: attention 40, elementwise 40, epilogue 10, idle 10
        b = s + 1000.0 + 100.0 * k
        recs += [("flash_attention_kernel<x>", b, b + 40),
                 ("vectorized_elementwise_kernel", b + 40, b + 80),
                 ("fused_stream_epilogue_kernel", b + 80, b + 90)]
    recs.append(("tail", s + 3000.0, 2 * s + 3000.0 + 10.0))
    tr = TR.reduce(recs)
    assert tr["steps"] == 4 and tr["launches"] == 13  # the tail starts inside the span
    assert tr["by_class_us"]["flash_attention"] == 160.0
    assert abs(tr["window_us"] - 3010.0) < 1e-6
    assert abs(tr["busy_us"] - 370.0) < 1e-6  # 4 x 90 us, and the tail's 10 inside
    assert tr["gaps"][0] == (1610.0, "fused_stream_epilogue", "other")
    assert tr["gaps"][1] == (1000.0, "window start", "flash_attention")
    bd = TR.breakdown(tr)
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert TR.reduce([]) is None
