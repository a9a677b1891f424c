"""On the card: the harness's kernel classes against the port's real
kernels.  One bucket step of the sd-turbo cell's program, traced, must
show the flash-attention kernel by name at 32 launches a UNet pass and the
epilogue once (the step marker), and pointwise kernels beside them, so
that attention_roofline and pointwise_ms_per_step cannot silently read
zero.  Run on the card: ``python -m pytest benchmark/tests -q -m gpu``."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness
from benchmark import trace as TR
from benchmark.reference import params as P

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.gpu
def test_kernel_classes_find_the_port_kernels(card):
    import torch

    cfg = json.loads((BENCH / "configs" / "sd-turbo-512.json").read_text())
    sched = harness.build(cfg, P.make_tree(cfg, 3, card), 1, card)
    try:
        sess = sched.claim("card-test", prompt="a test", seed=5)
        frame = np.zeros((512, 512, 3), np.uint8)
        for _ in range(3):
            sess(frame)
        torch.cuda.synchronize()
        prof = TR.Profiler()
        prof.start()
        time.sleep(0.6)
        steps = 4
        for _ in range(steps):
            sess(frame)
        torch.cuda.synchronize()
        time.sleep(0.6)
        prof.stop()
        records = prof.records()
    finally:
        harness.release(sched)
    counts: dict = {}
    for name, _, _ in records:
        cls = TR.classify(name)
        counts[cls] = counts.get(cls, 0) + 1
    assert counts.get("flash_attention") == 32 * steps
    assert counts.get(TR.STEP_MARKER) == steps
    assert all(counts.get(c, 0) > 0 for c in TR.POINTWISE)
    assert counts.get("other", 0) < 0.01 * len(records)
