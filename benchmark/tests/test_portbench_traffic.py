"""The traffic generator is a function of the seed: the same seed gives the
same prompts, noise seeds, phases and frames; another seed gives others of
the same kind; the seeds the driver uses (above 32 bits) are taken."""

from __future__ import annotations

import asyncio
import json
import time
from pathlib import Path

import numpy as np
import pytest

from benchmark import camera as CAM
from benchmark import compare

BENCH = Path(__file__).resolve().parents[1]
TRAFFIC = sorted((BENCH / "traffic").glob("*.json"))
SEEDS = [0, 7, 2**31 + 11, 2**33 + 5]


@pytest.mark.parametrize("path", TRAFFIC, ids=[p.stem for p in TRAFFIC])
@pytest.mark.parametrize("seed", SEEDS)
def test_plan_is_a_function_of_the_seed(path, seed):
    traffic = json.loads(path.read_text())
    a, b = CAM.session_plan(traffic, seed), CAM.session_plan(traffic, seed)
    assert a == b and len(a) == traffic["sessions"]
    assert len({p["prompt"] for p in a}) == len(a)
    assert all(0 <= p["noise_seed"] < 2**62 for p in a)
    assert all(0 <= p["phase"] < 1.0 / traffic["camera_fps"] for p in a)
    assert CAM.session_plan(traffic, seed + 1) != a


@pytest.mark.parametrize("path", TRAFFIC, ids=[p.stem for p in TRAFFIC])
def test_frames_are_a_function_of_the_seed(path):
    traffic = json.loads(path.read_text())
    plan = CAM.session_plan(traffic, 2**33 + 5)
    s1 = CAM.Scene(traffic, plan[0]["texture_seed"])
    s2 = CAM.Scene(traffic, plan[0]["texture_seed"])
    other = CAM.Scene(traffic, plan[1]["texture_seed"])
    size = traffic["frame_size"]
    for i in (0, 1, 45, 1000):
        f = s1.frame(i)
        assert f.shape == (size, size, 3) and f.dtype == np.uint8
        assert np.array_equal(f, s2.frame(i))
        assert not np.array_equal(f, other.frame(i))
    # moderate motion: consecutive frames differ, but not wholly
    d = np.abs(s1.frame(1).astype(int) - s1.frame(0).astype(int)).mean()
    assert 0.5 < d < 40.0


def test_checks_are_a_function_of_the_seed():
    cfgs = {p.stem: json.loads(p.read_text()) for p in (BENCH / "configs").glob("*.json")}
    for path in TRAFFIC:
        traffic = json.loads(path.read_text())
        for cfg in cfgs.values():
            a = compare.plan_checks(cfg, traffic, 2**32 + 3)
            assert a == compare.plan_checks(cfg, traffic, 2**32 + 3)


def test_camera_is_open_loop():
    traffic = {"frame_size": 32, "motion_px": 2, "motion_period_frames": 10,
               "texture_cells": 4, "texture_grain": 1.0}
    cam = CAM.Camera(CAM.Scene(traffic, 3), fps=200.0, start=time.monotonic(), phase=0.0)
    assert cam.recv_nowait().index == 0  # due at once
    assert cam.recv_nowait() is None  # the next is not due yet
    time.sleep(0.05)  # ~10 frames come due while nobody reads
    f = asyncio.run(cam.recv())
    assert f.index == 1 and f.wall_ts == cam.due(1)
    taken = [cam.recv_nowait() for _ in range(20)]
    assert [t.index for t in taken if t is not None][:3] == [2, 3, 4]
    assert f.to_ndarray().shape == (32, 32, 3)
