"""The traffic generator: live camera sessions, from a traffic file and the
run's seed.

A traffic file (traffic/<name>.json) gives the number of sessions, each
camera's frame rate, the frame size and the motion; this module turns it
and ``--seed`` into each session's prompt, noise seed, phase and frames.
Every session gets the same kind of work on every seed: the same rate and
size, a texture and a path of the same statistics, only drawn anew.

A frame is a window onto the session's seeded texture (a smooth random
field with grain) that moves along a circle, so consecutive frames differ
as a webcam's do.  Pixels are made when the track takes the frame; a frame
skipped by the agent's ingest costs nothing.  ``Camera`` is the source
track: open loop, frame i is due at ``start + phase + i / fps`` whatever
the consumer does; ``recv()`` waits for the next frame's due time,
``recv_nowait()`` hands over the next frame if it is already due (the
agent's freshest-frame-wins ingest skips ahead with it).  Each frame
carries its due time as ``wall_ts`` on the monotonic clock, the stamp the
agent reads a frame's age from.
"""

from __future__ import annotations

import asyncio
import math
import time

import numpy as np

WORDS = {
    "subject": ["portrait", "street", "kitchen", "garden", "office", "harbor", "forest", "studio",
                "library", "market", "mountain", "beach"],
    "style": ["watercolor", "oil painting", "pencil sketch", "neon cyberpunk", "ukiyo-e",
              "pixel art", "stained glass", "charcoal", "pop art", "claymation", "mosaic",
              "art nouveau"],
    "light": ["at dusk", "in soft light", "at night", "in fog", "at noon", "by candlelight"],
}


def session_plan(traffic: dict, seed: int) -> list:
    """[{"prompt", "noise_seed", "phase", "texture_seed"}] per session, from
    the run's seed: distinct prompts, noise seeds below 2**62; the cameras'
    phases are the same evenly spread set on every seed, dealt out in the
    seed's order."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 0x70726F6D]))
    n = traffic["sessions"]
    phases = rng.permutation(n) / (n * traffic["camera_fps"])
    subjects = rng.permutation(len(WORDS["subject"]))
    styles = rng.permutation(len(WORDS["style"]))
    plan = []
    for i in range(n):
        prompt = (f"a {WORDS['subject'][subjects[i % len(subjects)]]} as "
                  f"{WORDS['style'][styles[i % len(styles)]]} "
                  f"{WORDS['light'][int(rng.integers(len(WORDS['light'])))]}")
        plan.append({"prompt": prompt, "noise_seed": int(rng.integers(0, 2**62)),
                     "phase": float(phases[i]),
                     "texture_seed": int(rng.integers(0, 2**62))})
    if len({p["prompt"] for p in plan}) != n:
        raise ValueError("the session prompts must be distinct")
    return plan


class Scene:
    """One session's frames: ``frame(i)`` is [size, size, 3] uint8, the same
    for the same texture seed and index."""

    def __init__(self, traffic: dict, texture_seed: int):
        import torch
        import torch.nn.functional as F

        size, m = traffic["frame_size"], traffic["motion_px"]
        rng = np.random.default_rng(texture_seed)
        cells = traffic["texture_cells"]
        low = torch.from_numpy(rng.uniform(0.0, 255.0, (1, 3, cells, cells)).astype(np.float32))
        field = F.interpolate(low, size=(size + 2 * m, size + 2 * m), mode="bilinear",
                              align_corners=False)[0].permute(1, 2, 0).numpy()
        grain = rng.normal(0.0, traffic["texture_grain"], field.shape).astype(np.float32)
        self.texture = np.clip(field + grain, 0, 255).round().astype(np.uint8)
        self.size, self.m = size, m
        self.period = traffic["motion_period_frames"]
        self.phi = float(rng.uniform(0.0, 2 * math.pi))

    def frame(self, i: int) -> np.ndarray:
        a = 2 * math.pi * i / self.period + self.phi
        y = int(round(self.m * (1 + math.sin(a))))
        x = int(round(self.m * (1 + math.cos(a))))
        return np.ascontiguousarray(self.texture[y:y + self.size, x:x + self.size])


class CameraFrame:
    """A frame as the agent's track takes it: ``to_ndarray``, ``wall_ts``."""

    __slots__ = ("scene", "index", "wall_ts", "_pixels")

    def __init__(self, scene: Scene, index: int, due: float):
        self.scene, self.index, self.wall_ts = scene, index, due
        self._pixels = None

    def to_ndarray(self, format: str = "rgb24") -> np.ndarray:  # noqa: A002 - av's keyword
        if self._pixels is None:
            self._pixels = self.scene.frame(self.index)
        return self._pixels


class Camera:
    """The open-loop source track of one session."""

    kind = "video"

    def __init__(self, scene: Scene, fps: float, start: float, phase: float):
        self.scene, self.period, self.t0 = scene, 1.0 / fps, start + phase
        self.next_index = 0
        self.late: list = []  # how late recv() handed out frames it had waited for (s)

    def due(self, i: int) -> float:
        return self.t0 + i * self.period

    def _take(self) -> CameraFrame:
        i = self.next_index
        self.next_index += 1
        return CameraFrame(self.scene, i, self.due(i))

    async def recv(self) -> CameraFrame:
        wait = self.due(self.next_index) - time.monotonic()
        if wait > 0:
            await asyncio.sleep(wait)
            self.late.append(time.monotonic() - self.due(self.next_index))
        return self._take()

    def recv_nowait(self):
        if self.due(self.next_index) <= time.monotonic():
            return self._take()
        return None
