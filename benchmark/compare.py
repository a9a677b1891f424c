"""The comparison that decides ``correct``.

The served frames are held against the plain reference of the
configuration's family (families.py), run after the program's state is
freed, on the frames the window produced:

* a stream that depends on the current frame alone (one stage, no stock:
  sd-turbo) is checked on a sample of every session's frames drawn from the
  seed (frame i of session s is kept when i % every == offset[s]);
* a stream with a ring (the LCM stream batch, its stock) is checked on
  whole sessions drawn from the seed: the reference starts each from its
  first state and replays every frame the track submitted, in order (the
  agent's ingest skips show in that sequence), and every output the viewer
  received in the window's first ``check.replay_s`` seconds is compared
  (the replay walks every frame before the last one compared, so its cost
  grows with that frame's place).

A session's frames are checked against its own prompt and noise seed, so
a frame handed back to the wrong session fails too.

The number compared is ``frame_gap_levels``: over the compared frames, the
largest mean absolute difference between a served frame and the
reference's, in uint8 levels, over the frame's live pixels: those that
are not clamped to the same end (0 or 255) in both.  Random weights clamp
half to nearly all of a frame's pixels, by seed, and a pixel clamped in
both agrees whatever the precision: counted, it would dilute the gap by
seed (PERF.md has the readings).  Its limit is in the configuration file
(``limits``); PERF.md gives the readings it was set from.  Beside it,
``live_share`` is the smallest share of live pixels in a compared frame.
The control (``substitute``) puts the reference's frames at a lower
precision in the program's place and goes through the same check.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import camera as CAM
from . import families


def plan_checks(cfg: dict, traffic: dict, seed: int) -> dict:
    """Which frames are kept for the check, fixed from the seed before the
    window: {"mode", "every", "offsets"} or {"mode", "sessions"}."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 0x636865636B]))
    n, chk = traffic["sessions"], traffic["check"]
    if families.of(cfg).stateless(cfg["stream"]):
        every = chk["every"]
        return {"mode": "sample", "every": every,
                "offsets": [int(o) for o in rng.integers(0, every, n)]}
    return {"mode": "replay", "replay_s": chk["replay_s"],
            "sessions": sorted(int(s) for s in rng.choice(n, chk["replay_sessions"],
                                                          replace=False))}


def keepers(checks: dict, n: int) -> list:
    """Per session: frame index -> keep its served output."""
    if checks["mode"] == "sample":
        return [lambda i, o=o, e=checks["every"]: i % e == o for o in checks["offsets"]]
    chosen = set(checks["sessions"])
    return [(lambda i: True) if s in chosen else (lambda i: False) for s in range(n)]


def _gap(a: np.ndarray, b: np.ndarray) -> tuple:
    """(mean |a - b| in levels over the live pixels, the live share): a
    pixel is dead when it is clamped to the same end (0 or 255) in both."""
    dead = (a == b) & ((a == 0) | (a == 255))
    if dead.all():
        return 0.0, 0.0
    live = ~dead
    return float(np.abs(a.astype(np.int16) - b.astype(np.int16))[live].mean()), float(live.mean())


def check(cfg: dict, tree: dict, plan: list, scenes: list, records: list, window: tuple,
          checks: dict, device, precision: str = "f32", block: int = 8) -> dict:
    """Run the reference (at ``precision``) over the window's checked frames.
    -> {"frames": compared, "frame_gap_levels": worst gap, "gaps": all,
    "live_share": the least live share, "refs": {(session, frame index):
    the reference's uint8}}."""
    import torch

    t0, t1 = window
    # a replay steps one shape hundreds of times: let cuDNN pick its algorithms once
    torch.backends.cudnn.benchmark = checks["mode"] == "replay"
    ref = families.of(cfg).Reference(cfg, tree, device, precision)
    gaps, live, refs = [], [], {}
    if checks["mode"] == "sample":
        todo = []  # (session, frame index, served)
        for s, rec in enumerate(records):
            inside = {i for t, i in rec.returns if t0 <= t <= t1}
            todo += [(s, i, out) for i, out in sorted(rec.outputs.items()) if i in inside]
        starts = {}
        for k in range(0, len(todo), block):
            part = todo[k:k + block]
            states = []
            for s, _, _ in part:
                if s not in starts:
                    starts[s] = ref.start(plan[s]["prompt"], plan[s]["noise_seed"])
                states.append(dict(starts[s]))
            frames = np.stack([scenes[s].frame(i) for s, i, _ in part])
            outs = ref.step(states, frames, [True] * len(part))
            for (s, i, out), r in zip(part, outs):
                g, share = _gap(out, r)
                gaps.append(g)
                live.append(share)
                refs[(s, i)] = r
    else:
        for s in checks["sessions"]:
            rec = records[s]
            shed = {i for _, i, why in rec.failed if why == "shed"}
            seq = [i for i in rec.submitted if i not in shed]
            cut = min(t1, t0 + checks["replay_s"])
            inside = {i for t, i in rec.returns if t0 <= t <= cut}
            want = {i: out for i, out in rec.outputs.items() if i in inside}
            last = max(want) if want else -1
            state = ref.start(plan[s]["prompt"], plan[s]["noise_seed"])
            for i in seq:
                if i > last:
                    break
                out = ref.step([state], scenes[s].frame(i)[None], [i in want])[0]
                if out is not None:
                    g, share = _gap(want[i], out)
                    gaps.append(g)
                    live.append(share)
                    refs[(s, i)] = out
    del ref
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    return {"frames": len(gaps), "frame_gap_levels": max(gaps) if gaps else None, "gaps": gaps,
            "live_share": min(live) if live else None, "refs": refs}


def ref_stats(refs: dict) -> dict:
    """The reference frames' mean, spread and share of clamped pixels."""
    if not refs:
        return {}
    a = np.stack(list(refs.values())).astype(np.float32)
    return {"mean": float(a.mean()), "std": float(a.std()),
            "clamped": float(((a == 0) | (a == 255)).mean())}


def substitute(records: list, refs: dict) -> list:
    """The records with the frames of ``refs`` ({(session, frame index):
    uint8}) in place of the served ones: the control, put in the program's
    place, for the same check."""
    return [dataclasses.replace(rec, outputs={
        i: refs.get((s, i), out) for i, out in rec.outputs.items()})
        for s, rec in enumerate(records)]


def scenes_of(traffic: dict, plan: list) -> list:
    return [CAM.Scene(traffic, p["texture_seed"]) for p in plan]
