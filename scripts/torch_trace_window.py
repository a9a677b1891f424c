#!/usr/bin/env python3
"""Does a device-only torch.profiler trace hold every kernel the port launched?

    python3 scripts/torch_trace_window.py [--reps 8] [--settle 0 0.5]

Builds the port's SD1.5 pipeline on the card (random weights from a seed),
a graph BatchScheduler in sequential mode (128 attention launches a bucket
step) with two sessions, and warms it with chip_smoke.py's 36 frames a
session.  Then, for each ``--settle`` value S and ``--reps`` times, it
traces 12 frames a session as chip_smoke.py's phase 12c does, with the card
idle for S seconds after the window opens and before it closes, and prints
one line a trace: the bucket steps, the attention launches counted by the
kernel's wrapper, the attention kernels the trace holds, where the first
kernel starts and the last ends in the window (ms), and OK or MISMATCH.
The last line is one JSON object {"settle_s": {"mismatches", "traces"}}
beside the card's name and power limit from nvidia-smi.  Needs one NVIDIA
card; run from the repository's root.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--settle", type=float, nargs="+", default=[0.0, 0.5])
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline
    from ai_rtc_agent_tpu_torch.stream.scheduler import BatchScheduler

    card = cs.phase_device(torch)
    cs.phase_build(torch)

    def trace(fn, settle):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(settle)
            fn()
            torch.cuda.synchronize()
            time.sleep(settle)
        evs = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        attn = sum("flash_attention_kernel" in ev.name for ev in evs)
        first = min(ev.time_range.start for ev in evs) / 1e3
        last = max(ev.time_range.end for ev in evs) / 1e3
        return attn, first, last

    pipe = StreamDiffusionPipeline(cs.SD15_ID, seed=2)
    eng = pipe.engine
    cfg = replace(pipe.config, use_denoising_batch=False)
    per_step = cs.MODE_LAUNCHES["sequential"][0]
    sched = BatchScheduler(eng.models, eng.params, cfg, eng.encode_prompt, model_id=cs.SD15_ID,
                           max_sessions=2, schedule=eng.schedule, device=pipe.device)
    frames = [cs._frames(np, cs.SD15_FRAMES, seed=140 + i, size=cfg.height) for i in range(2)]
    sess = [sched.claim(f"trace-{i}", prompt=cs.SESSION_PROMPTS[i], seed=400 + i)
            for i in range(2)]
    result = {}
    try:
        cs.drive_sessions(torch, sess, frames, cs.SD15_FRAMES)
        for settle in args.settle:
            bad = 0
            for rep in range(args.reps):
                cs._reset_launches()
                steps0 = sched.steps_total
                attn, first, last = trace(lambda: cs.drive_sessions(
                    torch, sess, [f[:cs.SD15_TRACE_FRAMES] for f in frames],
                    cs.SD15_TRACE_FRAMES), settle)
                steps = sched.steps_total - steps0
                launched = cs._launches()[0]
                ok = attn == launched == per_step * steps
                bad += not ok
                print(f"settle {settle} s, trace {rep}: {steps} bucket steps, attention launched "
                      f"{launched}, in the trace {attn}; kernels from {first:.1f} to {last:.1f} ms "
                      f"of the window | {'OK' if ok else 'MISMATCH'}", flush=True)
            result[str(settle)] = {"mismatches": bad, "traces": args.reps}
    finally:
        for s in sess:
            s.release()
        sched.close()
    print(card)
    print(json.dumps({"settle_s": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
