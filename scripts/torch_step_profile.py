#!/usr/bin/env python3
"""Where one stream step's time goes in the PyTorch/CUDA port.

    python3 scripts/torch_step_profile.py [--steps 20] [--model-id stabilityai/sd-turbo]
                                          [--sessions K] [--graphs]

Builds the port's StreamDiffusionPipeline on the card (random weights, the
default serving config), warms up, times ``--steps`` synchronous steps
without the profiler, then profiles the same number of steps with
torch.profiler tracing the device only (no host-op recording, so the
profiled steps run close to the unprofiled rate).  Prints one JSON line:
wall ms per step of both windows; from the profiled window's device trace
alone, busy ms per step (the union of kernel intervals), the trace span
(first kernel start to last kernel end) and the device's idle share,
1 - busy/span; device ms per step by kernel class (the two hand-written
kernels by name; GEMMs, convolutions, normalisation/elementwise and copies
by kernel-name pattern) and the top kernels by name; beside the card's name
and power limit from nvidia-smi.  ``--sessions K`` profiles the batch
scheduler's bucket step of K sessions instead (parallel/multipeer.py
``BucketStep`` over K stacked copies of the pipeline's state, K frames
staged from pinned memory, each session's row read back), one bucket step
per "step".  The step runs eagerly unless ``--graphs``: then it is the
captured CUDA graph the serving path replays (the pipeline's, or the
bucket's), and the same trace gives the device busy time, idle share and
kernels per replay.  Needs one NVIDIA card.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CLASSES = [
    ("flash_attention (port kernel)", r"flash_attention_kernel"),
    ("fused_stream_epilogue (port kernel)", r"stream_epilogue_kernel"),
    ("convolution", r"conv|cudnn|implicit_convolve|fprop|dgrad|wgrad|nhwc|nchw"),
    ("gemm", r"gemm|cutlass|nvjet|xmma|sm90_|cublas"),
    ("norm/reduce", r"reduce|norm|welford|var_mean"),
    ("copy/cat/cast", r"copy|cat|Memcpy|Memset|fill|convert"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]


def classify(name: str) -> str:
    for label, pat in CLASSES:
        if re.search(pat, name, re.IGNORECASE):
            return label
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--model-id", default="stabilityai/sd-turbo")
    ap.add_argument("--sessions", type=int, default=0,
                    help="profile the bucket step of K sessions (0: one pipeline step)")
    ap.add_argument("--graphs", action="store_true",
                    help="replay the captured CUDA graph (default: the eager step)")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ai_rtc_agent_tpu_torch.utils import hwfp

    fp = hwfp.fingerprint()
    if fp["backend"] != "cuda":
        print(f"FAIL: needs an NVIDIA card: {fp.get('error')}", flush=True)
        sys.exit(1)
    card = fp["card"]

    from ai_rtc_agent_tpu_torch.stream.pipeline import StreamDiffusionPipeline

    pipe = StreamDiffusionPipeline(args.model_id, seed=2, graphs=args.graphs)
    cfg = pipe.config
    rng = np.random.default_rng(0)
    k = args.sessions
    frames = [rng.integers(0, 256, (max(k, 1), cfg.height, cfg.width, 3), dtype=np.uint8)
              for _ in range(args.steps + 3)]
    if k:
        from ai_rtc_agent_tpu_torch.parallel.multipeer import BucketStep, Readback
        from ai_rtc_agent_tpu_torch.stream.engine import stack_states

        eng = pipe.engine
        states = stack_states([eng.state] * k)
        bucket = BucketStep(eng.models, cfg, pipe.device, graphs=args.graphs)

        def step(batch):
            out = bucket(eng.params, states, batch, list(range(k)), k)
            readback = Readback(out, k)
            for r in range(k):
                readback.row(r)
    else:
        def step(batch):
            pipe(batch[0])
    for f in frames[:3]:
        step(f)
    torch.cuda.synchronize()

    def run_steps() -> float:
        t0 = time.perf_counter()
        for f in frames[3:]:
            step(f)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / args.steps

    wall_ms = run_steps()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the window opens on an idle card: the profiler drops a device
        # record stamped before it (scripts/torch_trace_window.py)
        time.sleep(0.5)
        profiled_wall_ms = run_steps()
        time.sleep(0.5)

    # idle share from this one trace: kernel intervals against their span
    spans = sorted(
        (ev.time_range.start, ev.time_range.end) for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.time_range.end > ev.time_range.start
    )
    if not spans:
        print("FAIL: the profiler recorded no device time", flush=True)
        sys.exit(1)
    busy_us, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    span_us = spans[-1][1] - spans[0][0]

    by_class: dict[str, float] = {}
    by_name: dict[str, float] = {}
    launches = 0
    port_kernels = {"flash_attention_kernel": 0, "stream_epilogue_kernel": 0}
    for ev in prof.key_averages():
        # device events only: a host-side event that launched a kernel may
        # report the same device time again, which would double the sum
        dev_us = getattr(ev, "self_device_time_total", 0.0) or 0.0
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = dev_us / 1e3 / args.steps
        label = classify(ev.key)
        by_class[label] = by_class.get(label, 0.0) + ms
        by_name[ev.key[:90]] = by_name.get(ev.key[:90], 0.0) + ms
        launches += ev.count
        for name in port_kernels:
            if name in ev.key:
                port_kernels[name] += ev.count
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "metric": "torch_port_step_profile",
        "model_id": args.model_id,
        "config": f"{cfg.height}x{cfg.width} {cfg.dtype} {cfg.scheduler} cfg={cfg.cfg_type} "
                  f"B={cfg.batch_size}" + (f", {k} sessions per bucket step" if k else "")
                  + (", CUDA graph replay" if args.graphs else ", eager"),
        "card": card,
        "device": fp["device_kind"],
        "steps": args.steps,
        "wall_ms_per_step": wall_ms,
        "profiled_wall_ms_per_step": profiled_wall_ms,
        "trace_span_ms_per_step": span_us / 1e3 / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_idle_share": 1.0 - busy_us / span_us,
        "device_launches_per_step": launches / args.steps,
        "port_kernels_per_step": {n: c / args.steps for n, c in port_kernels.items()},
        "device_ms_per_step_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms_per_step": dict(top),
    }), flush=True)


if __name__ == "__main__":
    main()
