"""The device trace of a traced run and its reduction to per-layer numbers.

``Profiler`` opens a device-only ``torch.profiler`` window (CUDA activity:
kernels, copies, sets) while the cell serves.  ``reduce`` settles it: the
profiler can drop a record stamped near its edges, so only the span from
0.5 s after the first device record to 0.5 s before the last one is read.
Inside it: busy time is the union of the device intervals, clipped to the
span; idle gaps are the holes in that union, each named by the kernel
classes on either side; device time is summed by kernel class and by
kernel name; a bucket step is counted by its one epilogue launch.

The kernel classes (by name pattern, first match wins) are those of
scripts/torch_step_profile.py.
"""

from __future__ import annotations

import re
import time

SETTLE_US = 500_000.0

CLASSES = [
    ("flash_attention", r"flash_attention_kernel"),
    ("fused_stream_epilogue", r"stream_epilogue_kernel"),
    ("convolution", r"conv|cudnn|implicit_convolve|fprop|dgrad|wgrad|nhwc|nchw"),
    ("gemm", r"gemm|cutlass|nvjet|xmma|sm90_|cublas"),
    ("norm/reduce", r"reduce|norm|welford|var_mean"),
    ("copy/cat/cast", r"copy|cat|Memcpy|Memset|fill|convert"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]
STEP_MARKER = "fused_stream_epilogue"  # one launch a bucket step
POINTWISE = ("elementwise", "norm/reduce", "copy/cat/cast")


def classify(name: str) -> str:
    for label, pat in CLASSES:
        if re.search(pat, name, re.IGNORECASE):
            return label
    return "other"


def warm_up():
    """Open and close one empty device profiler window: the first window a
    process opens loads and starts CUPTI, which holds the caller for
    seconds; set-up pays that, not the measured window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


class Profiler:
    """A device-only profiler window, opened and closed on the host clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.t_open = self.t_close = None
        self._records: list = []

    def start(self):
        self._prof.start()
        self.t_open = time.monotonic()

    def stop(self, t_close: float | None = None):
        """Close the window and read its device records (the profiler keeps
        its events only until its next cycle); ``t_close``: the host time
        the window is taken to end at, by default now."""
        import torch

        self.t_close = time.monotonic() if t_close is None else t_close
        self._prof.stop()
        self._records = [(ev.name, float(ev.time_range.start), float(ev.time_range.end))
                         for ev in self._prof.events()
                         if ev.device_type == torch.autograd.DeviceType.CUDA
                         and ev.time_range.end > ev.time_range.start]

    def records(self) -> list:
        """[(kernel name, start us, end us)] of the device's records."""
        return self._records


def reduce(records: list) -> dict | None:
    """Per-layer numbers of a device trace [(name, start_us, end_us)], or
    None when the settled span holds no device record."""
    if not records:
        return None
    records = sorted(records, key=lambda r: r[1])
    lo = records[0][1] + SETTLE_US
    hi = max(r[2] for r in records) - SETTLE_US
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in records if e > lo and s < hi]
    if hi <= lo or not inside:
        return None
    by_class: dict = {}
    by_name: dict = {}
    launches = steps = 0
    for name, s, e in inside:
        cls = classify(name)
        by_class[cls] = by_class.get(cls, 0.0) + (e - s)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if s > lo:  # started inside the span (a clipped one started before)
            launches += 1
            steps += cls == STEP_MARKER
    busy, gaps = 0.0, []
    cur_s, cur_e, cur_n = inside[0][1], inside[0][2], inside[0][0]
    if cur_s > lo:
        gaps.append((cur_s - lo, "window start", classify(cur_n)))
    for name, s, e in inside[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, classify(cur_n), classify(name)))
            cur_s = s
        if e >= cur_e:
            cur_e, cur_n = e, name
    busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((hi - cur_e, classify(cur_n), "window end"))
    gaps.sort(key=lambda g: -g[0])
    return {"window_us": hi - lo, "busy_us": busy, "launches": launches, "steps": steps,
            "by_class_us": by_class, "by_name_us": by_name, "gaps": gaps}


def breakdown(tr: dict) -> dict:
    """The contract's ``breakdown``: the ten device operations that took most
    time and the ten longest idle gaps, in seconds over the settled span."""
    ops = sorted(tr["by_name_us"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:120], us / 1e6] for name, us in ops],
            "idle_gaps": [[f"{a} -> {b}", us / 1e6] for us, a, b in tr["gaps"][:10]]}
