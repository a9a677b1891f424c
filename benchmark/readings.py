"""What the metric readers (metrics/<name>.py) read: a run's context and
small helpers over it.  A reader is ``read(ctx) -> float | None``; None
means it found nothing to read, and the harness leaves the metric out.

``ctx`` keys: ``seconds``, ``window`` (t0, t1 on the monotonic clock),
``setup_s``, ``records`` (harness.SessionRecord per session), ``cameras``,
``counters`` ({"t0", "t1"}: the scheduler's snapshot at the window's
edges), ``trace`` (trace.reduce of the traced run, else None),
``trace_host`` (the profiler's open and close on the host clock),
``trace_counters`` (the scheduler's snapshots there), ``cfg``, ``traffic``.
"""

from __future__ import annotations

import numpy as np

from .roofline import attention_bound_s


def returns_in(ctx, lo=None, hi=None) -> list:
    """[(session, monotonic, frame index)] of processed frames returned to a
    viewer in [lo, hi] (default: the window)."""
    t0, t1 = ctx["window"]
    lo, hi = t0 if lo is None else lo, t1 if hi is None else hi
    return [(s, t, i) for s, rec in enumerate(ctx["records"]) for t, i in rec.returns
            if lo <= t <= hi]


def latencies_ms(ctx) -> list:
    """Return time less the camera frame's due time, ms, over the window."""
    cams = ctx["cameras"]
    return [(t - cams[s].due(i)) * 1e3 for s, t, i in returns_in(ctx)]


def frame_ms_p95(ctx):
    lat = latencies_ms(ctx)
    return float(np.percentile(lat, 95)) if lat else None


def submit_ms_p50(ctx):
    t0, t1 = ctx["window"]
    spans = [d * 1e3 for rec in ctx["records"] for t, d in rec.submit_spans if t0 <= t <= t1]
    return float(np.median(spans)) if spans else None


def per_step(ctx, value):
    """``value`` over the bucket steps of the settled trace, or None."""
    tr = ctx.get("trace")
    if not tr or not tr["steps"] or value is None:
        return None
    return value / tr["steps"]


def hist_delta(a: dict, b: dict) -> dict:
    """The occupancy histogram's counts between two scheduler snapshots."""
    ha, hb = a["batchsched_occupancy_hist"], b["batchsched_occupancy_hist"]
    return {int(k): v - ha.get(k, 0) for k, v in hb.items() if v - ha.get(k, 0) > 0}


def bucket_of(n: int, max_sessions: int) -> int:
    """The bucket a step of n riders runs: the nearest power of two, capped
    at the slot count."""
    k = 1
    while k < n:
        k *= 2
    return min(k, max_sessions)


def attention_bound_per_step_s(ctx) -> float | None:
    """The mean attention bound of one bucket step over the trace window's
    mix of buckets (the occupancy histogram between the profiler's edges)."""
    if not ctx.get("trace_counters"):
        return None
    hist = hist_delta(*ctx["trace_counters"])
    steps = sum(hist.values())
    if not steps:
        return None
    rows = len(ctx["cfg"]["stream"]["t_index_list"])
    S = ctx["traffic"]["sessions"]
    return sum(c * attention_bound_s(ctx["cfg"], rows * bucket_of(n, S))
               for n, c in hist.items()) / steps
