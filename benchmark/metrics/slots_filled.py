"""Frames a bucket step carried in the window: the occupancy histogram's
delta, weighted by occupancy, over the delta of the scheduler's steps."""
from benchmark.readings import hist_delta


def read(ctx):
    a, b = ctx["counters"]["t0"], ctx["counters"]["t1"]
    steps = b["batchsched_steps_total"] - a["batchsched_steps_total"]
    if steps <= 0:
        return None
    return sum(n * c for n, c in hist_delta(a, b).items()) / steps
