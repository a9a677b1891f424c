"""The batch scheduler's time held in its coalescing window with frames
queued (its always-on batchsched_hold_ms_total["window"]), over its steps,
between the window's edges (ms a bucket step)."""
from benchmark.spans import hold_ms_per_step


def read(ctx):
    return hold_ms_per_step(ctx, "window")
