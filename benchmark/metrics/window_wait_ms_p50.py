"""The scheduler's own median wait of a frame in its coalescing window (ms),
as its snapshot gives it at the window's end (its last 512 waits)."""


def read(ctx):
    return ctx["counters"]["t1"].get("batchsched_window_wait_ms_p50")
