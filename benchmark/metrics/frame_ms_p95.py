"""95th percentile over every frame returned in the window of its return
time less its camera frame's due time (ms)."""
from benchmark.readings import frame_ms_p95


def read(ctx):
    return frame_ms_p95(ctx)
