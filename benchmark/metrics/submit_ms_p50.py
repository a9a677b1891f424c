"""Median of the harness's own span around each ScheduledSession.submit
the track made in the window (ms): coerce, pin, copy, enqueue."""
from benchmark.readings import submit_ms_p50


def read(ctx):
    return submit_ms_p50(ctx)
