"""Median over the frames traced in the settled span of their ingest span
(ms): the camera frame's due time to its admission by the track."""
import statistics

from benchmark.spans import frame_ms


def read(ctx):
    sp = ctx.get("spans")
    ms = frame_ms(sp, ("ingest",)) if sp else []
    return statistics.median(ms) if ms else None
