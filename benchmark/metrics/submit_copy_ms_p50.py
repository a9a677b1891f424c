"""Median over the frames traced in the settled span of their submit.pin
plus submit.copy spans (ms): the host buffer pinned and its copy to the
card queued, inside ScheduledSession.submit."""
import statistics

from benchmark.spans import frame_ms


def read(ctx):
    sp = ctx.get("spans")
    ms = frame_ms(sp, ("submit.pin", "submit.copy")) if sp else []
    return statistics.median(ms) if ms else None
