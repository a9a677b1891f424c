"""Median over the bucket steps dispatched in the settled trace span of the
step's first readback resolve on the host (its resolve instant) less the
end of its readback copy on the device, on the device trace's clock (ms):
how late the track fetches a finished step."""
import statistics

from benchmark.spans import resolve_lags_ms


def read(ctx):
    sp = ctx.get("spans")
    lags = resolve_lags_ms(sp) if sp else []
    return statistics.median(lags) if lags else None
