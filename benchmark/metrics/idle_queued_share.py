"""The share of the settled trace span in which the device idled while a
frame waited inside the program (%): the device's idle holes intersected
with the dispatcher's hold.window, hold.depth, hold.step_lock and dispatch
spans (the program's own spans, on the device trace's clock)."""
from benchmark.spans import QUEUED, dispatcher_in, overlap, union


def read(ctx):
    sp = ctx.get("spans")
    if not sp or not dispatcher_in(sp):
        return None
    lo, hi = sp["settled"]
    queued = union((max(t0, lo), min(t1, hi)) for _, t0, t1, _ in dispatcher_in(sp, QUEUED))
    return 100.0 * overlap(sp["idle"], queued) / (hi - lo)
