"""The union of device intervals in the settled trace span (ms), over the
bucket steps in it."""
from benchmark.readings import per_step


def read(ctx):
    tr = ctx.get("trace")
    return per_step(ctx, tr["busy_us"] / 1e3 if tr else None)
