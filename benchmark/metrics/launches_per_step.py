"""Device kernels that started in the settled trace span, over the bucket
steps in it."""
from benchmark.readings import per_step


def read(ctx):
    tr = ctx.get("trace")
    return per_step(ctx, tr["launches"] if tr else None)
