"""Device ms a bucket step in the elementwise, norm/reduce and copy/cat/cast
kernel classes (the UNet's and TAESD's pointwise layers, norms, permutes)."""
from benchmark.readings import per_step
from benchmark.trace import POINTWISE


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    us = sum(tr["by_class_us"].get(c, 0.0) for c in POINTWISE)
    return per_step(ctx, us / 1e3) if us > 0 else None
