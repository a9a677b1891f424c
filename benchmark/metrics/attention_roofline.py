"""The flash-attention kernel's share of its roofline (%): the bound of
the settled span's bucket steps (the configuration's attention shapes at
the trace's mix of buckets, roofline.attention_bound_s) over the kernel's
device time in the span."""
from benchmark.readings import attention_bound_per_step_s


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["steps"]:
        return None
    kernel_us = tr["by_class_us"].get("flash_attention", 0.0)
    bound = attention_bound_per_step_s(ctx)
    if kernel_us <= 0 or bound is None:
        return None
    return 100.0 * bound * 1e6 * tr["steps"] / kernel_us
