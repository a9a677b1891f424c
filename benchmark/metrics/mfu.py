"""The whole step's share of the chip's bf16 peak (%): frames returned in
the settled trace span x the configuration's FLOPs a frame, over the
span's seconds, over 989 TFLOP/s."""
from benchmark.readings import returns_in
from benchmark.roofline import PEAK_BF16_FLOPS
from benchmark.trace import SETTLE_US


def read(ctx):
    if not ctx.get("trace") or not ctx.get("trace_host"):
        return None
    lo, hi = ctx["trace_host"]
    lo, hi = lo + SETTLE_US / 1e6, hi - SETTLE_US / 1e6
    frames = len(returns_in(ctx, lo, hi))
    if hi <= lo or not frames:
        return None
    return 100.0 * frames * ctx["cfg"]["flops_per_frame"] / (hi - lo) / PEAK_BF16_FLOPS
