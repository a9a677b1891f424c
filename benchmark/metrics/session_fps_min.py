"""Frames returned to the slowest session in the window, over its seconds."""
from benchmark.readings import returns_in


def read(ctx):
    counts = [0] * len(ctx["records"])
    for s, _, _ in returns_in(ctx):
        counts[s] += 1
    return min(counts) / ctx["seconds"] or None
