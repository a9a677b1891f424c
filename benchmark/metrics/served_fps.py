"""Frames returned to every session's viewer in the window, over its seconds."""
from benchmark.readings import returns_in


def read(ctx):
    return len(returns_in(ctx)) / ctx["seconds"] or None
