"""The share of the settled trace span in which no device operation ran (%)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / tr["window_us"])
