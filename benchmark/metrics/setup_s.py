"""Process start to the window's start (s): weights, the program's build,
every bucket captured, the sessions claimed and settled."""


def read(ctx):
    return ctx["setup_s"]
