"""Process start to the window's start: the sequence made, the estimator
started, the warm-up frames (every kernel built and program captured)."""


def read(ctx):
    return ctx["t_open"] - ctx["t_start"]
