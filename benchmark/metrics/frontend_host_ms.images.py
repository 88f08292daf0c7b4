"""The front end's host time a call: its spans' seconds over the window
(`CtrlVIO.timing` under `frontend.`: the gyro flow prediction, the
tracker's dispatch, and its consume, which holds the wait for the lagged
packed features and the F-gate) over the window's calls, in ms."""

KEYS = ("frontend.flow", "frontend.dispatch", "frontend.consume")


def read(ctx):
    t = ctx["timing"]
    if (t is None or ctx["driver"] != "images" or not ctx["calls"]
            or not any(k in t for k in KEYS)):
        return None
    return sum(t.get(k, 0.0) for k in KEYS) / ctx["calls"] * 1e3
