"""The F-gate's host time a call: the epipolar F-RANSAC gate's span
(`CtrlVIO.timing["frontend.fgate"]`) over the window's calls, in ms."""


def read(ctx):
    t = ctx["timing"]
    if (t is None or ctx["driver"] != "images" or not ctx["calls"]
            or "frontend.fgate" not in t):
        return None
    return t["frontend.fgate"] / ctx["calls"] * 1e3
