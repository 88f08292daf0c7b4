"""Host time a call of the image cell that is not the blocking pull of a
lagged summary: the mean timed call less `CtrlVIO.timing["consume_fetch"]`
a call (the front end's host work included)."""


def read(ctx):
    t = ctx["timing"]
    if t is None or ctx["driver"] != "images" or not ctx["calls"]:
        return None
    mean = sum(ctx["call_s"]) / len(ctx["call_s"])
    return (mean - t.get("consume_fetch", 0.0) / ctx["calls"]) * 1e3
