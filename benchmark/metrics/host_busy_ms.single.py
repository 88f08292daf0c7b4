"""Host time a call that is not the blocking pull of a lagged summary:
the mean timed call less `CtrlVIO.timing["consume_fetch"]` a call."""


def read(ctx):
    t = ctx["timing"]
    if t is None or ctx["driver"] != "single" or not ctx["calls"]:
        return None
    mean = sum(ctx["call_s"]) / len(ctx["call_s"])
    return (mean - t.get("consume_fetch", 0.0) / ctx["calls"]) * 1e3
