"""The share of the traced sub-window in which the card is idle: covered
neither by a traced device operation nor by a stamped megastep (the port's
stamps see the WHILE node's trips that the tracer misses), in %."""

from benchmark import spans


def read(ctx):
    sp = ctx.get("spans")
    if sp is None or ctx["driver"] != "single":
        return None
    return spans.idle_share(sp)
