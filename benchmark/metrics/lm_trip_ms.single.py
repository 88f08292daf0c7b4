"""The card's time for one trip of the streamed solve's WHILE node (LM
iterations 2 and up): the mean, over the window's stamped megasteps, of
the time from one trip stamp to the next (the first from the stamp after
the first iteration)."""

from benchmark import spans


def read(ctx):
    sp = ctx.get("spans")
    if sp is None or ctx["driver"] != "single":
        return None
    trips = [(b - a) * 1e-6 for m in sp["megasteps"]
             for a, b, phase in spans.megastep_intervals(m)
             if phase == "trip"]
    return sum(trips) / len(trips) if trips else None
