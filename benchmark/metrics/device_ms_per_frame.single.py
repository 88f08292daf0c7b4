"""The card's time a streamed call, from the port's own stamps: the mean,
over the megasteps that the window's calls dispatched, of the megastep's
last stamp less its first (`ctx["spans"]`, `benchmark/spans.py`; every
replay is stamped, its WHILE node's trips included)."""

from benchmark import spans


def read(ctx):
    sp = ctx.get("spans")
    if sp is None or ctx["driver"] != "single":
        return None
    ms = [d for d in map(spans.device_ms, sp["megasteps"]) if d is not None]
    return sum(ms) / len(ms) if ms else None
