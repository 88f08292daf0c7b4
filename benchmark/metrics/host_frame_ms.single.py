"""The host's own time a call, from the port's spans: the mean, over the
window's calls, of the port's `process_frame` span less its
`consume_fetch` spans (the wait on the card for a lagged summary)."""

from benchmark import spans


def read(ctx):
    sp = ctx.get("spans")
    if sp is None or ctx["driver"] != "single" or not sp["frames"]:
        return None
    ms = [spans.host_ms(f) for f in sp["frames"]]
    return sum(ms) / len(ms)
