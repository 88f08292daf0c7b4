"""Seconds the captured programs took to warm up and capture before the
window (`graphs.stats()["capture_s"]` at its start): a part of set-up."""


def read(ctx):
    if ctx["c0"] is None:
        return None
    return ctx["c0"]["graphs"]["capture_s"]
