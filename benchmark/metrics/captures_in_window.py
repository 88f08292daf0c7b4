"""CUDA graphs captured while the window ran (`graphs.stats()`'s
captures at its end less those at its start): each is set-up work that
fell into the window."""


def read(ctx):
    if ctx["c1"] is None:
        return None
    return (len(ctx["c1"]["graphs"]["graphs_captured"])
            - len(ctx["c0"]["graphs"]["graphs_captured"]))
