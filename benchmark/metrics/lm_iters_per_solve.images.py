"""LM iterations a streamed solve in the image cell: K4 launches (one an
iteration, the WHILE node's trips settled from its device counter) over
the megasteps of the window."""


def read(ctx):
    c0, c1 = ctx["c0"], ctx["c1"]
    if c1 is None or ctx["driver"] != "images":
        return None
    solves = c1["megasteps"] - c0["megasteps"]
    if solves <= 0:
        return None
    return (c1["lm"]["lm_accept"] - c0["lm"]["lm_accept"]) / solves
