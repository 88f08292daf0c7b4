"""`CtrlVIO.timing["consume_fetch"]` a call of the image cell: the host's
wait on the card for the lagged summary it pulls every
`stream_consume_every` frames."""


def read(ctx):
    t = ctx["timing"]
    if t is None or ctx["driver"] != "images" or not ctx["calls"]:
        return None
    return t.get("consume_fetch", 0.0) / ctx["calls"] * 1e3
