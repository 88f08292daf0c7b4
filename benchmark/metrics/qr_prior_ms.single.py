"""The card's time for the streamed QR prior (`build_prior_sqrt`): the
mean, over the window's stamped megasteps that marginalize the oldest
keyframe, of the stamps around it."""


def read(ctx):
    sp = ctx.get("spans")
    if sp is None or ctx["driver"] != "single":
        return None
    ms = [(m["prior_end"] - m["prior_begin"]) * 1e-6
          for m in sp["megasteps"]
          if m["marg_old"] and m["prior_begin"] > 0 and m["prior_end"] > 0]
    return sum(ms) / len(ms) if ms else None
