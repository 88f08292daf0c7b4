"""K1 (`lk_kernel`, the front end's fused forward-backward track): its
least time at the cell's shapes (`roofline_k1`: the features the tracker
keeps, the levels of the traced sub-window's launches, the iterations)
over the mean duration of its traced launches, in %."""

from benchmark import roofline, roofline_k1


def read(ctx):
    r, c1, ct = ctx["trace"], ctx["c1"], ctx["c_tr"]
    k = None if r is None else r.kernel("lk_kernel")
    if (k is None or ct is None or "k1" not in ct
            or ctx["kind"] not in roofline.PEAKS):
        return None
    by = {L: n - c1["k1"]["by_levels"].get(L, 0)
          for L, n in ct["k1"]["by_levels"].items()}
    launches = sum(by.values())
    if launches <= 0:
        return None
    levels = sum(L * n for L, n in by.items()) / launches
    bound = roofline_k1.track_bound_s(ct["k1"]["n"], levels,
                                      ct["k1"]["iters"], ctx["kind"])
    return bound / k[1] * 100
