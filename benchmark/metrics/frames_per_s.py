"""Frames whose pose the window's calls returned (every lane's), over the
whole window, its closing flush and synchronize included (host clock)."""

from benchmark import stats


def read(ctx):
    return stats.rate(ctx["calls"] * ctx["lanes"], ctx["t_open"],
                      ctx["t_close"])
