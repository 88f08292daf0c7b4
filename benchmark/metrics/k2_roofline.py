"""K2 (`image_rows_kernel`): its least time at the cell's shapes (bytes
read and written once at the HBM rate, or operations at the dtype's
peak), over the mean duration of its traced launches, in %."""

from benchmark import roofline


def read(ctx):
    r = ctx["trace"]
    k = None if r is None else r.kernel("image_rows_kernel")
    if k is None or ctx["kind"] not in roofline.PEAKS:
        return None
    bound = roofline.k2_bound_s(ctx["window"], ctx["dtype"], ctx["lanes"],
                                ctx["kind"])
    return bound / k[1] * 100
