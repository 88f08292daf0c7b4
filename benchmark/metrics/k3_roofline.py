"""K3 (`imu_rows_kernel`), as `k2_roofline`."""

from benchmark import roofline


def read(ctx):
    r = ctx["trace"]
    k = None if r is None else r.kernel("imu_rows_kernel")
    if k is None or ctx["kind"] not in roofline.PEAKS:
        return None
    bound = roofline.k3_bound_s(ctx["window"], ctx["dtype"], ctx["lanes"],
                                ctx["kind"])
    return bound / k[1] * 100
