"""95th percentile, over every call of the window, of the host time from
handing in a frame (its IMU samples first) to the return of its pose."""

import sys

from benchmark import stats


def read(ctx):
    p95, beyond = stats.percentile(ctx["call_s"], 95)
    print(f"[bench] frame latency p95 over {len(ctx['call_s'])} calls, "
          f"{beyond} beyond it", file=sys.stderr)
    return p95 * 1e3
