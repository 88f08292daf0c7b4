"""The traced sub-window of a `--trace 1` run: `torch.profiler` over a few
calls, with device activity only, read from its raw events.

The sub-window's bounds and the benchmark's host spans are taken on the
clock the profiler stamps its events with (ns since the epoch), so host
work costs no profiler events. Device time is the union of the kernels',
copies' and sets' intervals inside the sub-window; an idle gap is a stretch
of it with no device operation, labelled by the benchmark's host span that
overlaps it most. Nothing here reads the port.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from benchmark import replay


@dataclass
class Reading:
    calls: int
    window_s: float
    busy_s: float
    device_s: float
    ops: int
    outside: int
    by_name: Dict[str, Tuple[int, float]]
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel(self, needle: str):
        """(launches, mean seconds) of the device operations whose name
        holds `needle`, or None where the trace holds none."""
        n = sum(c for k, (c, _) in self.by_name.items() if needle in k)
        s = sum(t for k, (_, t) in self.by_name.items() if needle in k)
        return (n, s / n) if n else None

    def breakdown(self):
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[k, t] for k, (_, t) in top],
                "idle_gaps": [[k, s] for k, s in self.gaps[:10]]}


def traced(driver, calls: int) -> Reading:
    """Run `calls` more calls under the profiler, the last ending in a
    synchronize, and read the trace."""
    spans = driver.spans = []
    act = torch.profiler.ProfilerActivity
    on_card = driver.device.type == "cuda"
    with torch.profiler.profile(
            activities=[act.CUDA if on_card else act.CPU]) as prof:
        lo = time.time_ns()
        for _ in range(calls):
            driver.call()
        with replay.span(spans, "sync"):
            replay.sync(driver.device)
        hi = time.time_ns()
    driver.spans = None
    return read(prof.profiler.kineto_results.events(), calls, lo, hi, spans)


def read(events, calls: int, lo: int, hi: int, spans) -> Reading:
    cuda = torch.autograd.DeviceType.CUDA
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in events if e.device_type() == cuda]
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in dev
              if b > lo and a < hi]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for a, b, n in inside:
        by_name[n][0] += 1
        by_name[n][1] += (b - a) * 1e-9
    busy, gaps = union(sorted((a, b) for a, b, _ in inside), lo, hi)
    labelled = sorted(((label(g, spans), (g[1] - g[0]) * 1e-9)
                       for g in gaps), key=lambda x: -x[1])
    return Reading(calls=calls, window_s=(hi - lo) * 1e-9,
                   busy_s=busy * 1e-9,
                   device_s=sum(t for _, t in by_name.values()),
                   ops=len(inside), outside=len(dev) - len(inside),
                   by_name={k: (c, t) for k, (c, t) in by_name.items()},
                   gaps=labelled)


def union(iv, lo, hi):
    """Covered length of sorted intervals, and the gaps between them
    within [lo, hi]."""
    busy, gaps, end = 0, [], lo
    for a, b in iv:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if end < hi:
        gaps.append((end, hi))
    return busy, gaps


def label(gap, host) -> str:
    """The benchmark span that overlaps `gap` most, or "other"."""
    best, most = "other", 0
    for a, b, n in host:
        o = min(b, gap[1]) - max(a, gap[0])
        if o > most:
            best, most = n, o
    return best
