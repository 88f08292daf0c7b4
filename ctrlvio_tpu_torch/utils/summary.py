"""Residual summary + profiling hooks (the port's counterpart of
`ctrlvio_tpu/utils/summary.py`).

≙ ResidualSummary (`estimator/trajectory_estimator.h:37-59` of the
reference, printed after each solve) — the reference's de-facto regression
signal — and a torch.profiler trace for device-side inspection (the
reference's TicToc timers are `utils/spans.py`'s spans).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict

import numpy as np


@dataclass
class ResidualSummary:
    """Per-factor-type residual statistics for one solve."""

    stats: Dict[str, tuple] = field(default_factory=dict)

    @staticmethod
    def from_linearization(lin, cfg) -> "ResidualSummary":
        r = lin.r
        if hasattr(r, "detach"):  # a tensor, on any device
            r = r.detach().cpu().numpy()
        r = np.asarray(r)
        Ri, Rm = 2 * cfg.OBS, 6 * cfg.MIMU
        Rb = 6 * (cfg.NB - 1)
        out = ResidualSummary()

        def add(name, block, dim):
            block = block.reshape(-1, dim)
            norms = np.linalg.norm(block, axis=1)
            nz = norms[norms > 0]
            if len(nz):
                out.stats[name] = (len(nz), float(nz.mean()), float(nz.max()))
            else:
                out.stats[name] = (0, 0.0, 0.0)

        add("image", r[:Ri], 2)
        add("imu", r[Ri : Ri + Rm], 6)
        add("bias", r[Ri + Rm : Ri + Rm + Rb], 6)
        add("prior", r[Ri + Rm + Rb :], len(r) - Ri - Rm - Rb)
        return out

    def report(self) -> str:
        lines = ["[ResidualSummary] (count, mean |r|, max |r|)"]
        for k, (n, mean, mx) in self.stats.items():
            lines.append(f"  {k:>6}: n={n:5d} mean={mean:10.4f} max={mx:10.4f}")
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """torch.profiler trace context over the host and, when a card is
    present, the card: on exit the trace is written to `logdir` as a
    Chrome trace (`trace.json`; open in chrome://tracing or Perfetto).
    Yields the profiler."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
