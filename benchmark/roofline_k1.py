"""K1's least time at the image cell's shapes: the benchmark's own copy of
`chip_smoke.py::k1_bound_ms` for the front end's fused forward-backward
track (`csrc/lk.cu`, `lk_track`).

A track of N features over L pyramid levels is 2L level-passes (the
forward pass and the backward one). A level-pass's bound is the larger of
its bytes at the HBM rate (each feature's two (21+2)^2 float patches read,
its point and guess read, its outputs written) and its operations at the
float32 rate (each of the 21x21 patch pixels: ~91 operations of the
template phase, ~22 an iteration).
"""

from __future__ import annotations

from benchmark.roofline import PEAKS

HALF = 10
K1_OPS_TEMPLATE = 91
K1_OPS_ITER = 22


def level_bound_s(n: int, iters: int, kind: str) -> float:
    """One level-pass of `n` features, `iters` iterations, on `kind`."""
    peak = PEAKS[kind]
    ops = n * (2 * HALF + 1) ** 2 * (K1_OPS_TEMPLATE + iters * K1_OPS_ITER)
    byts = n * (2 * (2 * HALF + 3) ** 2 * 4 + 4 * 4 + 3 * 4)
    return max(ops / peak["float32_flop_per_s"],
               byts / peak["hbm_bytes_per_s"])


def track_bound_s(n: int, levels: float, iters: int, kind: str) -> float:
    """The whole track: 2 `levels` level-passes."""
    return 2 * levels * level_bound_s(n, iters, kind)
