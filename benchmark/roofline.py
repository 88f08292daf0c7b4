"""Peaks of the card and the least time of the hand kernels the per-layer
metrics read, from the cell's shapes alone (the benchmark's own copy of the
arithmetic of `chip_smoke.py::factor_bound_ms` and of its per-slot
operation estimates).

A kernel's bound counts each input byte read once and each output byte
written once, over the HBM rate, or its operations over the card's rate for
the dtype; the larger is the bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W limit
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                                   "float32_flop_per_s": 67e12,
                                   "float64_flop_per_s": 34e12}}
# operations a factor slot, estimated from `csrc/factors.cu`: K2 ~2.1k for
# each of its two observation times, ~0.6k for the residual and its
# blocks, ~2 a row entry (2 x C); K3 12 dual passes of ~0.7k dual
# operations (~3 real operations each) and ~2 a row entry (6 x C)
K2_OPS_SLOT = 6000
K3_OPS_SLOT = 28000
# the streamed blob's index dtype (int64) and a mask's bool
INDEX_BYTES = 8
MASK_BYTES = 1


def columns(w: dict) -> int:
    return 6 * w["KW"] + 6 * w["NB"] + 1


def k2_bytes(w: dict, f: int, lanes: int = 1) -> int:
    """`image_factor_rows` (K2) on `lanes` windows of shape `w` in a float
    of `f` bytes: a lane's knots, inverse depths, line delay and factor
    slots read, its rows, weighted residuals, landmark columns and costs
    written; the extrinsics and the weight read once."""
    Q, KW, LM = w["OBS"], w["KW"], w["LM"]
    lane_in = (KW * 7 + LM + 1) * f \
        + Q * (2 * (INDEX_BYTES + f + f + 3 * f) + INDEX_BYTES + MASK_BYTES)
    lane_out = Q * (2 * columns(w) + 2 + 2 + 1) * f
    return lanes * (lane_in + lane_out) + (4 + 3 + 1) * f


def k3_bytes(w: dict, f: int, lanes: int = 1) -> int:
    """`imu_factor_rows` (K3): a lane's knots, biases and IMU slots read,
    its rows, residuals and costs written; gravity and the IMU weights
    read once."""
    M, KW, NB = w["MIMU"], w["KW"], w["NB"]
    lane_in = (KW * 7 + NB * 6) * f \
        + M * (INDEX_BYTES + f + 3 * f + 3 * f + INDEX_BYTES + MASK_BYTES)
    lane_out = M * (6 * columns(w) + 6 + 1) * f
    return lanes * (lane_in + lane_out) + (3 + 6) * f


def bound_s(byts: int, ops: float, dtype: str, kind: str) -> float:
    peak = PEAKS[kind]
    return max(byts / peak["hbm_bytes_per_s"],
               ops / peak[f"{dtype}_flop_per_s"])


def k2_bound_s(w: dict, dtype: str, lanes: int, kind: str) -> float:
    f = 8 if dtype == "float64" else 4
    return bound_s(k2_bytes(w, f, lanes), K2_OPS_SLOT * w["OBS"] * lanes,
                   dtype, kind)


def k3_bound_s(w: dict, dtype: str, lanes: int, kind: str) -> float:
    f = 8 if dtype == "float64" else 4
    return bound_s(k3_bytes(w, f, lanes), K3_OPS_SLOT * w["MIMU"] * lanes,
                   dtype, kind)
