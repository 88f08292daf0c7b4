"""Batched window solving on one device: B independent sliding-window
problems (different sequences, or different time windows of one) solved
by one call (PyTorch port of `ctrlvio_tpu/parallel/batch.py`).

`torch.func.vmap` over `lm.solve_window_fixed` turns each dense step of the
window solve into one batched operation over the B lanes, so the host
dispatches about as many device operations for B windows as for one. The
fixed-count loop freezes each lane once it has converged, which is what
the JAX package's vmapped while loop does. Sharding the batch over a mesh
of devices is not ported yet.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
from torch.func import vmap

from ctrlvio_tpu_torch.solver import lm
from ctrlvio_tpu_torch.solver.layout import SolveOptions, WindowConfig


def stack(items: Sequence):
    """Stack a list of equal-shaped (nested) named tuples of tensors, or of
    tensors, into one with a leading batch axis."""
    first = items[0]
    if isinstance(first, tuple):
        return type(first)(*(stack(f) for f in zip(*items)))
    return torch.stack(list(items))


def make_batched_solver(cfg: WindowConfig, opts: SolveOptions):
    """Returns `solve(params_b, img_b, imu_b, bias_b, prior_b, fixed_b,
    ext, gravity, imu_info, sqrt_info_img) -> (params_b, SolveStats_b)`:
    `lm.solve_window_fixed` over the leading batch axis of the first six
    arguments (`stack`), the last four shared by every lane."""
    return vmap(partial(lm.solve_window_fixed, cfg=cfg, opts=opts),
                in_dims=(0,) * 6 + (None,) * 4)
