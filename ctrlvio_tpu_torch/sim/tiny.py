"""A small sliding-window problem from a synthetic sequence: the window
that `bench.py --mode batch` solves B copies of (port of
`__graft_entry__._tiny_problem`).

Eleven keyframes of a 2 s sequence (60 landmarks, 10 Hz camera, 100 Hz
IMU), every track packed from its first frame with a depth guess of 3 m,
every IMU sample of the window, the ground-truth knots as the starting
point, the first four knots and those past the active span fixed, and an
empty prior.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ctrlvio_tpu_torch.estimator import packing
from ctrlvio_tpu_torch.ops import factors as F
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver.layout import (BiasFactors, ImageFactors,
                                             ImuFactors, PriorFactor,
                                             WindowConfig, WindowParams,
                                             empty_prior)
from ctrlvio_tpu_torch.utils.convert import from_numpy, tensor
from ctrlvio_tpu_torch.utils.device import resolve_device


class TinyProblem(NamedTuple):
    cfg: WindowConfig
    params: WindowParams
    img: ImageFactors
    imu: ImuFactors
    bias: BiasFactors
    fixed: torch.Tensor               # (KW,) bool
    aux: tuple                        # (ext, gravity, imu_info, sqrt_info_img)
    prior: PriorFactor


def tiny_problem(dtype=torch.float32, cfg: Optional[WindowConfig] = None,
                 device="cuda") -> TinyProblem:
    """The window, as tensors on `device` (the card unless the caller asks
    for the CPU) in `dtype`. `cfg` defaults to KW=32, NB=11, LM=64,
    OBS=256, MIMU=256; MIMU must hold every IMU sample of the window."""
    dev = resolve_device(device)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    cfg = cfg or WindowConfig(KW=32, NB=11, LM=64, OBS=256, MIMU=256, dt=0.05)
    sim = synthetic.generate(synthetic.SimConfig(
        duration=2.0, n_landmarks=60, cam_rate=10.0, imu_rate=100.0, seed=1))
    frames = sim.frames[: cfg.NB]
    kf_t_ns = np.array([f.t_ns for f in frames], dtype=np.int64)

    tracks = {}
    for fidx, fr in enumerate(frames):
        for k, lid in enumerate(fr.ids):
            tr = tracks.get(lid)
            if tr is None:
                tr = tracks[lid] = packing.FeatureTrack(int(lid), fidx)
            elif tr.end_frame != fidx - 1:
                continue
            tr.pts.append(fr.pts[k])
            tr.rows.append(float(fr.rows[k]))
    for tr in tracks.values():
        tr.estimated_depth = 3.0

    img, dinv0, _ = packing.pack_image_factors(
        list(tracks.values()), kf_t_ns, cfg.dt, 0, cfg, dtype=npdt)
    t_hi = int(kf_t_ns[-1] + 0.04e9)
    imu = packing.pack_imu_factors(sim.imu_t_ns, sim.gyro, sim.accel,
                                   kf_t_ns, 0, t_hi, cfg.dt, 0, cfg,
                                   dtype=npdt)
    bias = packing.bias_sqrt_info(sim.imu_t_ns, kf_t_ns, 2e-5, 4e-4, cfg,
                                  dtype=npdt)

    # knots padded to KW if the sequence is shorter than the window
    kq = np.concatenate([sim.knots_q,
                         np.tile(sim.knots_q[-1], (cfg.KW, 1))])[: cfg.KW]
    kp = np.concatenate([sim.knots_p,
                         np.tile(sim.knots_p[-1], (cfg.KW, 1))])[: cfg.KW]

    def t(x):
        return tensor(np.asarray(x, npdt), dev, dtype)

    params = WindowParams(knots_q=t(kq), knots_p=t(kp),
                          bg=t(np.zeros((cfg.NB, 3))),
                          ba=t(np.zeros((cfg.NB, 3))), dinv=t(dinv0),
                          ld=t(0.0))
    n_active = int(np.ceil(t_hi / (cfg.dt * 1e9))) + 3
    fixed = np.zeros(cfg.KW, bool)
    fixed[:4] = True
    fixed[n_active:] = True
    ext = F.CamExtrinsics(
        q_CtoI=t(so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64))),
        p_CinI=t(np.array(sim.cfg.ext_pos)))
    aux = (ext, t(sim.gravity_vec), t([250.0] * 3 + [12.5] * 3), t(800.0))
    return TinyProblem(cfg, params, from_numpy(img, dev, dtype),
                       from_numpy(imu, dev, dtype),
                       from_numpy(bias, dev, dtype), tensor(fixed, dev), aux,
                       empty_prior(cfg, dtype, dev))
