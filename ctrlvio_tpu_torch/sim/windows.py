"""A solve window of `bench.py`'s default sequence, for holding the factor
kernels (K2, K3) to their plain versions and timing them at the shapes the
estimator gives them: `chip_smoke.py`'s `factor_kernels` phase, the gpu
tests and `tools/factor_geometry.py`; and an LM state and trial at a
window's shapes in the accept step's cases, for K4 (`accept_case`:
`chip_smoke.py`'s `lm_accept` phase and the tests)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ctrlvio_tpu_torch.estimator import packing
from ctrlvio_tpu_torch.ops.lm_kernels import LMState
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.ops.factors import CamExtrinsics
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver.layout import (SolveOptions, WindowConfig,
                                             WindowParams)
from ctrlvio_tpu_torch.utils.convert import from_numpy, tensor

# the windows the factor kernels are held and timed at: the e2e phase's
# estimator window and the batch phase's (`sim/tiny.py`'s KW = 48)
FACTOR_WINDOWS = {
    "e2e": WindowConfig(KW=32, NB=11, LM=256, OBS=768, MIMU=256),
    "batch": WindowConfig(KW=48, NB=11, LM=256, OBS=768, MIMU=512)}


@functools.lru_cache(maxsize=1)
def e2e_sequence():
    """The e2e phase's sequence (`reference_noise(duration=12,
    n_landmarks=300, seed=3)`), made once a process."""
    return synthetic.generate(synthetic.reference_noise(
        duration=12.0, n_landmarks=300, seed=3, speed=1.0))


def factor_window(cfg, dtype, device, seed=7):
    """A window of the e2e sequence at `cfg`: its first NB frames as
    keyframes, every track packed from its first frame, the IMU samples
    from the first keyframe to 40 ms past the last, perturbed as
    `tests/test_torch_solver.py::build_problem` perturbs its window (depths
    by 20 %, the active knots by 0.02 rad and 0.02 m, biases, the line
    delay at 0.7 of its value; `seed` draws them). Returns (params, img,
    imu, ext, gravity, imu_info, sqrt_info_img) on `device` in `dtype`
    (indices int64, as the estimator uploads them)."""
    sim = e2e_sequence()
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
    q_CtoI = so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64))
    R_CtoI = so3np.quat_to_matrix(q_CtoI[None])[0]
    p_CinI = np.array(sim.cfg.ext_pos)
    rng = np.random.default_rng(seed)
    for lid, tr in tracks.items():
        t_row = (kf_t_ns[tr.start_frame] * 1e-9
                 + tr.rows[0] * sim.cfg.line_delay)
        q, p = sim.pose_at(t_row)
        R = so3np.quat_to_matrix(q[None])[0]
        X_c = R_CtoI.T @ (R.T @ (sim.landmarks[lid] - p) - p_CinI)
        tr.estimated_depth = X_c[2] * (1.0 + 0.2 * rng.normal())
    npdt = np.float64 if dtype == torch.float64 else np.float32
    img, dinv0, _ = packing.pack_image_factors(
        list(tracks.values()), kf_t_ns, cfg.dt, 0, cfg, dtype=npdt)
    t_hor = int(kf_t_ns[-1] + 0.04e9)
    imu = packing.pack_imu_factors(sim.imu_t_ns, sim.gyro, sim.accel,
                                   kf_t_ns, int(kf_t_ns[0]), t_hor, cfg.dt,
                                   0, cfg, dtype=npdt)
    n_active = int(np.ceil(t_hor * 1e-9 / cfg.dt)) + 3
    dq = rng.normal(size=(cfg.KW, 3)) * 0.02
    dp = rng.normal(size=(cfg.KW, 3)) * 0.02
    dq[:4] = dp[:4] = 0.0
    dq[n_active:] = dp[n_active:] = 0.0

    def t(x):
        return tensor(np.asarray(x, np.float64), device, dtype)

    params = WindowParams(
        knots_q=t(so3np.boxplus(sim.knots_q[: cfg.KW], dq)),
        knots_p=t(sim.knots_p[: cfg.KW] + dp),
        bg=t(rng.normal(size=(cfg.NB, 3)) * 1e-3),
        ba=t(rng.normal(size=(cfg.NB, 3)) * 1e-2), dinv=t(dinv0),
        ld=t(sim.cfg.line_delay * 0.7))
    ext = CamExtrinsics(q_CtoI=t(q_CtoI), p_CinI=t(p_CinI))
    return (params, from_numpy(img, device, dtype),
            from_numpy(imu, device, dtype), ext, t(sim.gravity_vec),
            t([250.0] * 3 + [12.5] * 3), t(800.0))


# the accept step's cases: the state's cost, lambda and done, the trial's
# cost and `tol` (the accepted count 3 and the iteration count 4 of
# `max_iters` 12 in every case)
ACCEPT_CASES = {
    "accepted": dict(cost=10.0, cost_t=8.0, lam=1e-4, done=False, tol=1e-2),
    "rejected": dict(cost=10.0, cost_t=12.0, lam=1e-4, done=False, tol=1e-2),
    "done": dict(cost=10.0, cost_t=8.0, lam=1e-4, done=True, tol=1e-2),
    "nan_cost_t": dict(cost=10.0, cost_t=float("nan"), lam=1e-4, done=False,
                       tol=1e-2),
    "inf_cost_t": dict(cost=10.0, cost_t=-float("inf"), lam=1e-4,
                       done=False, tol=1e-2),
    # rel_dec exactly tol (not below it: not done); and exactly tol
    # rounded to float32 (0.7 rounds down: below tol in double, not done
    # in float32, as torch and JAX compare)
    "rel_dec_at_tol": dict(cost=1.0, cost_t=0.75, lam=1e-4, done=False,
                           tol=0.25),
    "rel_dec_at_f32_tol": dict(cost=1.0, cost_t=0.3, lam=1e-4, done=False,
                               tol=0.7),
    "converged": dict(cost=10.0, cost_t=9.99, lam=1e-4, done=False,
                      tol=1e-2),
    # lambda down past 1e-10 and up past 1e8
    "lam_floor": dict(cost=10.0, cost_t=8.0, lam=1.5e-10, done=False,
                      tol=1e-2),
    "lam_ceiling": dict(cost=10.0, cost_t=12.0, lam=5e7, done=False,
                        tol=1e-2)}
ACCEPT_N_ACC, ACCEPT_ITERS, ACCEPT_MAX_ITERS = 3, 4, 12


def accept_shapes(cfg: WindowConfig):
    """The LM state's leaves' shapes at `cfg`: the window parameters
    (knots_q, knots_p, bg, ba, dinv, ld) and the normal equations (H, g,
    h_ll, g_l, H_cl)."""
    C = cfg.C
    return [(cfg.KW, 4), (cfg.KW, 3), (cfg.NB, 3), (cfg.NB, 3), (cfg.LM,),
            (), (C, C), (C,), (cfg.LM,), (cfg.LM,), (cfg.LM, C)]


def accept_case(cfg: WindowConfig, dtype, device, case="accepted", seed=0):
    """An LM state and a trial at `cfg`'s shapes in `dtype` on `device`,
    their leaves drawn from `seed`, their scalars `ACCEPT_CASES[case]`'s.
    Returns (state, trial params, trial normal equations, trial cost,
    SolveOptions with the case's tol and `ACCEPT_MAX_ITERS`)."""
    c = ACCEPT_CASES[case]
    rng = np.random.default_rng(seed)
    npdt = np.float64 if dtype == torch.float64 else np.float32

    def draw():
        return [torch.from_numpy(rng.normal(size=s).astype(npdt)).to(device)
                for s in accept_shapes(cfg)]

    state, trial = draw(), draw()
    scalar = lambda x, dt=dtype: torch.tensor(x, dtype=dt, device=device)  # noqa: E731
    st = LMState(WindowParams(*state[:6]), tuple(state[6:]),
                 scalar(c["cost"]), scalar(c["lam"]),
                 scalar(ACCEPT_N_ACC, torch.int64),
                 scalar(c["done"], torch.bool),
                 scalar(ACCEPT_ITERS, torch.int64))
    opts = SolveOptions(max_iters=ACCEPT_MAX_ITERS, tol=c["tol"])
    return (st, WindowParams(*trial[:6]), tuple(trial[6:]),
            scalar(c["cost_t"]), opts)
