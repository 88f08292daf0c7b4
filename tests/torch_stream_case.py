"""One streamed frame's inputs for the megastep tests, built with the port's
numpy modules only (no JAX), so that the gpu-marked test can use it where
JAX is absent: a small window of a synthetic sequence (KW=16, NB=5, LM=32,
OBS=96, MIMU=64), a perturbed device state, two appended knots to seed by
the in-graph dead-reckoning, a landmark slot permutation with fresh slots,
and a non-trivial prior."""

import numpy as np
import torch

from ctrlvio_tpu_torch.estimator import packing, stream
from ctrlvio_tpu_torch.ops import factors as F
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver import layout, marginalize
from ctrlvio_tpu_torch.utils.convert import from_numpy, tensor

CFG = layout.WindowConfig(KW=16, NB=5, LM=32, OBS=96, MIMU=64)
N_TRACKS = 24  # <= LM, and at most 4 observation pairs each: <= OBS
OPTS = dict(max_iters=12, tol=1e-3)


def build_case(marg_old: bool, seed: int = 7):
    """Numpy inputs of one megastep: state params and prior (lists of
    arrays in WindowParams / PriorFactor order), the blob, the host
    directives and the constants."""
    sim = synthetic.generate(synthetic.reference_noise(
        duration=1.6, n_landmarks=250, seed=seed))
    dt_ns = int(round(CFG.dt * 1e9))
    frames = sim.frames[2 : 2 + CFG.NB]
    kf = np.array([f.t_ns for f in frames], np.int64)
    win0 = int(kf[0] // dt_ns)
    rng = np.random.default_rng(seed)

    q_CtoI = so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64))
    R_CtoI = so3np.quat_to_matrix(q_CtoI[None])[0]
    p_CinI = np.array(sim.cfg.ext_pos, np.float64)
    tracks = {}
    for fidx, fr in enumerate(frames):
        for k, lid in enumerate(fr.ids):
            tr = tracks.get(lid)
            if tr is None:
                if len(tracks) >= N_TRACKS:
                    continue
                tr = tracks[lid] = packing.FeatureTrack(int(lid), fidx)
            elif tr.end_frame != fidx - 1:
                continue
            tr.pts.append(fr.pts[k])
            tr.rows.append(float(fr.rows[k]))
    true_depth = []
    for lid, tr in tracks.items():
        t_row = (kf[tr.start_frame] * 1e-9
                 + tr.rows[0] * sim.cfg.line_delay)
        q, p = sim.pose_at(t_row)
        R = so3np.quat_to_matrix(q[None])[0]
        X_c = R_CtoI.T @ (R.T @ (sim.landmarks[lid] - p) - p_CinI)
        true_depth.append(X_c[2])
        tr.estimated_depth = X_c[2] * (1.0 + 0.1 * rng.normal())
    img, dinv_seed, _ = packing.pack_image_factors(
        list(tracks.values()), kf, CFG.dt, win0, CFG, np.float64)
    t_hor = int(kf[-1] + 0.04e9)
    n_active = int(np.ceil(t_hor / dt_ns)) + 3 - win0
    imu = packing.pack_imu_factors(
        sim.imu_t_ns, sim.gyro, sim.accel, kf, win0 * dt_ns,
        (win0 + n_active - 3) * dt_ns, CFG.dt, win0, CFG, np.float64,
        on_overflow="subsample")
    bias = packing.bias_sqrt_info(sim.imu_t_ns, kf, 2e-5, 4e-4, CFG,
                                  np.float64)

    # the device state: true knots perturbed, the two newest knots stale
    # copies of the one before (what the in-graph extension replaces)
    KW, LM = CFG.KW, CFG.LM
    kq = sim.knots_q[win0 : win0 + KW].copy()
    kp = sim.knots_p[win0 : win0 + KW].copy()
    old_hi = n_active - 2
    kq = so3np.boxplus(kq, rng.normal(size=(KW, 3)) * 1e-3)
    kp = kp + rng.normal(size=(KW, 3)) * 1e-3
    kq[old_hi:] = kq[old_hi - 1]
    kp[old_hi:] = kp[old_hi - 1]
    # slot permutation: every 4th slot fresh (takes the host seed), the
    # others persist from another device slot holding the depth to 5 %
    perm = np.where(np.arange(LM) % 4 == 3, -1, (np.arange(LM) + 5) % LM)
    dinv_dev = rng.uniform(0.1, 0.5, LM)
    for i, d in enumerate(true_depth):
        if perm[i] >= 0:
            dinv_dev[perm[i]] = (1.0 + 0.05 * rng.normal()) / d
    state = [kq, kp, rng.normal(size=(CFG.NB, 3)) * 1e-3,
             rng.normal(size=(CFG.NB, 3)) * 1e-2, dinv_dev,
             np.float64(sim.cfg.line_delay * 0.7)]

    seed_mask = np.zeros(KW, bool)
    seed_mask[max(old_hi - 3, 4) : n_active] = True
    k1 = int(kf[1] // dt_ns) - win0
    drop = np.zeros(KW, bool)
    knot_shift = 0
    if marg_old:
        drop[:k1] = True
        knot_shift = k1
    fixed = np.ones(KW, bool)
    fixed[:n_active] = False
    g0 = packing.grid_of(kf[0:1], CFG.dt, win0)
    g1 = packing.grid_of(kf[1:2], CFG.dt, win0)
    blob = stream.pack_stream_blob(
        img, imu, bias, fixed, sim.knots_q[win0 : win0 + KW],
        sim.knots_p[win0 : win0 + KW], seed_mask, perm, dinv_seed, drop,
        marg_old, knot_shift, (g0[0][0], g0[1][0]), (g1[0][0], g1[1][0]),
        old_hi=old_hi, new_hi=n_active, host_seeds=False, dtype=np.float64)

    consts = dict(ext=[q_CtoI, p_CinI], gravity=sim.gravity_vec.copy(),
                  info=np.array([250.0] * 3 + [12.5] * 3),
                  w=np.float64(800.0))
    # a prior of this window itself at the true state, its first keyframe
    # interval dropped (square-root form, f64, the port's)
    drop_prior = np.zeros(KW, bool)
    drop_prior[:k1] = True
    t = lambda x: tensor(x, "cpu", torch.float64)
    dinv_true = np.full(LM, 0.2)
    dinv_true[: len(true_depth)] = 1.0 / np.asarray(true_depth)
    truth = [sim.knots_q[win0 : win0 + KW], sim.knots_p[win0 : win0 + KW],
             np.zeros((CFG.NB, 3)), np.zeros((CFG.NB, 3)), dinv_true,
             np.float64(sim.cfg.line_delay)]
    prior = marginalize.build_prior_sqrt(
        layout.WindowParams(*(t(x) for x in truth)),
        from_numpy(img, "cpu", torch.float64),
        from_numpy(imu, "cpu", torch.float64),
        from_numpy(bias, "cpu", torch.float64),
        layout.empty_prior(CFG, torch.float64), tensor(drop_prior),
        F.CamExtrinsics(t(q_CtoI), t(p_CinI)), t(consts["gravity"]),
        t(consts["info"]), t(consts["w"]), CFG,
        layout.SolveOptions(cauchy_c=1.0))
    prior = [x.numpy() for x in prior]
    return dict(state=state, prior=prior, blob=blob, marg_old=marg_old,
                knot_shift=knot_shift, consts=consts, n_active=n_active,
                old_hi=old_hi)


def port_args(case, device, dtype):
    """(positional, keyword) arguments of the port's megastep for `case`,
    as tensors on `device` in `dtype`."""
    t = lambda x: tensor(x, device, dtype)
    c = case["consts"]
    state = stream.DevState(
        params=layout.WindowParams(*(t(x) for x in case["state"])),
        prior=layout.PriorFactor(*(t(x) for x in case["prior"])))
    args = (state, t(case["blob"]), F.CamExtrinsics(t(c["ext"][0]),
                                                    t(c["ext"][1])),
            t(c["gravity"]), t(c["info"]), t(c["w"]), CFG,
            layout.SolveOptions(**OPTS))
    return args, dict(marg_old=case["marg_old"],
                      knot_shift=case["knot_shift"], host_seeds=False)


def run_port(case, device, dtype):
    """The port's megastep on `device` in `dtype`. Returns (DevState,
    summary)."""
    args, kw = port_args(case, device, dtype)
    return stream.megastep(*args, **kw)
