"""A solve window of `bench.py`'s default sequence, for holding the factor
kernels (K2, K3) and the residual summary (K5, `summary_window`: the window
with bias pairs and a prior) to their plain versions and timing them at the
shapes the estimator gives them: `chip_smoke.py`'s `factor_kernels` phase,
the gpu tests and `tools/factor_geometry.py`; and an LM state and trial at
a window's shapes in the accept step's cases, for K4 (`accept_case`:
`chip_smoke.py`'s `lm_accept` phase and the tests); the QR prior's rows,
for K6 (`qr_prior_case`); and the front end's state over two views of a
rigid scene, for the F-gate K7 (`fgate_case`)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ctrlvio_tpu_torch.estimator import packing
from ctrlvio_tpu_torch.ops.lm_kernels import LMState
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.ops.factors import CamExtrinsics
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver.layout import (BiasFactors, PriorFactor,
                                             SolveOptions, WindowConfig,
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


def summary_window(cfg, dtype, device, seed=7, window=None):
    """`factor_window`'s window (or `window`, one it made at `seed`) with
    what else the residual summary reads:
    its keyframes' bias pairs (`packing.bias_sqrt_info` at the reference's
    random walks, every fourth pair masked) and a prior drawn from `seed`
    (J upper triangular over its first two thirds of rows, the rest zero,
    as a marginalization's QR factor with dropped coordinates leaves it;
    r0 on the same rows; the linearization point near the parameters).
    Returns (params, img, imu, bias, prior, ext, gravity, imu_info,
    sqrt_info_img)."""
    params, img, imu, ext, grav, info, w = window or factor_window(
        cfg, dtype, device, seed)
    sim = e2e_sequence()
    kf_t_ns = np.array([f.t_ns for f in sim.frames[: cfg.NB]], np.int64)
    si = packing.bias_sqrt_info(sim.imu_t_ns, kf_t_ns, 2e-5, 4e-4, cfg,
                                dtype=np.float64).sqrt_info
    rng = np.random.default_rng(seed + 1000)
    C, n = cfg.C, 2 * cfg.C // 3
    J = np.triu(rng.normal(size=(C, C)) * 0.1)
    J[n:] = 0.0
    r0 = np.r_[rng.normal(size=n) * 0.1, np.zeros(C - n)]

    def t(x):
        return tensor(np.asarray(x, np.float64), device, dtype)

    bias = BiasFactors(sqrt_info=t(si), valid=torch.tensor(
        np.arange(cfg.NB - 1) % 4 != 3, device=device))
    q0 = so3np.boxplus(params.knots_q.double().cpu().numpy(),
                       rng.normal(size=(cfg.KW, 3)) * 0.01)
    prior = PriorFactor(
        J=t(J), r0=t(r0), knots_q0=t(q0),
        knots_p0=params.knots_p - t(rng.normal(size=(cfg.KW, 3)) * 0.01),
        bg0=params.bg * 0.5, ba0=params.ba * 0.5, ld0=params.ld * 0.9)
    return params, img, imu, bias, prior, ext, grav, info, w


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


# the QR prior's (K6's) shapes: the marginalization caps (MOBS, MIMU, MLM),
# NB - 1 = 10 bias pairs and C = 259 window columns (KW = 32, NB = 11): the
# estimator's default caps, as chip_smoke.py's e2e and serve lines run them
# (2,242 x 388 assembled), and the benchmark cell's (4,674 x 516)
QR_PRIOR_SHAPES = {
    "e2e": dict(MOBS=384, MIMU=128, NBM1=10, C=259, MLM=128),
    "cell": dict(MOBS=1536, MIMU=128, NBM1=10, C=259, MLM=256)}


def qr_prior_case(shape, dtype, device, seed=0, n_drop=2, landmarks=None,
                  imu_live=0.3, lost=0.05):
    """The inputs of `ops/qr_prior.py::qr_prior_r` at `shape` (a dict of
    `QR_PRIOR_SHAPES`' form), drawn from `seed`: image rows non-zero on
    ~10 % of the columns, 90 % of the obs active and the rest zero (as
    `assemble.linearize` zeroes them), a share `lost` of the active obs
    on a landmark that lost its compact slot (row_ok 0: not live, their
    rows left non-zero), the live obs on the first `landmarks` slots (the
    rest empty; default 60 % of MLM), a share `imu_live` of the IMU slots
    live, the first bias pair live, dense old-prior rows, `n_drop` dropped
    knots (6 n_drop + 6 dropped columns). Returns (the wrapper's keyword
    arguments, row_ok (MOBS,) in `dtype`)."""
    MOBS, MIMU, NBM1, C, MLM = (shape[k] for k in
                                ("MOBS", "MIMU", "NBM1", "C", "MLM"))
    rng = np.random.default_rng(seed)
    R = 2 * MOBS + 6 * MIMU + 6 * NBM1 + C
    J = rng.normal(size=(R, C))
    J[:2 * MOBS] *= rng.random((2 * MOBS, C)) < 0.1
    J[2 * MOBS + 6 * MIMU + 6 * NBM1:] *= 0.1
    r = rng.normal(size=R)
    J_lm = rng.normal(size=(MOBS, 2))
    act = rng.random(MOBS) < 0.9
    n_lm = max(1, int(0.6 * MLM)) if landmarks is None else landmarks
    new_idx = np.where(act, rng.integers(0, n_lm, MOBS),
                       rng.integers(0, MLM, MOBS))
    won = rng.random(MOBS) >= lost
    live_imu = rng.random(MIMU) < imu_live
    live_bias = np.arange(NBM1) == 0
    row = np.r_[np.repeat(act, 2), np.repeat(live_imu, 6),
                np.repeat(live_bias, 6), np.ones(C, bool)]
    J *= row[:, None]
    r *= row
    J_lm *= act[:, None]
    row_ok = (~act) | won
    rm = np.r_[np.repeat(row_ok, 2), np.ones(R - 2 * MOBS)]
    cs_c = np.linalg.norm(J * rm[:, None], axis=0)
    cs_c = np.where(cs_c > 1e-12, cs_c, 1.0)
    drop = np.zeros(C, bool)
    drop[rng.permutation(C)[:6 * n_drop + 6]] = True
    order = np.argsort(~drop, kind="stable")

    def t(x, dt=dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                            dtype=dt)

    kw = dict(J=t(J), r=t(r), J_lm=t(J_lm), new_idx=t(new_idx, torch.int64),
              live_img=t(act & won, torch.bool),
              live_imu=t(live_imu, torch.bool),
              live_bias=t(live_bias, torch.bool), cs_c=t(cs_c),
              order=t(order, torch.int64), keep_from=6 * n_drop + 6, MLM=MLM,
              eps=3e-4 if dtype == torch.float32 else 1e-7)
    return kw, t(row_ok)


# the F-gate's (K7's) cases: what the second view's points carry besides
# the rigid motion
FGATE_KINDS = ("clean", "outliers", "tie", "cluster")


def fgate_case(N, n, kind, seed, device="cpu"):
    """The inputs of `ops/fgate.py::fgate` (without the table and the
    threshold) over N slots, n of them tracks common to both frames
    (tracked, published before, not suppressed), drawn from `seed`: their
    points two views of a rigid scene (x in [-2, 2], y in [-1.5, 1.5],
    depth 3 to 9 m, from the identity and from a pose 0.4 m and 0.06 rad
    away) in normalized coordinates, the second with 0.3 px of noise (at
    the gate's 460 px focal length) and, by `kind`: nothing more
    ("clean"); 30 % of them moved 23 to 92 px ("outliers"); 0.6 px of
    noise, so that many tracks lie near a 1 px threshold and hypotheses
    tie ("tie"); the quarter nearest a point moved together by (2.3, 9.2)
    px, across the epipolar lines, a rigid cluster moving against the
    scene ("cluster"). The other slots: tracked but not published before,
    suppressed, refilled after a suppression, or dead, at random, with
    points of their own. Returns a
    dict of (N, 2) float32 `norm`, `prev_norm` and (N,) bool `tracked`,
    `refilled`, `live`, `prev_pub`, `suppress`."""
    if kind not in FGATE_KINDS:
        raise ValueError(f"fgate_case: kind {kind!r} is not one of "
                         f"{FGATE_KINDS}")
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(3, 9, n)], axis=1)
    th = 0.06
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                  [-np.sin(th), 0, np.cos(th)]])
    X1 = (X - np.array([0.4, 0.05, 0.1])) @ R
    p0, p1 = X[:, :2] / X[:, 2:3], X1[:, :2] / X1[:, 2:3]
    px = 1.0 / 460.0
    p1 = p1 + rng.normal(0, (0.6 if kind == "tie" else 0.3) * px, p1.shape)
    if kind == "outliers":
        k = rng.random(n) < 0.3
        ang = rng.uniform(0, 2 * np.pi, k.sum())
        r = rng.uniform(0.05, 0.2, k.sum())
        p1[k] += np.stack([np.cos(ang), np.sin(ang)], axis=1) * r[:, None]
    elif kind == "cluster":
        near = np.argsort(np.linalg.norm(p0 - p0[rng.integers(n)], axis=1))
        p1[near[: max(n // 4, 1)]] += np.array([0.005, 0.02])
    slots = rng.permutation(N)
    same = np.zeros(N, bool)
    same[np.sort(slots[:n])] = True
    other = rng.integers(0, 4, N)  # 0 new, 1 suppressed, 2 refilled, 3 dead
    tracked = same | (~same & (other < 2))
    prev_pub = same | (~same & (other == 1)) | (~same & (other == 2)
                                                 & (rng.random(N) < 0.5))
    suppress = ~same & ((other == 1) | (other == 2)
                        | ((other == 3) & (rng.random(N) < 0.5)))
    refilled = ~same & (other == 2)
    prev_norm = rng.uniform(-0.6, 0.6, (N, 2))
    norm = prev_norm + rng.normal(0, 0.01, (N, 2))
    prev_norm[same], norm[same] = p0, p1

    def t(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                            dtype=dt)

    return dict(norm=t(norm, torch.float32), prev_norm=t(prev_norm,
                                                         torch.float32),
                tracked=t(tracked, torch.bool), refilled=t(refilled,
                                                           torch.bool),
                live=t(tracked | refilled, torch.bool),
                prev_pub=t(prev_pub, torch.bool),
                suppress=t(suppress, torch.bool))
