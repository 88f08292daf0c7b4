"""Parity of the PyTorch port's window solver with the JAX package, float64
on the CPU: layout, linearization, normal equations (dense and chunked),
the damped Schur solve, LM (including its exit rule and the Cholesky
failure path), the gauge restore and the marginalization
prior as an input. Same numpy-built window problem through both; <= 1e-9
relative (1e-8 or 1e-7 where a solve or LM iterations amplify rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlvio_tpu.estimator import packing as jpacking
from ctrlvio_tpu.ops import factors as JF
from ctrlvio_tpu.ops import so3np
from ctrlvio_tpu.sim import synthetic
from ctrlvio_tpu.solver import assemble as jasm
from ctrlvio_tpu.solver import gauge as jgauge
from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu.solver import lm as jlm
from ctrlvio_tpu_torch.solver import assemble as tasm
from ctrlvio_tpu_torch.solver import gauge as tgauge
from ctrlvio_tpu_torch.solver import layout as tlayout
from ctrlvio_tpu_torch.solver import lm as tlm
from ctrlvio_tpu_torch.solver import marginalize as tmarg
from ctrlvio_tpu_torch.utils.convert import from_numpy, tensor
from tests.torch_parity import close, one_torch_thread  # noqa: F401

CFG = jlayout.WindowConfig(KW=24, NB=6, LM=64, OBS=320, MIMU=192, dt=0.05)
TCFG = tlayout.WindowConfig(*CFG)


def jx(nt):
    return jax.tree_util.tree_map(jnp.asarray, nt)


def tt(nt):
    return from_numpy(nt, "cpu")


def build_problem(seed=7):
    """A perturbed single-window problem from a short synthetic sequence
    (numpy only): knots, factors, inverse depths, extrinsics."""
    sim = synthetic.generate(synthetic.SimConfig(
        duration=1.6, n_landmarks=250, seed=seed))
    frames = sim.frames[: CFG.NB]
    kf_t_ns = np.array([f.t_ns for f in frames], dtype=np.int64)
    tracks = {}
    for fidx, fr in enumerate(frames):
        for k, lid in enumerate(fr.ids):
            tr = tracks.get(lid)
            if tr is None:
                tr = jpacking.FeatureTrack(int(lid), fidx)
                tracks[lid] = tr
            elif tr.end_frame != fidx - 1:
                continue
            tr.pts.append(fr.pts[k])
            tr.rows.append(float(fr.rows[k]))
    q_CtoI = so3np.quat_exp(np.array(sim.cfg.ext_rot))
    R_CtoI = so3np.quat_to_matrix(q_CtoI[None])[0]
    p_CinI = np.array(sim.cfg.ext_pos)
    rng = np.random.default_rng(seed)
    for lid, tr in tracks.items():
        t_row = kf_t_ns[tr.start_frame] * 1e-9 + tr.rows[0] * sim.cfg.line_delay
        q, p = sim.pose_at(t_row)
        R = so3np.quat_to_matrix(q[None])[0]
        X_c = R_CtoI.T @ (R.T @ (sim.landmarks[lid] - p) - p_CinI)
        tr.estimated_depth = X_c[2] * (1.0 + 0.2 * rng.normal())
        # every other track anchored at frame 0 enters the marginalization
    img, dinv0, _ = jpacking.pack_image_factors(
        list(tracks.values()), kf_t_ns, CFG.dt, 0, CFG, dtype=np.float64)
    t_hor = int(kf_t_ns[-1] + 0.04e9)
    imu = jpacking.pack_imu_factors(sim.imu_t_ns, sim.gyro, sim.accel,
                                    kf_t_ns, 0, t_hor, CFG.dt, 0, CFG,
                                    dtype=np.float64)
    bias = jpacking.bias_sqrt_info(sim.imu_t_ns, kf_t_ns, 2e-5, 4e-4, CFG,
                                   dtype=np.float64)
    n_active = int(np.ceil(t_hor * 1e-9 / CFG.dt)) + 3
    dq = rng.normal(size=(CFG.KW, 3)) * 0.02
    dp = rng.normal(size=(CFG.KW, 3)) * 0.02
    dq[:4] = dp[:4] = 0.0
    dq[n_active:] = dp[n_active:] = 0.0
    params = jlayout.WindowParams(
        knots_q=so3np.boxplus(sim.knots_q[: CFG.KW], dq),
        knots_p=sim.knots_p[: CFG.KW] + dp,
        bg=rng.normal(size=(CFG.NB, 3)) * 1e-3,
        ba=rng.normal(size=(CFG.NB, 3)) * 1e-2,
        dinv=np.asarray(dinv0, np.float64),
        ld=np.float64(sim.cfg.line_delay * 0.7))
    fixed = np.ones(CFG.KW, bool)
    fixed[:n_active] = False
    ext = JF.CamExtrinsics(q_CtoI=q_CtoI, p_CinI=p_CinI)
    k1 = int(kf_t_ns[1] // int(CFG.dt * 1e9))
    return dict(params=params, img=img, imu=imu, bias=bias, fixed=fixed,
                ext=ext, gravity=sim.gravity_vec.copy(),
                info=np.array([250.0] * 3 + [12.5] * 3), w=np.float64(800.0),
                k1=k1)


@pytest.fixture(scope="module")
def prob():
    pb = build_problem()
    assert pb["img"].valid.sum() > 100 and (pb["img"].valid
                                            & pb["img"].marg_drop).sum() > 10
    # a non-trivial prior, fed as numpy to both packages: the f64
    # marginalization of the problem itself (the port's, which
    # test_torch_marginalize.py holds to the JAX package's)
    drop = np.zeros(CFG.KW, bool)
    drop[: pb["k1"]] = True
    pb["drop"] = drop
    p, img, imu, bias = (tt(pb[k]) for k in ("params", "img", "imu", "bias"))
    prior = tmarg.build_prior(
        p, img, imu, bias, tlayout.empty_prior(TCFG, torch.float64),
        tensor(drop), tt(pb["ext"]), tensor(pb["gravity"]),
        tensor(pb["info"]), tensor(pb["w"]), TCFG,
        tlayout.SolveOptions(cauchy_c=1.0))
    pb["prior"] = jlayout.PriorFactor(*(x.numpy() for x in prior))
    return pb


def args(pb, side, prior=True):
    conv = jx if side == "jax" else tt
    arr = jnp.asarray if side == "jax" else (lambda x: tensor(x))
    p = conv(pb["prior"]) if prior else (
        jlayout.empty_prior(CFG, jnp.float64) if side == "jax"
        else tlayout.empty_prior(TCFG, torch.float64))
    return (conv(pb["params"]), conv(pb["img"]), conv(pb["imu"]),
            conv(pb["bias"]), p, conv(pb["ext"]), arr(pb["gravity"]),
            arr(pb["info"]), arr(pb["w"]))


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def test_layout_retract_boxminus_mask(prob):
    rng = np.random.default_rng(3)
    delta = rng.normal(size=CFG.C) * 1e-2
    opts = jlayout.SolveOptions(ld_upper=3.5e-5)
    jp = jlayout.retract(jx(prob["params"]), jnp.asarray(delta), CFG, opts)
    tp = tlayout.retract(tt(prob["params"]), tensor(delta), TCFG,
                         tlayout.SolveOptions(*opts))
    for a, b in zip(jp, tp):
        close(a, b)
    pr = prob["prior"]
    close(jlayout.boxminus_full(jp, *jx(pr)[2:], CFG),
          tlayout.boxminus_full(tp, *tt(pr)[2:], TCFG))
    for o in (opts, opts._replace(lock_bias=True, fix_ld=True)):
        close(jlayout.column_mask(CFG, o, jnp.asarray(prob["fixed"])),
              tlayout.column_mask(TCFG, tlayout.SolveOptions(*o),
                                  tensor(prob["fixed"]), torch.float64))


# ---------------------------------------------------------------------------
# linearization and normal equations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("marg_mode", [False, True])
def test_linearize(prob, marg_mode):
    opts = jlayout.SolveOptions()
    a = jasm.linearize(*args(prob, "jax"), CFG, opts, marg_mode=marg_mode)
    b = tasm.linearize(*args(prob, "torch"), TCFG, tlayout.SolveOptions(),
                       marg_mode=marg_mode)
    for x, y in zip(a, b):
        close(x, y)


@pytest.mark.parametrize("chunk", [None, 64])
def test_accumulate_normal_equations(prob, chunk):
    opts = jlayout.SolveOptions()
    ja = args(prob, "jax")
    ta = args(prob, "torch")
    a = jasm.accumulate_normal_equations(
        ja[0], ja[1], ja[2], ja[3], *ja[5:], CFG, opts, chunk=chunk or 0)
    b = tasm.accumulate_normal_equations(
        ta[0], ta[1], ta[2], ta[3], *ta[5:], TCFG, tlayout.SolveOptions(),
        chunk=chunk)
    for x, y in zip(a, b):
        close(x, y)


def test_chunked_matches_dense_normal_equations(prob):
    """The chunked accumulation equals linearize + build_normal_equations
    (no prior, all columns free)."""
    ta = args(prob, "torch", prior=False)
    opts = tlayout.SolveOptions()
    H, g, h_ll, g_l, H_cl, cost = tasm.accumulate_normal_equations(
        ta[0], ta[1], ta[2], ta[3], *ta[5:], TCFG, opts)
    lin = tasm.linearize(*ta, TCFG, opts)
    ne = tlm.build_normal_equations(lin, TCFG,
                                    torch.ones(TCFG.C, dtype=torch.float64))
    for x, y in zip((H, g, h_ll, g_l, H_cl, cost), ne + (lin.cost,)):
        close(y.numpy(), x, rtol=1e-8)


@pytest.mark.parametrize("fn", ["residual_rms", "total_cost"])
def test_residual_rms_and_total_cost(prob, fn):
    a = getattr(jasm, fn)(*args(prob, "jax"), CFG, jlayout.SolveOptions())
    b = getattr(tasm, fn)(*args(prob, "torch"), TCFG, tlayout.SolveOptions())
    close(a, b)


def _ne(prob, side):
    cm = np.ones(CFG.C)
    cm[np.repeat(prob["fixed"], 3).nonzero()[0]] = 0.0
    cm[3 * CFG.KW:6 * CFG.KW][np.repeat(prob["fixed"], 3)] = 0.0
    if side == "jax":
        lin = jasm.linearize(*args(prob, "jax"), CFG, jlayout.SolveOptions())
        return jlm.build_normal_equations(lin, CFG, jnp.asarray(cm)), cm
    lin = tasm.linearize(*args(prob, "torch"), TCFG, tlayout.SolveOptions())
    return tlm.build_normal_equations(lin, TCFG, tensor(cm)), cm


def test_build_normal_equations_and_schur_solve(prob):
    ja, cm = _ne(prob, "jax")
    tb, _ = _ne(prob, "torch")
    for x, y in zip(ja, tb):
        close(x, y)
    for lam in (1e-4, 10.0):
        dx_j = jlm.schur_solve(*ja, jnp.asarray(lam), jnp.asarray(cm))
        dx_t = tlm.schur_solve(*tb, torch.tensor(lam, dtype=torch.float64),
                               tensor(cm))
        for x, y in zip(dx_j, dx_t):
            close(x, y, rtol=1e-8)


def test_schur_solve_cholesky_failure_gives_nan(prob):
    """An indefinite system: JAX's Cholesky yields NaN, and so does the
    port's (cholesky_ex info != 0 mapped to NaN)."""
    ja, cm = _ne(prob, "jax")
    tb, _ = _ne(prob, "torch")
    H_bad = np.asarray(ja[0]).copy()
    H_bad[5, 5] = -1e6
    dx_j, _ = jlm.schur_solve(jnp.asarray(H_bad), *ja[1:], jnp.asarray(1e-4),
                              jnp.asarray(np.ones(CFG.C)))
    dx_t, dl_t = tlm.schur_solve(tensor(H_bad), *tb[1:],
                                 torch.tensor(1e-4, dtype=torch.float64),
                                 torch.ones(CFG.C, dtype=torch.float64))
    assert np.isnan(np.asarray(dx_j)).all()
    assert torch.isnan(dx_t).all() and torch.isnan(dl_t).any()


@pytest.mark.parametrize("pitch", [0.3, np.pi / 2 - 1e-3])
def test_restore_gauge(prob, pitch):
    kq = np.asarray(prob["params"].knots_q)
    kp = np.asarray(prob["params"].knots_p)
    ref_q = so3np.quat_exp(np.array([0.2, pitch, 0.4]))
    ref_p = np.array([0.3, -0.2, 1.0])
    a = jgauge.restore_gauge(jnp.asarray(kq), jnp.asarray(kp),
                             jnp.asarray(ref_q), jnp.asarray(ref_p), 0, 2)
    b = tgauge.restore_gauge(tensor(kq), tensor(kp), tensor(ref_q),
                             tensor(ref_p), 0, 2)
    for x, y in zip(a, b):
        close(x, y)
