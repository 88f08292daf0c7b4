"""Parity of the PyTorch port's streaming core (`estimator/stream.py`) with
the JAX package, float64 on the CPU: the one-copy upload blob, the in-graph
dead-reckoning of appended knots, the window roll and the landmark depth
handoff, one whole megastep for each slide branch (the case of
`tests/torch_stream_case.py`), and the LM loop with no host exit against
the one that leaves the loop on the host. Tolerances are relative to the
reference's largest entry: 1e-9 where no solve runs, 1e-6 after the
megastep's LM iterations and QR (rounding amplified by the solve), 1e-6
for the dead-reckoning (a prefix scan in another association order); the
priors are compared as J^T J and J^T r0, because QR may flip row signs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlvio_tpu.estimator import stream as jstream
from ctrlvio_tpu.ops import factors as JF
from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu_torch.estimator import packing as tpacking
from ctrlvio_tpu_torch.estimator import stream as tstream
from ctrlvio_tpu_torch.ops import factors as TF
from ctrlvio_tpu_torch.sim import synthetic as tsynthetic
from ctrlvio_tpu_torch.solver import layout as tlayout
from ctrlvio_tpu_torch.solver import lm as tlm
from ctrlvio_tpu_torch.utils.convert import from_numpy, tensor
from tests.test_torch_solver import TCFG, args, prob  # noqa: F401
from tests.torch_parity import close, one_torch_thread  # noqa: F401
from tests.torch_stream_case import CFG, OPTS, build_case, run_port

JCFG = jlayout.WindowConfig(*CFG)
MEGA_RTOL = 1e-6


def jx(nt):
    return jax.tree_util.tree_map(jnp.asarray, nt)


@pytest.fixture(scope="module", params=[True, False], ids=["marg_old",
                                                           "second_new"])
def case(request):
    return build_case(request.param)


@pytest.fixture(scope="module")
def jax_megastep():
    return jax.jit(jstream.megastep, static_argnums=(6, 7))


def test_blob_round_trip(case):
    """The port packs the same buffer as the JAX package, and unpacking it
    gives back every field (integers and flags converted)."""
    blob = case["blob"]
    jt = jstream.unpack_stream_blob(jnp.asarray(blob), JCFG, jnp.float64)
    tt = tstream.unpack_stream_blob(tensor(blob, "cpu", torch.float64), CFG,
                                    torch.float64)
    sc = tt[10]
    repacked = tstream.pack_stream_blob(
        *tt[:10], bool(sc.marg_old), int(sc.knot_shift),
        (int(sc.t0_i0), float(sc.t0_f)), (int(sc.t1_i0), float(sc.t1_f)),
        int(sc.old_hi), int(sc.new_hi), bool(sc.host_seeds),
        dtype=np.float64)
    assert repacked.tobytes() == blob.tobytes()
    for a, b in zip(jax.tree_util.tree_leaves(jt),
                    [x for t in tt for x in (t if isinstance(t, tuple)
                                             else (t,))]):
        a = np.asarray(a)
        assert b.dtype == {np.dtype(np.int32): torch.int64,
                           np.dtype(np.bool_): torch.bool,
                           np.dtype(np.float64): torch.float64}[a.dtype]
        np.testing.assert_array_equal(b.numpy(), a)


def test_roll_clamp():
    a = np.random.default_rng(0).normal(size=(9, 4))
    for shift in (0, 1, 3, 8):
        close(jstream._roll_clamp(jnp.asarray(a), jnp.asarray(shift)),
              tstream._roll_clamp(tensor(a, "cpu"), shift))


def test_depth_handoff(case):
    """Re-anchored inverse depths of the landmarks leaving with the oldest
    keyframe, from the case's state and factors."""
    dinv = case["state"][4]
    c = case["consts"]
    jp = jlayout.WindowParams(*(jnp.asarray(x) for x in case["state"]))
    tp = tlayout.WindowParams(*(tensor(x, "cpu", torch.float64)
                                for x in case["state"]))
    ju = jstream.unpack_stream_blob(jnp.asarray(case["blob"]), JCFG,
                                    jnp.float64)
    tu = tstream.unpack_stream_blob(tensor(case["blob"], "cpu",
                                           torch.float64), CFG, torch.float64)
    jext = JF.CamExtrinsics(*(jnp.asarray(x) for x in c["ext"]))
    text = TF.CamExtrinsics(*(tensor(x, "cpu", torch.float64)
                              for x in c["ext"]))
    dj = jax.jit(jstream._depth_handoff, static_argnums=4)(
        jp, ju[0], ju[10], jext, JCFG)
    dt = tstream._depth_handoff(tp, tu[0], tu[10], text, CFG)
    moved = np.asarray(dj) != dinv
    assert moved.sum() >= 3  # some landmarks are re-anchored
    close(dj, dt)


def test_extend_inertial():
    """`tests/test_stream_extend.py`'s window: a stale tail after old_hi,
    seeds dead-reckoned from the anchor knots through new_hi."""
    sim = tsynthetic.generate(tsynthetic.SimConfig(
        duration=4.0, n_landmarks=30, seed=3))
    cfg = tlayout.WindowConfig(KW=32, NB=11, LM=8, OBS=8, MIMU=256, dt=0.05)
    w0, old_hi, new_hi = 10, 20, 22
    dt_ns = int(0.05e9)
    kq = sim.knots_q[w0 : w0 + cfg.KW].copy()
    kp = sim.knots_p[w0 : w0 + cfg.KW].copy()
    kq[old_hi:] = kq[old_hi - 1]
    kp[old_hi:] = kp[old_hi - 1]
    rng = np.random.default_rng(1)
    state = [kq, kp, rng.normal(size=(cfg.NB, 3)) * 1e-3,
             rng.normal(size=(cfg.NB, 3)) * 1e-2, np.zeros(cfg.LM),
             np.float64(0.0)]
    kf_t = np.linspace((w0 + 2) * dt_ns, (w0 + old_hi - 5) * dt_ns,
                       cfg.NB).astype(np.int64)
    t_hi_ns = int((w0 + new_hi - 3) * dt_ns)
    imu = tpacking.pack_imu_factors(
        sim.imu_t_ns, sim.gyro, sim.accel, kf_t, w0 * dt_ns,
        t_hi_ns + dt_ns, 0.05, w0, cfg, np.float64, on_overflow="subsample")
    assert imu.valid.sum() > 100

    def scalars(mod, i, f):
        return mod.StreamScalars(
            marg_old=i(True), knot_shift=i(0), t0_i0=i(0), t0_f=f(0.0),
            t1_i0=i(0), t1_f=f(0.0), old_hi=i(old_hi), new_hi=i(new_hi),
            host_seeds=i(False))

    jq, jp = jax.jit(jstream._extend_inertial, static_argnums=4)(
        jlayout.WindowParams(*(jnp.asarray(x) for x in state)), jx(imu),
        scalars(jstream, lambda v: jnp.asarray(v, jnp.int32)
                if not isinstance(v, bool) else jnp.asarray(v),
                jnp.asarray), jnp.asarray(sim.gravity_vec),
        jlayout.WindowConfig(*cfg))
    tq, tp = tstream._extend_inertial(
        tlayout.WindowParams(*(tensor(x, "cpu", torch.float64)
                               for x in state)),
        from_numpy(imu, "cpu", torch.float64),
        scalars(tstream, lambda v: torch.tensor(v), lambda v: torch.tensor(
            v, dtype=torch.float64)),
        tensor(sim.gravity_vec, "cpu", torch.float64), cfg)
    close(jq, tq, rtol=1e-6)
    close(jp, tp, rtol=1e-6)
    # the seeds reach past the stale tail
    assert np.abs(np.asarray(jp)[old_hi:new_hi] - kp[old_hi:new_hi]).max() \
        > 1e-3


def test_prefix_quat_products_keeps_order():
    """The Hillis-Steele scan multiplies earlier factors on the left."""
    from ctrlvio_tpu_torch.ops import so3 as tso3

    rng = np.random.default_rng(2)
    dq = tso3.quat_exp(tensor(rng.normal(size=(13, 3)) * 0.3, "cpu",
                              torch.float64))
    ref = [dq[0]]
    for i in range(1, 13):
        ref.append(tso3.quat_mul(ref[-1], dq[i]))
    close(torch.stack(ref).numpy(), tstream._prefix_quat_products(dq))


def test_megastep_matches_jax(case, jax_megastep):
    """One megastep of each slide branch: the next device state, the
    summary and the new prior."""
    c = case["consts"]
    st_t, sum_t = run_port(case, "cpu", torch.float64)
    jstate = jstream.DevState(
        params=jlayout.WindowParams(*(jnp.asarray(x) for x in case["state"])),
        prior=jlayout.PriorFactor(*(jnp.asarray(x) for x in case["prior"])))
    st_j, sum_j = jax_megastep(
        jstate, jnp.asarray(case["blob"]),
        JF.CamExtrinsics(*(jnp.asarray(x) for x in c["ext"])),
        jnp.asarray(c["gravity"]), jnp.asarray(c["info"]),
        jnp.asarray(c["w"]), JCFG, jlayout.SolveOptions(**OPTS))
    s_j = jstream.unpack_summary(np.asarray(sum_j), JCFG)
    s_t = tstream.unpack_summary(sum_t.numpy(), CFG)
    assert s_t["accepted"] == s_j["accepted"] >= 1
    assert s_t["cost"] < s_t["cost0"]
    for k in ("knots_q", "knots_p", "bg", "ba", "dinv", "rms", "marg_ovf"):
        close(s_j[k], s_t[k], MEGA_RTOL)
    for k in ("ld", "cost0", "cost"):
        close(s_j[k], s_t[k], MEGA_RTOL)
    for a, b in zip(st_j.params, st_t.params):
        close(a, b, MEGA_RTOL)
    Jj, rj = np.asarray(st_j.prior.J), np.asarray(st_j.prior.r0)
    Jt, rt = st_t.prior.J.numpy(), st_t.prior.r0.numpy()
    close(Jj.T @ Jj, Jt.T @ Jt, MEGA_RTOL)
    close(Jj.T @ rj, Jt.T @ rt, MEGA_RTOL)
    for a, b in zip(st_j.prior[2:], st_t.prior[2:]):
        close(a, b, MEGA_RTOL)
    if not case["marg_old"]:  # the prior rides through unchanged
        close(case["prior"][0], st_t.prior.J, 0.0)


@pytest.mark.parametrize("max_iters,tol", [(3, 0.0), (12, 1e-3),
                                           (12, 0.5)])
def test_fixed_iteration_loop_equals_host_exit_loop(prob, max_iters, tol):
    """`solve_window_fixed` (always max_iters iterations, state frozen on
    the device once done) gives the same params and statistics as
    `solve_window` (leaves the loop on the host)."""
    ta = args(prob, "torch")
    o = tlayout.SolveOptions(max_iters=max_iters, tol=tol)
    fixed = tensor(prob["fixed"])
    a, sa = tlm.solve_window(*ta[:5], fixed, *ta[5:], TCFG, o)
    b, sb = tlm.solve_window_fixed(*ta[:5], fixed, *ta[5:], TCFG, o)
    assert int(sa.accepted) == int(sb.accepted)
    if tol > 0:
        assert int(sa.accepted) < max_iters  # the host loop left early
    for x, y in [*zip(a, b), (sa.cost, sb.cost), (sa.cost0, sb.cost0),
                 (sa.lm_lambda, sb.lm_lambda)]:
        assert torch.equal(x, y)


def run_port_stream(duration=5.0, seed=11):
    """`tests/test_stream.py`'s `_run(stream=True)` through the port: f64,
    a short warmup (8 frames) and lag (4), ground-truth bootstrap."""
    from ctrlvio_tpu_torch.estimator.initializer import bootstrap_from_sim
    from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
    from ctrlvio_tpu_torch.ops import so3np

    sim = tsynthetic.generate(tsynthetic.SimConfig(
        duration=duration, n_landmarks=250, seed=seed))
    cfg = VIOConfig(
        window_config=tlayout.WindowConfig(KW=32, NB=11, LM=192, OBS=768,
                                           MIMU=256),
        fix_ld=False, ld_init=0.0, dtype=torch.float64, stream=True,
        stream_lag=4, stream_warmup=8)
    vio = CtrlVIO(cfg, so3np.quat_exp(np.array(sim.cfg.ext_rot)),
                  np.array(sim.cfg.ext_pos), device="cpu")
    init = bootstrap_from_sim(sim)
    for k in range(len(sim.imu_t_ns)):
        vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    t_frames, online = [], []
    for fr in sim.frames:
        out = vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
        if out is not None:
            t_frames.append(fr.t_ns)
            online.append(out[1])
    vio.flush()
    final = np.stack([vio.traj.pose(t)[1][0] for t in t_frames])
    gt = np.stack([sim.pose_at(t * 1e-9)[1] for t in t_frames])
    return sim, vio, np.asarray(online), final, gt


@pytest.mark.slow
def test_stream_run_matches_jax():
    """The whole streamed run of `tests/test_stream.py` through both
    packages (the port's native table against the JAX package's): the
    same solved frames and keyframes, 20 or more megasteps (the run
    makes 27 after its 8 warmup frames) and no synchronous solve after
    the handoff; final trajectories within 5 mm of each other and online
    estimates within 1 cm (two f64 chains of lagged megasteps apart); the
    line delay calibrated to the same value within 1e-8 s. Slow: the JAX
    package compiles its solves and megastep for several minutes on the
    CPU."""
    from ctrlvio_tpu.utils.ate import ate_rmse
    from tests.test_stream import _run as jax_run

    sim, jvio, j_on, j_final, gt = jax_run(stream=True)
    _, tvio, t_on, t_final, t_gt = run_port_stream()
    np.testing.assert_array_equal(gt, t_gt)
    assert tvio.counts["megastep"] >= 20
    assert tvio.counts["sync_solve_after_handoff"] == 0
    assert len(tvio.keyframes) == len(jvio.keyframes) >= 10
    assert np.linalg.norm(t_final - j_final, axis=1).max() < 0.005
    assert np.linalg.norm(t_on - j_on, axis=1)[10:].max() < 0.01
    assert abs(tvio.traj.line_delay - jvio.traj.line_delay) < 1e-8
    assert abs(tvio.traj.line_delay - sim.cfg.line_delay) < 1.5e-6
    assert ate_rmse(t_on[10:], gt[10:], align="yaw") < 0.10
