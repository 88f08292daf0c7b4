"""The port's trajectory export, checkpoints and residual summary against
the JAX package, on the CPU: `export_tum` writes the same text;
`ResidualSummary.from_linearization` gives the same statistics for the
same residual vector; a checkpoint interchanges between the packages (the
port's own round trip restores the state exactly, and a checkpoint the
JAX package's `save_checkpoint` wrote loads into the port's `CtrlVIO` with
equal state); `CtrlVIO.residual_summary` and `debug_residual_summary`
report on a short streamed run of the port (f64, ground-truth bootstrap);
and, slow, the residual summary equals the JAX package's on the same
restored state to 1e-9 relative."""

import contextlib
import io
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ctrlvio_tpu.estimator.odometry import CtrlVIO as JCtrlVIO
from ctrlvio_tpu.estimator.odometry import VIOConfig as JVIOConfig
from ctrlvio_tpu.solver.layout import WindowConfig as JWindowConfig
from ctrlvio_tpu.utils import export as jexport
from ctrlvio_tpu.utils import summary as jsummary
from ctrlvio_tpu_torch.estimator.initializer import bootstrap_from_sim
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver.layout import WindowConfig
from ctrlvio_tpu_torch.utils import export, summary
from tests.torch_parity import close, one_torch_thread  # noqa: F401

WINDOW = dict(KW=24, NB=6, LM=96, OBS=384, MIMU=192)
STATE = ("kf_t_ns", "bg", "ba", "gravity", "imu_t_ns", "imu_gyro",
         "imu_accel", "data_start_ns", "win_knot0", "initialized")


def test_export_tum_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    t = 1_500_000_000_000_000_000 + np.arange(30, dtype=np.int64) * 20_000_000
    q = rng.normal(size=(30, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p = rng.normal(size=(30, 3)) * 10
    export.export_tum(str(tmp_path / "a.tum"), t, q, p)
    jexport.export_tum(str(tmp_path / "b.tum"), t, q, p)
    assert (tmp_path / "a.tum").read_text() == (tmp_path / "b.tum").read_text()


def test_residual_summary_from_linearization_matches_jax():
    wc = WindowConfig(**WINDOW)
    rng = np.random.default_rng(1)
    n = 2 * wc.OBS + 6 * wc.MIMU + 6 * (wc.NB - 1) + wc.C
    r = rng.normal(size=n)
    r[: 2 * wc.OBS][rng.random(2 * wc.OBS) < 0.5] = 0.0  # empty slots
    r[2 * wc.OBS + 6 * 100 : 2 * wc.OBS + 6 * wc.MIMU] = 0.0
    ref = jsummary.ResidualSummary.from_linearization(
        SimpleNamespace(r=r), JWindowConfig(**WINDOW))
    for rr in (r, torch.tensor(r)):
        out = summary.ResidualSummary.from_linearization(
            SimpleNamespace(r=rr), wc)
        assert out.stats == ref.stats
        assert out.report() == ref.report()
    assert ref.stats["imu"][0] == 100


@pytest.fixture(scope="module")
def run():
    """The port's streaming CtrlVIO (f64, CPU, 3 warmup frames, lag 1) from
    the ground-truth bootstrap through 16 frames with
    debug_residual_summary on; returns the sim, the estimator after
    flush() and what it printed on stderr."""
    sim = synthetic.generate(synthetic.reference_noise(
        duration=2.2, n_landmarks=150, seed=19))
    vio = make_vio(sim, stream=True, stream_warmup=3, stream_lag=1,
                   stream_consume_every=1, debug_residual_summary=True)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        init = bootstrap_from_sim(sim)
        for k in range(len(sim.imu_t_ns)):
            vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
        vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                              init.gravity, v0=init.v)
        for fr in sim.frames[:16]:
            vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
        vio.flush()
    return sim, vio, err.getvalue()


def make_vio(sim, **kw):
    cfg = VIOConfig(window_config=WindowConfig(**WINDOW), dtype=torch.float64,
                    fix_ld=False, **kw)
    return CtrlVIO(cfg, so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64)),
                   np.array(sim.cfg.ext_pos), device="cpu")


def make_jax_vio(sim):
    cfg = JVIOConfig(window_config=JWindowConfig(**WINDOW), dtype=np.float64,
                     fix_ld=False, use_native=False)
    return JCtrlVIO(cfg, so3np.quat_exp(np.array(sim.cfg.ext_rot,
                                                 np.float64)),
                    np.array(sim.cfg.ext_pos))


def same_state(a, b):
    """Two estimators (either package) hold the same restored state."""
    n = a.traj.n
    assert b.traj.n == n
    np.testing.assert_array_equal(a.traj.knots_q[:n], b.traj.knots_q[:n])
    np.testing.assert_array_equal(a.traj.knots_p[:n], b.traj.knots_p[:n])
    assert a.traj.line_delay == b.traj.line_delay
    for k in STATE:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    for x, y in zip(a.prior, b.prior):
        y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        np.testing.assert_array_equal(x, y)


def test_debug_residual_summary_reports_sync_and_stream(run):
    sim, vio, err = run
    assert vio.counts["megastep"] >= 5 and vio.counts["sync_solve"] == 3
    # one full report per synchronous frame, one line per summary batch
    # the host mirror consumed (flush() takes the unfetched tail as one)
    assert err.count("[ResidualSummary] (count, mean |r|, max |r|)") == 3
    lines = [ln for ln in err.splitlines()
             if ln.startswith("[ResidualSummary/stream] image=")]
    assert 3 <= len(lines) <= vio.counts["megastep"]
    s = vio.residual_summary()
    assert set(s.stats) == {"image", "imu", "bias", "prior"}
    assert s.stats["image"][0] > 50 and s.stats["imu"][0] > 50
    assert all(np.isfinite(v).all() for v in s.stats.values())


def test_checkpoint_round_trip_and_jax_interchange(run, tmp_path):
    sim, vio, _ = run
    ck = str(tmp_path / "port.npz")
    export.save_checkpoint(ck, vio)
    # the port's own round trip
    back = export.load_checkpoint(ck, make_vio(sim))
    same_state(vio, back)
    assert back.prior.J.dtype == torch.float64 and back._prior64 is None
    q1, p1 = vio.traj.pose(vio.kf_t_ns)
    q2, p2 = back.traj.pose(back.kf_t_ns)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(q1, q2)
    # written by the JAX package's save_checkpoint, loaded by the port
    jvio = jexport.load_checkpoint(ck, make_jax_vio(sim))
    ck_j = str(tmp_path / "jax.npz")
    jexport.save_checkpoint(ck_j, jvio)
    same_state(jvio, export.load_checkpoint(ck_j, make_vio(sim)))
    same_state(vio, export.load_checkpoint(ck_j, make_vio(sim)))
    # the TUM export of both from the same state
    export.export_vio_trajectory(str(tmp_path / "a.tum"), back)
    jexport.export_vio_trajectory(str(tmp_path / "b.tum"), jvio)
    assert (tmp_path / "a.tum").read_text() == \
        (tmp_path / "b.tum").read_text()


@pytest.mark.slow
def test_residual_summary_matches_jax_on_restored_state(run, tmp_path):
    """The IMU, bias and prior statistics of both packages'
    residual_summary on the same restored state (feature tracks are not
    checkpointed, so the image block is empty in both). Slow: the JAX
    package compiles its linearization on the CPU."""
    sim, vio, _ = run
    ck = str(tmp_path / "state.npz")
    export.save_checkpoint(ck, vio)
    out = export.load_checkpoint(ck, make_vio(sim)).residual_summary()
    ref = jexport.load_checkpoint(ck, make_jax_vio(sim)).residual_summary()
    assert set(out.stats) == set(ref.stats)
    for k in ref.stats:
        assert out.stats[k][0] == ref.stats[k][0], k
        close(ref.stats[k][1:], out.stats[k][1:])
    assert ref.stats["image"][0] == 0 and ref.stats["imu"][0] > 50


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with summary.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof is not None
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
