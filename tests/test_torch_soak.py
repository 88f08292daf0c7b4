"""Long-horizon f32 stream soak through the port on the CPU, under
reference-level sensor noise (the port of `tests/test_soak.py`): the f32
streaming pipeline must not accumulate drift against the f64 synchronous
path over ~3.4 window spans, and the line delay must calibrate online
from 0. The JAX test's gates, and the port's f32 stream against the JAX
package's f64 synchronous oracle on the same 6 s prefix. Slow, like the
original."""

import numpy as np
import pytest
import torch

from ctrlvio_tpu_torch.estimator.initializer import bootstrap_from_sim
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver.layout import WindowConfig
from ctrlvio_tpu_torch.utils.ate import ate_rmse
from tests.torch_parity import one_torch_thread  # noqa: F401

DURATION = 11.0  # ~3.4x the window span


def _run(stream: bool, dtype, sim=None, n_frames=None):
    """`tests/test_soak.py::_run` through the port (CPU)."""
    if sim is None:
        sim = synthetic.generate(synthetic.reference_noise(
            duration=DURATION, n_landmarks=250, seed=21))
    cfg = VIOConfig(
        window_config=WindowConfig(KW=32, NB=11, LM=192, OBS=768, MIMU=256),
        fix_ld=False, ld_init=0.0, dtype=dtype, stream=stream,
        stream_lag=4, stream_warmup=12)
    vio = CtrlVIO(cfg, so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64)),
                  np.array(sim.cfg.ext_pos), device="cpu")
    init = bootstrap_from_sim(sim)
    for k in range(len(sim.imu_t_ns)):
        vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    t_frames, online = [], []
    for fr in sim.frames[:n_frames]:
        out = vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
        if out is not None:
            t_frames.append(fr.t_ns)
            online.append(out[1])
    vio.flush()
    gt = np.stack([sim.pose_at(t * 1e-9)[1] for t in t_frames])
    return sim, vio, np.asarray(online), gt


@pytest.mark.slow
def test_f32_stream_soak_no_compounding_drift():
    """The JAX test's gates on the port's f32 stream: every error after
    the lag ramp < 15 cm, late-horizon RMS < 4x mid-horizon + 2 cm, final
    line-delay error < 2 us, and within 5 cm of the f64 synchronous
    oracle on a 60-frame prefix: the port's own, and the JAX package's."""
    from tests.test_soak import _run as jax_run

    sim, vio32, est32, gt = _run(stream=True, dtype=torch.float32)
    assert vio32.counts["megastep"] > 0
    err = np.linalg.norm(est32[10:] - gt[10:], axis=1)
    assert err.max() < 0.15, f"max err {err.max():.3f} m"
    n = len(err)
    mid = np.sqrt((err[n // 4 : n // 2] ** 2).mean())
    late = np.sqrt((err[3 * n // 4 :] ** 2).mean())
    assert late < 4.0 * mid + 0.02, (f"drift compounds: mid {mid:.4f} m "
                                     f"-> late {late:.4f} m")
    assert abs(vio32.traj.line_delay - sim.cfg.line_delay) < 2e-6

    for oracle in (lambda: _run(stream=False, dtype=torch.float64, sim=sim,
                                n_frames=60),
                   lambda: jax_run(stream=False, dtype=np.float64, sim=sim,
                                   n_frames=60)):
        est64 = oracle()[2]
        n64 = len(est64)
        gap = ate_rmse(est32[10:n64], est64[10:], align="none")
        assert gap < 0.05, f"f32-stream vs f64-sync gap {gap:.4f} m"
