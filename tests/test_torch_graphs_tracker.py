"""The estimator's f64 bootstrap BA as a program, on the CPU through the
test-only replay stand-in (`tests/torch_graph_standin.py`), against the
eager run: equal bit for bit. Also a short sequence through the
synchronous estimator at the default LM depths, whose replayed solves skip
the iterations after convergence (the stand-in models the WHILE node of
`graphs.run_while`), and the bootstrap's timing keys."""

import numpy as np
import pytest
import torch

from ctrlvio_tpu_torch.estimator import odometry
from ctrlvio_tpu_torch.estimator.odometry import (CtrlVIO, VIOConfig,
                                                  blob_unpack, window_solve)
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver import gauge, lm
from ctrlvio_tpu_torch.utils import graphs
from tests.torch_graph_standin import (WHILE_COUNTS, assert_same_estimate,
                                       captured, replayed_programs, run)
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    """A 1.6 s sequence (seed 12) through the synchronous estimator at the
    default LM depths (ba_iters 12, predict_iters 8), eagerly and with its
    programs replayed; the replayed run also records the bootstrap
    program's inputs and output and the IF bodies run and skipped."""
    torch.set_num_threads(1)
    s = synthetic.generate(synthetic.reference_noise(
        duration=1.6, n_landmarks=250, seed=12))
    kw = dict(ba_iters=12, predict_iters=8)
    eager = run(s, **kw)
    boot = []
    solve = odometry.window_solve

    def spy(blob, prior, *rest, **static):
        out = solve(blob, prior, *rest, **static)
        if static["opts"].tol == 0.0 and static["restore"]:
            boot.append((graphs.clone((blob, prior, rest)), static,
                         out.clone()))
        return out

    with replayed_programs():
        odometry.window_solve = spy
        try:
            got = run(s, **kw)
        finally:
            odometry.window_solve = solve
        counts, keys = dict(WHILE_COUNTS), captured()
    return eager, got, counts, keys, boot


def test_replayed_estimator_skips_what_it_froze(runs):
    """Some window solves converge before 12; the replayed run equals the
    eager one bit for bit, with the same iteration counts, and its
    programs ran exactly the bodies of the iterations before each solve's
    `iters` and skipped the rest."""
    (vio_e, poses_e, _, _), (vio_r, poses_r, _, _), counts, _, _ = runs
    assert np.array_equal(poses_r, poses_e)
    assert_same_estimate(vio_r, vio_e)
    its, rec = vio_r.lm_iters(), vio_r.lm_iters_record()
    assert its == vio_e.lm_iters()
    assert min(its["sync"]) < 12
    most = rec["max_iters"]
    assert counts["run"] == sum(n - 1 for v in its.values() for n in v)
    assert counts["skipped"] == sum(most[k] - n for k, v in its.items()
                                    for n in v)


def test_bootstrap_program_equals_host_exit_solve(runs):
    """The f64 bootstrap BA ran once, as its own program (`window_solve`
    in f64 at tol 0, `init_ba_iters` iterations, all executed), and its
    output equals the host-exit `lm.solve_window` on the same inputs with
    the same gauge restore, bit for bit; the bootstrap's timing keys are
    recorded."""
    _, (vio, _, _, _), _, keys, boot = runs
    assert "window_solve(bootstrap, float64)" in keys
    # the warm-up, the stand-in's capture and the replay each ran it; the
    # last is the replay
    (blob, prior, (ext, grav, info, w)), static, got = boot[-1]
    assert len(boot) == 3 and keys.count(
        "window_solve(bootstrap, float64)") == 1
    assert blob.dtype == torch.float64
    cfg, opts = static["cfg"], static["opts"]
    assert opts.max_iters == vio.cfg.init_ba_iters
    img, imu, bias, params, fixed, _ = blob_unpack(blob, cfg)
    p, st = lm.solve_window(params, img, imu, bias, prior, fixed, ext, grav,
                            info, w, cfg, opts, ne_mode=static["ne_mode"],
                            chunk=static["chunk"])
    q, pos = gauge.restore_gauge(p.knots_q, p.knots_p, params.knots_q[0],
                                 params.knots_p[0], 0, 0)
    ref = torch.cat([q.reshape(-1), pos.reshape(-1), p.bg.reshape(-1),
                     p.ba.reshape(-1), p.dinv, p.ld.reshape(1),
                     torch.stack([st.cost0, st.cost]).to(q.dtype)])
    assert torch.equal(got[: ref.numel()], ref)
    assert int(got[-1]) == int(st.iters) == opts.max_iters
    assert vio.lm_iters()["bootstrap"] == [opts.max_iters]
    for k in ("boot_predict", "boot_solve", "boot_prior"):
        assert vio.timing[k] > 0.0, k


def test_visual_bootstrap_times_its_initializer():
    """With the visual bootstrap, the initializer's time (IMU and frames
    fed to the SfM) is `timing["vio_init"]`."""
    vio = CtrlVIO(VIOConfig(bootstrap="visual", use_native=False),
                  np.array([1.0, 0.0, 0.0, 0.0]), np.zeros(3), device="cpu")
    for k in range(20):
        vio.process_imu(k * 5_000_000, np.zeros(3), np.array([0, 0, 9.81]))
    vio.process_frame(50_000_000, np.arange(3), np.zeros((3, 2)),
                      np.zeros(3))
    assert vio.timing["vio_init"] > 0.0 and not vio.initialized
