"""The JAX package's image-in main path with either marginalization
precision, as the reference for `chip_smoke.py`'s `main` and
`main_marg_dev` lines: `bench.py --mode image --scene blobs` as the
`main` phase runs it (4 s of rendered 1280x1024 Kannala-Brandt
rolling-shutter frames, seed 3, FusedTracker with lag=0, the synchronous
CtrlVIO in float32 from the ground-truth bootstrap), on the CPU with the
plain LK (`use_pallas=False`) and `VIOConfig(marg_on_host=...)`.

    JAX_PLATFORMS=cpu python tests/torch_marg_dev_ref.py --marg-on-host 0

Prints one JSON line: ATE (yaw-aligned from the 11th solved frame, as the
bench), line-delay error, solved frames, the solved frame whose prior
first held a non-finite entry (None if none did), the LM steps accepted
from that frame on, and the host ms a frame of the `prior` phase."""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--marg-on-host", type=int, choices=(0, 1), default=0)
    ap.add_argument("--duration", type=float, default=4.0)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from ctrlvio_tpu.estimator.initializer import bootstrap_from_sim
    from ctrlvio_tpu.estimator.odometry import CtrlVIO, VIOConfig
    from ctrlvio_tpu.frontend.fused import FusedTracker, rotation_flow
    from ctrlvio_tpu.frontend.klt import KLTConfig
    from ctrlvio_tpu.frontend.tracker import TrackerConfig
    from ctrlvio_tpu.models.cameras import Equidistant
    from ctrlvio_tpu.ops import so3np
    from ctrlvio_tpu.sim import render, synthetic
    from ctrlvio_tpu.solver.layout import WindowConfig
    from ctrlvio_tpu.utils.ate import ate_rmse

    H, W = 1024, 1280
    cam = Equidistant(  # cam_tumrs.yaml, as bench.py:412-416
        mu=739.1654756101043, mv=739.1438452683457,
        u0=625.826167006398, v0=517.3370973594253,
        k2=0.019327620961435945, k3=0.006784242994724914,
        k4=-0.008658628531456217, k5=0.0051893686731546585)
    noise = {k: v for k, v in synthetic.REFERENCE_NOISE.items()
             if k != "pixel_noise"}
    sim = synthetic.generate(synthetic.SimConfig(
        duration=args.duration, n_landmarks=1500, seed=3, image_h=H,
        image_w=W, **noise))
    imgs = render.render_sequence(sim, H, W, camera=cam, seed=1,
                                  big_every=6, texture=6.0)
    tracker = FusedTracker(TrackerConfig(
        max_cnt=150, min_dist=25, use_clahe=True, fb_check=True,
        use_pallas=False, klt=KLTConfig(pred_levels=3)), cam, (H, W), lag=0)
    vio = CtrlVIO(VIOConfig(
        window_config=WindowConfig(KW=32, NB=11, LM=256, OBS=768, MIMU=256),
        fix_ld=False, ld_init=0.0, ld_upper=3.5e-5, dtype=np.float32,
        marg_on_host=bool(args.marg_on_host)),
        so3np.quat_exp(np.asarray(sim.cfg.ext_rot, np.float64)),
        np.array(sim.cfg.ext_pos))
    R_CtoI = so3np.quat_to_matrix(vio.q_CtoI[None])[0]
    init = bootstrap_from_sim(sim)
    for k in range(len(sim.imu_t_ns)):
        vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)

    est, gt, finite, accepted = [], [], [], []
    t0 = time.perf_counter()
    for i, fr in enumerate(sim.frames):
        M = (rotation_flow(sim.imu_t_ns, sim.gyro, sim.frames[i - 1].t_ns,
                           fr.t_ns, R_CtoI) if i else None)
        feat = tracker.step(fr.t_ns, imgs[i], R_rel=M)
        if feat is None or len(feat["ids"]) < 8:
            continue
        out = vio.process_frame(feat["t_ns"], feat["ids"], feat["pts"],
                                feat["rows"])
        if out is None:
            continue
        est.append(out[1])
        gt.append(sim.pose_at(feat["t_ns"] * 1e-9)[1])
        finite.append(bool(np.isfinite(np.asarray(vio.prior.J)).all()))
        accepted.append(int(vio.last_solve_stats.accepted))
    est, gt = np.asarray(est), np.asarray(gt)
    bad = [k for k, ok in enumerate(finite) if not ok]
    first_bad = bad[0] if bad else None
    print(json.dumps({
        "package": "ctrlvio_tpu", "marg_on_host": bool(args.marg_on_host),
        "frames": len(sim.frames), "solved": len(est),
        "ate_m": float(ate_rmse(est[10:], gt[10:], align="yaw")),
        "ld_err_s": abs(vio.traj.line_delay - sim.cfg.line_delay),
        "poses_finite": bool(np.isfinite(est).all()),
        "first_nonfinite_prior": first_bad,
        "accepted_from_then": (None if first_bad is None
                               else sum(accepted[first_bad + 1:])),
        "prior_host_ms_per_frame": vio.timing["prior"] / len(est) * 1e3,
        "wall_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
