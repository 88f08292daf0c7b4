"""The port's benchmark: `bench.py`'s four modes, flags, accuracy gates and
JSON lines, run through `ctrlvio_tpu_torch` (counterpart of the
repository's `bench.py:122-760`).

    python -m ctrlvio_tpu_torch.bench [--mode e2e|image|serve|batch]
        [--preset gpu|cpu-smoke] [--gt spline|fine|lissajous] [--seed N]
        [--speed X] [--noiseless] [--bootstrap visual|gt]
        [--scene textured|blobs] [--batch-size B] [--duration S] [--profile]

`--preset gpu` (the default) runs on the card: float32 solve, the
streaming estimator in e2e and serve, the lagged front end (`lag=1`) with
the LK kernel in image. Without a card it raises: nothing falls back to
the CPU. `--preset cpu-smoke` runs on the CPU: float64, synchronous,
`lag=0` and the plain LK, at `bench.py`'s CPU durations and gates.

Each mode applies `bench.py`'s accuracy gates and exits 1 on a miss,
printing no result. On success it prints one JSON line, last on stdout,
with `bench.py`'s metric name and keys; everything else goes to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ctrlvio_tpu_torch.estimator.initializer import bootstrap_from_sim
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver.layout import SolveOptions, WindowConfig
from ctrlvio_tpu_torch.utils.ate import ate_rmse
from ctrlvio_tpu_torch.utils.device import resolve_device
from ctrlvio_tpu_torch.utils.precision import pin_f32_matmuls

ROOT = Path(__file__).resolve().parent.parent

METRIC_BY_MODE = {
    "e2e": "frames_per_sec_per_chip",
    "image": "image_frames_per_sec_per_chip",
    "batch": "batched_window_solves_per_sec",
    "serve": "served_frames_per_sec_per_chip",
}

# H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet, 700 W)
H100_F32_FLOP_PER_S = 67e12

# the streaming estimator's window in every mode but batch (`bench.py:232`)
BENCH_WINDOW = WindowConfig(KW=32, NB=11, LM=256, OBS=768, MIMU=256)
# `bench.py --mode batch`'s window and iterations (`bench.py:720-723`)
BATCH_WINDOW = WindowConfig(KW=48, NB=11, LM=256, OBS=768, MIMU=512, dt=0.05)
BATCH_ITERS = 15
BATCH_SWEEP = (1, 2, 4, 8, 16)


def build_parser() -> argparse.ArgumentParser:
    """`bench.py`'s flags, names, choices and defaults; `gpu` takes the
    place of `tpu`."""
    ap = argparse.ArgumentParser(prog="python -m ctrlvio_tpu_torch.bench")
    ap.add_argument("--preset", choices=["gpu", "cpu-smoke"], default="gpu",
                    help="gpu: the card, f32, stream (raises without a "
                         "card); cpu-smoke: the CPU, f64, synchronous")
    ap.add_argument("--mode", choices=["e2e", "image", "batch", "serve"],
                    default="e2e",
                    help="e2e: sequential replay fps; image: replay from "
                         "rendered 1280x1024 rolling-shutter imagery "
                         "(CLAHE+KLT front-end included in the fps); "
                         "batch: batched multi-window solve throughput; "
                         "serve: B full estimators streaming in lockstep "
                         "through one batched megastep")
    ap.add_argument("--batch-size", type=int, default=8,
                    help="sequences per chip for --mode serve")
    ap.add_argument("--scene", choices=["textured", "blobs"],
                    default="textured",
                    help="--mode image world: 'textured' ray-casts a "
                         "texture-mapped room (tracker finds its own "
                         "corners; occluders + photometric drift), 'blobs' "
                         "draws Gaussian dots at landmark projections")
    ap.add_argument("--duration", type=float, default=None)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--gt", choices=["spline", "fine", "lissajous"],
                    default="spline",
                    help="GT trajectory family (anti-inverse-crime "
                         "controls): 'spline' = same order-4/0.05s family "
                         "the estimator fits; 'fine' = 0.01s-knot spline "
                         "(out of the estimator's basis); 'lissajous' = "
                         "analytic C-inf curve (not a B-spline at all)")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="motion-intensity multiplier on the GT dynamics")
    ap.add_argument("--bootstrap", choices=["visual", "gt"], default="visual",
                    help="visual: full self-bootstrap (SfM + VI alignment, "
                         "like the reference); gt: ground-truth init")
    ap.add_argument("--noiseless", action="store_true",
                    help="disable sensor noise (exactness debugging). The "
                         "default injects IMU+pixel noise at the reference's "
                         "configured operating point (sigma_g=4e-3, "
                         "sigma_a=8e-2, ~1px; ct_odometry_tumrs.yaml:16-20)")
    ap.add_argument("--profile", action="store_true",
                    help="capture a torch.profiler trace of the replay "
                         "(a Chrome trace under build/bench_trace/)")
    return ap


def preset_device(preset: str) -> torch.device:
    """The preset's device: the card for `gpu` (raises without one), the
    CPU for `cpu-smoke`."""
    return resolve_device("cuda" if preset == "gpu" else "cpu")


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_line(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def emit_result(mode: str, value: float, unit: str, **extra):
    """The mode's one JSON line, last on stdout (`bench.py`'s keys)."""
    print(json.dumps({"metric": METRIC_BY_MODE[mode], "value": round(value, 2),
                      "unit": unit, "vs_baseline": round(value / 10.0, 2),
                      **extra}), flush=True)


def fail(tag: str, message: str):
    """A missed gate or a run that never initialized: say so on stderr
    and exit 1 with no result."""
    print(f"[{tag}] FAIL {message}", file=sys.stderr)
    sys.exit(1)


def started_vio(sim, cfg: VIOConfig, device="cuda") -> CtrlVIO:
    """A CtrlVIO with every IMU sample fed and the ground-truth bootstrap
    set (`bench.py:248-252`)."""
    vio = new_vio(sim, cfg, device)
    init = bootstrap_from_sim(sim)
    for k in range(len(sim.imu_t_ns)):
        vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    return vio


def new_vio(sim, cfg: VIOConfig, device="cuda") -> CtrlVIO:
    return CtrlVIO(cfg, so3np.quat_exp(np.asarray(sim.cfg.ext_rot,
                                                  np.float64)),
                   np.array(sim.cfg.ext_pos), device=device)


# ---------------------------------------------------------------------------
# e2e
# ---------------------------------------------------------------------------
def e2e_sim(args, duration: float):
    """The e2e sequence (`bench.py:222-230`): reference sensor noise unless
    `--noiseless`, 300 landmarks, the chosen ground-truth family."""
    sim_kw = dict(duration=duration, n_landmarks=300, seed=args.seed,
                  speed=args.speed)
    if args.gt == "fine":
        sim_kw["gt_knot_dt"] = 0.01
    elif args.gt == "lissajous":
        sim_kw["gt_family"] = "lissajous"
    sim_cfg = (synthetic.SimConfig(**sim_kw) if args.noiseless
               else synthetic.reference_noise(**sim_kw))
    return synthetic.generate(sim_cfg)


def e2e_config(args, on_card: bool) -> VIOConfig:
    """The e2e estimator (`bench.py:231-240`): f32 and the stream on the
    card, f64 and synchronous on the CPU."""
    return VIOConfig(
        window_config=BENCH_WINDOW, fix_ld=False, ld_init=0.0,
        dtype=torch.float32 if on_card else torch.float64,
        bootstrap=("visual" if args.bootstrap == "visual" else "external"),
        stream=on_card)


def bench_e2e(args):
    """`bench.py`'s default mode (`bench.py:188-374`): one sequence through
    CtrlVIO, IMU fed 0.25 s ahead of each frame; sustained frames/s over
    the frames from `stream_warmup + 8` (stream) or 4 after the bootstrap;
    online and post-hoc ATE from the 11th solved frame and the line-delay
    error, gated at 0.10 m (card) or 0.06 m (CPU) and 2 us."""
    device = preset_device(args.preset)
    on_card = device.type == "cuda"
    duration = args.duration or (16.0 if on_card else 6.0)
    print(f"[bench] device={device_line(device)} torch={torch.__version__}",
          file=sys.stderr)

    sim = e2e_sim(args, duration)
    cfg = e2e_config(args, on_card)
    if args.bootstrap == "visual":
        vio = new_vio(sim, cfg, device)
        imu_idx = 0  # interleaved feed in the frame loop
    else:
        vio = started_vio(sim, cfg, device)
        imu_idx = len(sim.imu_t_ns)

    prof_ctx = contextlib.nullcontext()
    logdir = ROOT / "build" / "bench_trace"
    if args.profile:
        from ctrlvio_tpu_torch.utils.summary import profile_trace

        prof_ctx = profile_trace(str(logdir))

    est, gt, t_est_ns = [], [], []
    frame_times = []
    rms_trend = []  # (frame, [image, imu, bias, prior] RMS)
    # timed from after the bootstrap and the stream's synchronous warmup
    timed_from = None
    ahead_ns = int(0.25e9)
    with prof_ctx:
        for i, fr in enumerate(sim.frames):
            while imu_idx < len(sim.imu_t_ns) and \
                    sim.imu_t_ns[imu_idx] <= fr.t_ns + ahead_ns:
                vio.process_imu(sim.imu_t_ns[imu_idx], sim.gyro[imu_idx],
                                sim.accel[imu_idx])
                imu_idx += 1
            t0 = time.perf_counter()
            out = vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
            dt_frame = time.perf_counter() - t0
            if out is not None:
                if timed_from is None:
                    timed_from = i + (cfg.stream_warmup + 8
                                      if cfg.stream else 4)
                est.append(out[1])
                t_est_ns.append(fr.t_ns)
                gt.append(sim.pose_at(fr.t_ns * 1e-9)[1])
            if timed_from is not None and i == timed_from:
                vio.timing.clear()
            if timed_from is not None and i >= timed_from:
                frame_times.append(dt_frame)
            st = vio.last_solve_stats
            rms = getattr(st, "rms", None)
            if rms is not None and (not rms_trend or not np.array_equal(
                    rms_trend[-1][1], np.asarray(rms))):
                rms_trend.append((i, np.asarray(rms)))
            if i % 25 == 0:
                print(f"[bench] frame {i}/{len(sim.frames)} "
                      f"({dt_frame * 1e3:.0f} ms)", file=sys.stderr,
                      flush=True)
    if args.profile:
        print(f"[bench] profiler trace -> {logdir / 'trace.json'}",
              file=sys.stderr)

    vio.flush()
    if not est:
        fail("bench", "the estimator never initialized")
    est, gt = np.asarray(est), np.asarray(gt)
    # online ATE: poses as reported at frame time (the stream forecasts
    # ahead of its lagged solve); post-hoc: the final spline at the same
    # times
    err = ate_rmse(est[10:], gt[10:], align="yaw")
    base = vio.data_start_ns or 0
    post = np.stack([vio.traj.pose(t - base)[1][0] for t in t_est_ns])
    err_post = ate_rmse(post[10:], gt[10:], align="yaw")
    ld_err = abs(vio.traj.line_delay - sim.cfg.line_delay)
    print(f"[bench] frames={len(est)} ATE online={err * 100:.2f} cm "
          f"post-hoc={err_post * 100:.2f} cm "
          f"ld={vio.traj.line_delay * 1e6:.2f} us (true "
          f"{sim.cfg.line_delay * 1e6:.2f}, err {ld_err * 1e6:.2f} us)",
          file=sys.stderr)

    ate_gate = 0.10 if on_card else 0.06
    if not (err <= ate_gate and err_post <= ate_gate and ld_err <= 2e-6):
        fail("bench", f"accuracy gates (ATE<{ate_gate}m, ld_err<2us)")

    n_timed = len(frame_times)
    # sustained = timed frames over their summed host time: the stream's
    # periodic summary pull absorbs the device queue in one long frame, so
    # the median understates what a deployment gets
    sustained = n_timed / max(float(np.sum(frame_times)), 1e-9)
    if n_timed:
        phases = {k: round(v / n_timed * 1e3, 1)
                  for k, v in vio.timing.items()}
        print(f"[bench] per-frame phase ms: {phases}", file=sys.stderr)
    if rms_trend:
        print("[bench] per-type residual RMS trend (frame: image/imu/bias/"
              "prior):", file=sys.stderr)
        pick = np.unique(np.linspace(0, len(rms_trend) - 1,
                                     min(8, len(rms_trend))).astype(int))
        for k in pick:
            fidx, r = rms_trend[k]
            print(f"[bench]   {fidx:5d}: {r[0]:8.3f} {r[1]:8.3f} "
                  f"{r[2]:8.3f} {r[3]:8.3f}", file=sys.stderr)
    if not on_card:
        print(vio.residual_summary().report(), file=sys.stderr)
    if n_timed:
        per_frame = float(np.median(frame_times))
        print(f"[bench] median frame time {per_frame * 1e3:.1f} ms "
              f"({1.0 / per_frame:.1f} fps median); SUSTAINED "
              f"{sustained:.1f} fps over {n_timed} frames "
              f"(headline; keyframe rate 10 Hz)", file=sys.stderr)
    else:
        print(f"[bench] no timed frames (timed from frame {timed_from}, "
              f"the sequence has {len(sim.frames)})", file=sys.stderr)
    emit_result("e2e", sustained, "fps",
                ate_online_cm=round(err * 100, 3),
                ate_posthoc_cm=round(err_post * 100, 3),
                ld_err_us=round(ld_err * 1e6, 3),
                gt=args.gt, seed=args.seed, speed=args.speed)


# ---------------------------------------------------------------------------
# image
# ---------------------------------------------------------------------------
def tumrs_camera():
    """The 1280x1024 Kannala-Brandt camera of `cam_tumrs.yaml`
    (`bench.py:412-416`)."""
    from ctrlvio_tpu_torch.models.cameras import Equidistant

    return Equidistant(
        mu=739.1654756101043, mv=739.1438452683457,
        u0=625.826167006398, v0=517.3370973594253,
        k2=0.019327620961435945, k3=0.006784242994724914,
        k4=-0.008658628531456217, k5=0.0051893686731546585)


def bench_image(args):
    """`bench.py --mode image` (`bench.py:377-543`): rendered rolling-shutter
    frames through FusedTracker (CLAHE, gyro-predicted pyramidal KLT with
    the FB check, Shi-Tomasi refill; the F-RANSAC gate on the textured
    scene) into CtrlVIO from the ground-truth bootstrap. On the card: f32,
    the stream, `lag=1`, K1, the frames resident on the card; on the CPU:
    f64, synchronous, `lag=0`, the plain LK. Gates: ATE < 0.15 m, line-delay
    error < 5 us. Its stderr ends with `[bench-image] stats {json}`: K1
    launches by level count, plain LK calls, the factor kernels' launches
    (`ops/factor_kernels.py::counts`), K4's (`ops/lm_kernels.py::counts`)
    and the captured programs
    (`utils/graphs.py::stats`: on the card every capture, its replays and
    the K1 launches they made), counted over the replay."""
    from ctrlvio_tpu_torch.frontend.fused import FusedTracker, rotation_flow
    from ctrlvio_tpu_torch.frontend.klt import KLTConfig
    from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig
    from ctrlvio_tpu_torch.ops import factor_kernels, lk, lm_kernels
    from ctrlvio_tpu_torch.sim import render
    from ctrlvio_tpu_torch.utils import graphs

    device = preset_device(args.preset)
    on_card = device.type == "cuda"
    cam = tumrs_camera()
    H, W = 1024, 1280
    duration = args.duration or (12.0 if on_card else 4.0)
    dtype = torch.float32 if on_card else torch.float64

    print(f"[bench-image] device={device_line(device)}; rendering "
          f"{duration:.0f}s of {W}x{H} Kannala-Brandt rolling-shutter "
          f"imagery ({args.scene})...", file=sys.stderr, flush=True)
    # IMU noise at the reference operating point; the pixel noise comes
    # from tracking the rendered imagery
    img_noise = {} if args.noiseless else {
        k: v for k, v in synthetic.REFERENCE_NOISE.items()
        if k != "pixel_noise"}
    sim = synthetic.generate(synthetic.SimConfig(
        duration=duration, n_landmarks=(300 if args.scene == "textured"
                                        else 1500), seed=args.seed,
        image_h=H, image_w=W, **img_noise))
    if args.scene == "textured":
        imgs = render.render_textured_sequence(
            sim, H, W, cam, seed=1, n_occluders=4,
            occluder_speed=(0.0 if args.noiseless else 0.4),
            photometric=not args.noiseless,
            pixel_noise=(0.0 if args.noiseless else 2.0))
    else:
        imgs = render.render_sequence(sim, H, W, camera=cam, seed=1,
                                      big_every=6, texture=6.0)

    tcfg = TrackerConfig(  # cam_tumrs.yaml's tracker block
        max_cnt=150, min_dist=25, use_clahe=True, fb_check=True,
        reject_wf=(args.scene == "textured"), f_threshold=1.0,
        klt=KLTConfig(pred_levels=3))
    lk.reset_counts()
    factor_kernels.reset_counts()
    lm_kernels.reset_counts()
    graphs.reset_counts()
    tracker = FusedTracker(tcfg, cam, (H, W), lag=1 if on_card else 0,
                           device=device)
    cfg = VIOConfig(window_config=BENCH_WINDOW, fix_ld=False, ld_init=0.0,
                    ld_upper=3.5e-5, dtype=dtype, stream=on_card)
    R_CtoI = so3np.quat_to_matrix(so3np.quat_exp(
        np.asarray(sim.cfg.ext_rot, np.float64))[None])[0]
    vio = started_vio(sim, cfg, device)

    # the sequence lives on the device, as a deployment's frames arrive
    # there before the front end reads them
    imgs_dev = torch.as_tensor(imgs, device=device)
    sync(device)

    est, gt = [], []

    def estimate(feat):
        if feat is None or len(feat["ids"]) < 8:
            return
        out = vio.process_frame(feat["t_ns"], feat["ids"], feat["pts"],
                                feat["rows"])
        if out is not None:
            est.append(out[1])
            gt.append(sim.pose_at(feat["t_ns"] * 1e-9)[1])

    t_feat = t_est = 0.0
    frame_times = []
    timed_from = (cfg.stream_warmup + 10) if cfg.stream else 4
    prev_t = None
    t_run0 = time.perf_counter()
    for i, fr in enumerate(sim.frames):
        t0 = time.perf_counter()
        M = (rotation_flow(sim.imu_t_ns, sim.gyro, prev_t, fr.t_ns, R_CtoI)
             if prev_t is not None else None)
        feat = tracker.step(fr.t_ns, imgs_dev[i], R_rel=M)
        prev_t = fr.t_ns
        t1 = time.perf_counter()
        estimate(feat)
        t2 = time.perf_counter()
        if i == timed_from:
            vio.timing.clear()
        if i >= timed_from:
            frame_times.append(t2 - t0)
            t_feat += t1 - t0
            t_est += t2 - t1
        if i % 25 == 0:
            print(f"[bench-image] frame {i}/{len(sim.frames)} "
                  f"({(t2 - t0) * 1e3:.0f} ms, "
                  f"{len(feat['ids']) if feat else 0} feats)",
                  file=sys.stderr, flush=True)
    estimate(tracker.flush())
    vio.flush()
    sync(device)
    wall = time.perf_counter() - t_run0
    stats = {"device": str(device), "frames": len(sim.frames),
             "solved": len(est), "wall_s": wall,
             "k1_track_launches": lk.lk_track.launches,
             "k1_track_launches_by_levels": dict(
                 lk.lk_track.launches_by_levels),
             "k1_level_launches": lk.lk_level.launches,
             "plain_lk_track_calls": lk.lk_track_plain.calls,
             "plain_lk_level_calls": lk.lk_level_plain.calls,
             "factor_kernels": factor_kernels.counts(),
             "lm_kernels": lm_kernels.counts(),
             "n_rejected": tracker.n_rejected,
             "counts": dict(vio.counts), "graphs": graphs.stats()}
    print("[bench-image] stats " + json.dumps(stats), file=sys.stderr)

    if len(est) <= 10:
        fail("bench-image", f"only {len(est)} solved frames")
    est, gt = np.asarray(est), np.asarray(gt)
    err = ate_rmse(est[10:], gt[10:], align="yaw")
    ld_err = abs(vio.traj.line_delay - sim.cfg.line_delay)
    print(f"[bench-image] frames={len(est)} ATE={err * 100:.2f} cm "
          f"ld={vio.traj.line_delay * 1e6:.2f} us "
          f"(true {sim.cfg.line_delay * 1e6:.2f}, err {ld_err * 1e6:.2f} us);"
          f" F-gate rejected {tracker.n_rejected} outlier tracks",
          file=sys.stderr)
    if not (err <= 0.15 and ld_err <= 5e-6):
        fail("bench-image", "accuracy gates (ATE<0.15m, ld_err<5us)")

    n = len(frame_times)
    fps = n / max(float(np.sum(frame_times)), 1e-9)
    if n:
        phases = {k: round(v / n * 1e3, 1) for k, v in vio.timing.items()}
        print(f"[bench-image] per-frame: front-end {t_feat / n * 1e3:.1f} "
              f"ms, estimator {t_est / n * 1e3:.1f} ms; estimator phases "
              f"{phases}", file=sys.stderr)
        per_frame = float(np.median(frame_times))
        print(f"[bench-image] median frame time {per_frame * 1e3:.1f} ms "
              f"({1.0 / per_frame:.1f} fps median); SUSTAINED {fps:.1f} fps "
              f"incl. front end (headline; keyframe rate 10 Hz)",
              file=sys.stderr)
    else:
        print(f"[bench-image] no timed frames (timed from frame "
              f"{timed_from}, the sequence has {len(sim.frames)})",
              file=sys.stderr)
    emit_result("image", fps, "fps")


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------
SERVE_WARMUP = 4


def bench_serve(args):
    """`bench.py --mode serve` (`bench.py:546-700`): B lanes behind one
    BatchedStream, one batched megastep a frame. Per-lane gates (ATE from
    frame `timed_from + 6`, yaw-aligned, < 0.10 m; line-delay error
    < 5 us); sustained aggregate frames/s = lanes x timed steps over their
    summed host time; the host split; `device_steady_ms`; the matrix-product
    FLOPs of one batched megastep (FlopCounterMode, a lower bound) and, on
    the card, their rate's share of the H100's f32 peak."""
    from ctrlvio_tpu_torch.parallel.stream_batch import BatchedStream

    device = preset_device(args.preset)
    B = args.batch_size
    duration = args.duration or 12.0
    print(f"[bench-serve] device={device_line(device)} B={B}",
          file=sys.stderr)
    # lanes (`bench.py:576-599`): seeds seed + i, noiseless, the line delay
    # started at its true value (still optimized), f32, the stream after 4
    # warmup frames, the ground-truth bootstrap
    sims = [synthetic.generate(synthetic.SimConfig(
        duration=duration, n_landmarks=300, seed=args.seed + i))
        for i in range(B)]
    vios = [started_vio(sim, VIOConfig(
        window_config=BENCH_WINDOW, fix_ld=False,
        ld_init=sim.cfg.line_delay, dtype=torch.float32, stream=True,
        stream_warmup=SERVE_WARMUP), device) for sim in sims]
    n_frames = min(len(s.frames) for s in sims)
    coord = BatchedStream(vios)

    timed_from = 11 + SERVE_WARMUP + 8
    times = []
    for k in range(n_frames):
        t0 = time.perf_counter()
        coord.step([(s.frames[k].t_ns, s.frames[k].ids, s.frames[k].pts,
                     s.frames[k].rows) for s in sims])
        if k == timed_from:
            for v in vios:
                v.timing.clear()
            coord.timing.clear()
            coord._n_steps = 0
        if k >= timed_from:
            times.append(time.perf_counter() - t0)
        if k % 25 == 0:
            print(f"[bench-serve] frame {k}/{n_frames}", file=sys.stderr,
                  flush=True)
    coord.flush()
    sync(device)

    bad_lanes = []
    for lane, (vio, sim) in enumerate(zip(vios, sims)):
        t_eval = [f.t_ns for f in sim.frames[timed_from + 6: n_frames]]
        # trajectory times are relative to data_start_ns
        base = vio.data_start_ns or 0
        est = np.stack([vio.traj.pose(t - base)[1][0] for t in t_eval])
        gt = np.stack([sim.pose_at(t * 1e-9)[1] for t in t_eval])
        err = ate_rmse(est, gt, align="yaw")
        ld_err = abs(vio.traj.line_delay - sim.cfg.line_delay)
        bad = not (err <= 0.10 and ld_err <= 5e-6)
        if bad:
            bad_lanes.append(lane)
        print(f"[bench-serve] lane {lane} (seed {sim.cfg.seed}): "
              f"ATE {err * 100:.2f} cm, ld_err {ld_err * 1e6:.2f} us"
              f"{'  <-- FAIL' if bad else ''}", file=sys.stderr)
    if bad_lanes:
        fail("bench-serve", f"lane accuracy gates (lanes {bad_lanes})")
    if not times:
        fail("bench-serve", f"no timed steps: {n_frames} frames, timed "
                            f"from {timed_from}")
    per_step = float(np.median(times))
    agg = B * len(times) / max(float(np.sum(times)), 1e-9)
    print(f"[bench-serve] B={B}: {per_step * 1e3:.1f} ms/lockstep frame "
          f"median, {float(np.mean(times)) * 1e3:.1f} ms mean -> SUSTAINED "
          f"{agg:.1f} aggregate frames/s ({agg / 10.0:.1f}x realtime "
          f"sequences per chip)", file=sys.stderr)

    n_steps = max(coord._n_steps, 1)
    split = {k: round(v / n_steps * 1e3, 1) for k, v in coord.timing.items()}
    print(f"[bench-serve] per-step host ms: {split}", file=sys.stderr)
    lane_phases = {}
    for v in vios:
        for k, s in v.timing.items():
            lane_phases[k] = lane_phases.get(k, 0.0) + s
    lane_phases = {k: round(v / n_steps * 1e3, 1)
                   for k, v in sorted(lane_phases.items())}
    print(f"[bench-serve] per-step lane-summed host phases ms: {lane_phases}",
          file=sys.stderr)
    dev_ms = coord.device_steady_ms()
    if dev_ms is not None:
        print(f"[bench-serve] batched megastep without the host feed: "
              f"{dev_ms:.1f} ms/step ({B / dev_ms * 1e3:.1f} frames/s)",
              file=sys.stderr)

    # FlopCounterMode counts matrix products only: a lower bound on the
    # work, and torch counts no bytes, so no memory share is stated
    cost = coord.cost_analysis()
    if cost:
        flops = cost["flops"]
        rate = 1.0 / per_step
        line = (f"[bench-serve] one batched megastep (B={B}): "
                f"{flops / 1e9:.3f} GFLOP in matrix products (a lower "
                f"bound) -> at {rate:.2f} steps/s: "
                f"{flops * rate / 1e12:.4f} TFLOP/s")
        if device.type == "cuda":
            line += (f", {flops * rate / H100_F32_FLOP_PER_S * 100:.4f}% of "
                     f"the H100's f32 peak (67 TFLOP/s) on "
                     f"{torch.cuda.get_device_name(device)}")
        print(line, file=sys.stderr)
    emit_result("serve", agg, "frames/s")


# ---------------------------------------------------------------------------
# batch
# ---------------------------------------------------------------------------
def time_min(fn, device, reps: int = 3):
    """Min seconds over `reps` calls after a warm call, each ending in a
    synchronize (`bench.py:736-743`); returns (seconds, last result)."""
    out = fn()
    sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def bench_batch(args, sweep=BATCH_SWEEP, cfg: WindowConfig = BATCH_WINDOW,
                max_iters: int = BATCH_ITERS):
    """`bench.py --mode batch` (`bench.py:703-760`): B copies of
    `sim/tiny.py`'s window (f32) solved by one `make_batched_solver` call
    for each B of `sweep`: min of 3 calls after a warm one; windows/s and
    per-window efficiency. Returns {B: (seconds, (params_b, stats_b))}."""
    from ctrlvio_tpu_torch.parallel import batch, multihost
    from ctrlvio_tpu_torch.sim import tiny

    device = preset_device(args.preset)
    print(f"[bench-batch] device={device_line(device)} window "
          f"{dict(cfg._asdict())}, {max_iters} LM iterations",
          file=sys.stderr)
    prob = tiny.tiny_problem(torch.float32, cfg, device=device)
    opts = SolveOptions(max_iters=max_iters)
    results, wps = {}, {}
    for B in sweep:
        solve = batch.make_batched_solver(cfg, opts)
        lanes = multihost.stacked(prob, B)
        tB, out = time_min(lambda: solve(*lanes, *prob.aux), device)
        results[B] = (tB, out)
        wps[B] = B / tB
        eff = wps[B] / (B * wps[sweep[0]] / sweep[0])
        print(f"[bench-batch] B={B:2d}: {tB * 1e3:7.1f} ms "
              f"({wps[B]:7.1f} windows/s, per-window efficiency {eff:.2f})",
              file=sys.stderr)
    emit_result("batch", max(wps.values()), "windows/s")
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    pin_f32_matmuls()
    {"e2e": bench_e2e, "image": bench_image, "serve": bench_serve,
     "batch": bench_batch}[args.mode](args)


if __name__ == "__main__":
    main()
