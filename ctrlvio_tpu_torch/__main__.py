"""Command-line entry points of the port (≙ the reference's odometry_node,
`odometry_node.cpp:27-49`, plus a bag converter the reference delegates to
ROS for); the counterpart of `ctrlvio_tpu/__main__.py`, with the same
commands and arguments.

  python -m ctrlvio_tpu_torch convert input.bag sequence.npz [--imu-topic ...]
  python -m ctrlvio_tpu_torch run config.yaml sequence.npz --out traj.tum
  python -m ctrlvio_tpu_torch viz traj.tum [--gt gt.tum] [-o traj.html]

`run` accepts the reference's three-file YAML schema (main + camera + IMU,
`io/config.py`) and either a feature npz or a raw-image npz (the front end
then runs in-process, like `odometry_manager.h:70-73`). It runs on the
card (`--device cuda`, the default; without one it raises) in float32 with
the streaming pipeline, or with `--device cpu` in float64 with the
synchronous one; `--stream` forces the stream on. It ends with two stderr
lines: `[run] frames=...` and `[run] stats {...}`, a JSON object of the
run's counts (solves, megasteps, bootstraps, K1 launches, the factor
kernels' launches, synchronizing calls with `--check-syncs`), the captured
programs (`graphs`: on the
card, `utils/graphs.py::stats`) and per-frame times.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_run(args):
    from dataclasses import replace

    import numpy as np
    import torch

    from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO
    from ctrlvio_tpu_torch.io import dataset
    from ctrlvio_tpu_torch.io.config import load_config
    from ctrlvio_tpu_torch.ops import factor_kernels, lk, lm_kernels
    from ctrlvio_tpu_torch.utils import graphs
    from ctrlvio_tpu_torch.utils.device import resolve_device
    from ctrlvio_tpu_torch.utils.export import export_vio_trajectory

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cfg, cam, q_CtoI, p_CinI, raw = load_config(args.config)
    cfg = replace(cfg, bootstrap=args.bootstrap,
                  dtype=torch.float32 if on_card else torch.float64,
                  stream=bool(args.stream) or on_card)

    seq = dataset.load_sequence(args.sequence)
    tc = None
    if seq.images is not None:
        if cam is None:
            sys.exit("raw-image sequence but no camera model in the config")
        from ctrlvio_tpu_torch.estimator.packing import auto_landmark_slots
        from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig

        cam_d = raw.get("_camera_dict", {})
        tc = TrackerConfig(
            max_cnt=int(cam_d.get("max_cnt", 150)),
            min_dist=int(cam_d.get("min_dist", 25)),
            freq=float(cam_d.get("freq", 10.0)),
            use_clahe=bool(cam_d.get("equalize", 1)),
            reject_wf=bool(cam_d.get("reject_wf", 0)),
            f_threshold=float(cam_d.get("F_threshold", 1.0)))
        # size the landmark table from the tracker's feature cap (loud
        # failure on overflow; ≙ the reference's NUM_OF_F headroom)
        wc = cfg.window_config
        cfg = replace(cfg, window_config=wc._replace(
            LM=max(wc.LM, auto_landmark_slots(tc.max_cnt))))
    vio = CtrlVIO(cfg, q_CtoI, p_CinI, device=device)
    vio.check_dispatch_syncs = args.check_syncs
    if tc is not None:
        vio.attach_frontend(cam, seq.images.shape[1:3], tc)
        vio.tracker.check_dispatch_syncs = args.check_syncs

    lk.reset_counts()
    factor_kernels.reset_counts()
    lm_kernels.reset_counts()
    graphs.reset_counts()
    frame_s = []
    t0 = time.perf_counter()
    out = dataset.replay(seq, vio, frame_s=frame_s)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(out)
    print(f"[run] frames={n} wall={wall:.1f}s "
          f"({n / max(wall, 1e-9):.1f} fps) "
          f"line_delay={vio.traj.line_delay * 1e6:.3f} us", file=sys.stderr)
    init_t = out[0][0] if out else None
    stats = {
        "device": str(device), "stream": cfg.stream,
        "frames": len(seq.frame_t_ns), "poses": n, "wall_s": wall,
        "init_frame": None if init_t is None else
        int(np.searchsorted(seq.frame_t_ns, init_t)),
        "init_t_ns": init_t, "line_delay_s": vio.traj.line_delay,
        "counts": dict(vio.counts),
        "frontend_dispatch_syncs": None if vio.tracker is None
        else vio.tracker.dispatch_syncs,
        "k1_track_launches": lk.lk_track.launches,
        "k1_track_launches_by_levels": lk.lk_track.launches_by_levels,
        "k1_level_launches": lk.lk_level.launches,
        "plain_lk_track_calls": lk.lk_track_plain.calls,
        "plain_lk_level_calls": lk.lk_level_plain.calls,
        "factor_kernels": factor_kernels.counts(),
        "lm_kernels": lm_kernels.counts(),
        "graphs": graphs.stats(),
        "lm_iters": vio.lm_iters_record(),
        "timing_s": dict(vio.timing),
        "frontend_timing_s": {} if vio.tracker is None
        else dict(vio.tracker.timing),
        "frame_ms_median": float(np.median(frame_s)) * 1e3
        if frame_s else None,
        "sustained_fps": len(frame_s) / max(wall, 1e-9)}
    boot = " ".join(f"{k}={vio.timing.get(k, 0.0):.2f}s" for k in (
        "vio_init", "boot_predict", "boot_solve", "boot_prior"))
    print(f"[run] bootstrap {boot}", file=sys.stderr)
    print("[run] stats " + json.dumps(stats), file=sys.stderr)
    if args.out:
        export_vio_trajectory(args.out, vio)
        print(f"[run] trajectory -> {args.out}", file=sys.stderr)


def _cmd_convert(args):
    from ctrlvio_tpu_torch.io.rosbag import bag_to_npz

    seq = bag_to_npz(args.bag, args.out, imu_topic=args.imu_topic,
                     image_topic=args.image_topic, t_start=args.t_start,
                     t_end=args.t_end, image_stride=args.stride)
    print(f"[convert] {len(seq.imu_t_ns)} IMU msgs, "
          f"{len(seq.frame_t_ns)} images -> {args.out}", file=sys.stderr)


def _cmd_viz(args):
    import numpy as np

    from ctrlvio_tpu_torch.utils import viz

    t, p, _ = viz.load_tum(args.trajectory)
    p_gt = viz.load_tum(args.gt)[1] if args.gt else None
    knots = points = None
    if args.ckpt:
        z = np.load(args.ckpt)
        knots = z["knots_p"] if "knots_p" in z.files else None
    if args.points:
        z = np.load(args.points)
        for key in ("landmarks", "points"):
            if key in z.files:
                points = z[key]
                break
    out = args.out or (args.trajectory.rsplit(".", 1)[0] + ".html")
    viz.write_html_replay(out, t, p, p_gt=p_gt, knots=knots, points=points)
    print(f"[viz] replay -> {out}", file=sys.stderr)
    if args.png:
        viz.write_png(args.png, t, p, p_gt=p_gt, knots=knots, points=points)
        print(f"[viz] summary -> {args.png}", file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ctrlvio_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="replay a sequence through the estimator")
    r.add_argument("config", help="main odometry YAML (reference schema)")
    r.add_argument("sequence", help="sequence .npz (features or raw images)")
    r.add_argument("--out", default=None, help="TUM trajectory output path")
    r.add_argument("--bootstrap", default="visual",
                   choices=["visual", "static", "external"])
    r.add_argument("--stream", default=None, action="store_true",
                   help="force the streaming pipeline (default: on for the "
                   "card)")
    r.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a "
                   "card) or cpu")
    r.add_argument("--check-syncs", action="store_true",
                   help="count synchronizing CUDA calls inside each "
                   "streamed dispatch and front-end step (sync debug mode "
                   "'warn'; on the card only)")
    r.set_defaults(fn=_cmd_run)

    c = sub.add_parser("convert", help="rosbag 2.0 -> sequence npz")
    c.add_argument("bag")
    c.add_argument("out")
    c.add_argument("--imu-topic", default="/imu0")
    c.add_argument("--image-topic", default="/cam0/image_raw")
    c.add_argument("--t-start", type=float, default=0.0)
    c.add_argument("--t-end", type=float, default=float("inf"))
    c.add_argument("--stride", type=int, default=1)
    c.set_defaults(fn=_cmd_convert)

    v = sub.add_parser("viz", help="offline trajectory replay "
                       "(≙ the reference's rviz OdometryViewer, headless)")
    v.add_argument("trajectory", help="TUM trajectory file (from run --out)")
    v.add_argument("--gt", default=None, help="ground-truth TUM file")
    v.add_argument("--ckpt", default=None,
                   help="checkpoint npz (adds spline control points)")
    v.add_argument("--points", default=None,
                   help="npz with a 'landmarks'/'points' array")
    v.add_argument("-o", "--out", default=None, help="output HTML path")
    v.add_argument("--png", default=None, help="also write a PNG summary "
                   "(needs matplotlib)")
    v.set_defaults(fn=_cmd_viz)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
