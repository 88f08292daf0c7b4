"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. device  - CUDA present; the card's name and power limit (nvidia-smi);
  2. build   - every hand-written kernel compiled from the repo's sources;
  3. k1_level - the LK kernel's one-level case against its plain PyTorch
               version at the main path's shapes (each of the three pyramid
               levels of a 1280x1024 pair);
  4. k1_track - the fused forward-backward track (one launch a frame, what
               the main path runs) against its plain version at the main
               path's shapes, for interior features, features near the
               borders and a large motion that sends taps outside the
               kernel's staged windows;
  5. main    - the image-in main path: rendered 1280x1024 Kannala-Brandt
               rolling-shutter frames through the port's FusedTracker,
               rotation_flow and CtrlVIO.process_frame, with accuracy gates
               and a check that the main path launched every kernel;
               per-frame front-end and estimator times, the estimator's
               phases, and a torch.profiler trace of the last frame
               (device time, busy share, device operations, top kernels);
  6. kernels - one line listing every kernel with launches, error and times.
The last line is {"ok": true, "device": {...}}; any failed phase exits
non-zero without it. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ctrlvio_tpu_torch.estimator.initializer import bootstrap_from_sim
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
from ctrlvio_tpu_torch.frontend import klt
from ctrlvio_tpu_torch.frontend.fused import FusedTracker, rotation_flow
from ctrlvio_tpu_torch.frontend.tracker import TrackerConfig
from ctrlvio_tpu_torch.models.cameras import Equidistant
from ctrlvio_tpu_torch.ops import lk, so3np
from ctrlvio_tpu_torch.sim import render, synthetic
from ctrlvio_tpu_torch.solver.layout import WindowConfig
from ctrlvio_tpu_torch.utils import cuda_build
from ctrlvio_tpu_torch.utils.ate import ate_rmse
from ctrlvio_tpu_torch.utils.precision import pin_f32_matmuls

# H100 SXM peaks (NVIDIA data sheet): HBM rate and f32 rate outside the
# tensor cores — the bound of a kernel is the larger of bytes / rate and
# operations / rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# K1 operation count per patch pixel: the template phase samples 5 bilinear
# values (~15 ops each) plus coordinates, gradients and G (~91 ops); each
# Gauss-Newton iteration samples one bilinear value plus residual and b
# (~22 ops)
K1_OPS_TEMPLATE = 91
K1_OPS_ITER = 22


def emit(obj):
    print(json.dumps(obj), flush=True)


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    pin_f32_matmuls()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build():
    t0 = time.perf_counter()
    names = ["lk"]
    paths = cuda_build.build(names)
    for n in names:
        cuda_build.load(n)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: str(p.name) for n, p in paths.items()},
          "ptxas": {n: [ln for ln in cuda_build.build_log.get(n, "").splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n in names}})


def graph_ms(fn, reps):
    """Mean ms per call of fn, replayed from one CUDA graph of `reps`
    calls: the card's own time per launch, without the host's dispatch
    between calls. (A profiler session here would disturb the one that
    traces the main path.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def time_cuda(fn, reps):
    """Mean ms per call over `reps` back-to-back calls, by CUDA events: at
    small sizes this includes the host's dispatch of each call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def textured_pair(H, W, dx, dy, seed, block=8, sigma=1.5):
    """A blocky, smoothed random texture and its copy shifted by (dx, dy)."""
    from scipy.ndimage import gaussian_filter, shift

    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, size=(H // block, W // block))
    img = gaussian_filter(np.kron(img, np.ones((block, block))) * 255.0,
                          sigma)
    return img, shift(img, (dy, dx), order=3, mode="nearest")


TRACK_CASES = ("interior", "border", "large_motion")
# the kernel's search window reaches M = 5 px past the patch on each side
# (`csrc/lk.cu`): a feature that moves farther at one level reads global
# memory for some of its taps
SEARCH_MARGIN = 5


def track_case(name, device, N=150):
    """The main path's track at full size: the three levels of a 1280x1024
    pair shifted by (2.4, -1.7), N features, their true positions plus an
    offset as `init`. interior: features 40 px or more inside, init 2 px
    off. border: features within 12 px of a border, init 2 px off.
    large_motion: a smoother texture (32 px blocks, sigma 8) with init
    32 px off, 8 px at the coarsest level, so that level moves most
    features beyond the staged search window. Returns (pyr0, pyr1, pts,
    init, shift)."""
    H, W = 1024, 1280
    dx, dy = 2.4, -1.7
    rng = np.random.default_rng(0)
    if name == "large_motion":
        img0, img1 = textured_pair(H, W, dx, dy, seed=5, block=32, sigma=8.0)
    else:
        img0, img1 = textured_pair(H, W, dx, dy, seed=4)
    if name == "border":
        side = np.arange(N) % 4
        d = rng.uniform(1.0, 12.0, N)
        x = np.where(side == 0, d, np.where(side == 1, W - 1 - d,
                                            rng.uniform(1, W - 2, N)))
        y = np.where(side == 2, d, np.where(side == 3, H - 1 - d,
                                            rng.uniform(1, H - 2, N)))
        pts = np.stack([x, y], 1)
    else:
        pts = np.stack([rng.uniform(40, W - 40, N),
                        rng.uniform(40, H - 40, N)], 1)
    ang = rng.uniform(0, 2 * np.pi, N)
    off = (32.0 if name == "large_motion" else 2.0) * np.stack(
        [np.cos(ang), np.sin(ang)], 1)
    init = pts + np.array([dx, dy]) + off

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return (klt.pyramid(f32(img0), 3), klt.pyramid(f32(img1), 3), f32(pts),
            f32(init), (dx, dy))


def k1_bound_ms(N, iters):
    npx = (2 * lk.HALF + 1) ** 2
    ops = N * npx * (K1_OPS_TEMPLATE + iters * K1_OPS_ITER)
    # each feature's two (21+2)^2 patches, its pts and guess, its outputs
    byts = N * (2 * (2 * lk.HALF + 3) ** 2 * 4 + 4 * 4 + 3 * 4)
    t_ops = ops / F32_FLOP_PER_S * 1e3
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_k1_level():
    dev = torch.device("cuda")
    H, W, N, iters = 1024, 1280, 150, 10
    dx, dy = 2.4, -1.7
    img0, img1 = textured_pair(H, W, dx, dy, seed=4)
    pyr0 = klt.pyramid(torch.tensor(img0, dtype=torch.float32, device=dev), 3)
    pyr1 = klt.pyramid(torch.tensor(img1, dtype=torch.float32, device=dev), 3)
    rng = np.random.default_rng(0)
    pts0 = np.stack([rng.uniform(40, W - 40, N), rng.uniform(40, H - 40, N)], 1)
    levels = []
    for lev in range(3):
        pts = torch.tensor(pts0 / 2 ** lev, dtype=torch.float32, device=dev)
        a, b = pyr0[lev], pyr1[lev]
        out_k, eig_k = lk.lk_level(a, b, pts, pts, iters)
        out_p, eig_p = lk.lk_level_plain(a, b, pts, pts, iters)
        torch.cuda.synchronize()
        good = eig_p > 1e-4
        pos_err = float((out_k - out_p)[good].abs().max())
        eig_rel = float(((eig_k - eig_p).abs() / eig_p.abs().clamp(min=1e-12)).max())
        flow = (out_k - pts)[good].median(dim=0).values.cpu().numpy()
        shift_err = float(np.abs(flow - np.array([dx, dy]) / 2 ** lev).max())
        t_k = time_cuda(lambda: lk.lk_level(a, b, pts, pts, iters), 200)
        t_p = time_cuda(lambda: lk.lk_level_plain(a, b, pts, pts, iters), 20)
        t_dev = graph_ms(lambda: lk.lk_level(a, b, pts, pts, iters), 50)
        bound, bound_by = k1_bound_ms(N, iters)
        rec = {"level": lev, "shape": list(a.shape), "n_good": int(good.sum()),
               "max_pos_err_px": pos_err, "max_eig_rel_err": eig_rel,
               "shift_err_px": shift_err, "ms": t_k, "device_ms": t_dev,
               "plain_ms": t_p, "bound_ms": bound, "bound_by": bound_by}
        levels.append(rec)
        emit({"phase": "k1_level", **rec})
        if not (pos_err <= 1e-3 and eig_rel <= 1e-4 and shift_err <= 0.15
                and int(good.sum()) >= N // 2):
            raise SystemExit(f"K1 (one level) disagrees with its plain "
                             f"version: {rec}")

    def mean(key):
        vals = [r[key] for r in levels]
        return None if None in vals else float(np.mean(vals))

    return {"max_abs_err": max(r["max_pos_err_px"] for r in levels),
            "ms": mean("ms"), "device_ms": mean("device_ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": levels[0]["bound_by"]}


def phase_k1_track():
    """The fused track against `lk_track_plain`, 150 features, 10
    iterations, fb_thresh and min_eig of `KLTConfig`. Positions within
    1e-3 px where both say ok; ok equal except where the plain version's
    fb lies within 1e-3 px of fb_thresh, its min_eig within 1e-4 relative
    of min_eig, or its position within 1e-3 px of the in-bounds edge
    (counted as `n_near_gate`); min_eig within 1e-4 relative; the known
    shift recovered to 0.15 px. Times: `device_ms` by graph replay of
    whole tracks, `ms` by CUDA events over back-to-back calls, `plain_ms`;
    the bound of the 2L = 6 level-passes; the latency floor's 66
    dependent reductions (2L x (1 template + iters rounds)). What the
    chain costs: `device_ms_iters0`, the track with no Gauss-Newton round
    (templates, copies, launch), `device_us_per_round` from the
    difference, and `device_ms_n1`, one feature alone (no SM holds two)."""
    iters = 10
    cfg = klt.KLTConfig(pred_levels=3)
    cases = []
    for name in TRACK_CASES:
        pyr0, pyr1, pts, init, (dx, dy) = track_case(name, "cuda")
        L = len(pyr0)
        H, W = pyr0[0].shape
        N = pts.shape[0]
        args = (pyr0, pyr1, pts, init, iters, lk.HALF, cfg.fb_thresh,
                cfg.min_eig)
        out_k, ok_k, eig_k = lk.lk_track(*args)
        out_p, ok_p, eig_p = lk.lk_track_plain(*args)
        back_p, _ = lk.lk_pass_plain(pyr1, pyr0, out_p, pts, iters)
        fb = torch.linalg.vector_norm(back_p - pts, dim=-1)
        edge = torch.stack([out_p[:, 0] - 1.0, out_p[:, 0] - (W - 1.0),
                            out_p[:, 1] - 1.0, out_p[:, 1] - (H - 1.0)], 1)
        near = (((fb - cfg.fb_thresh).abs() < 1e-3)
                | ((eig_p - cfg.min_eig).abs() < 1e-4 * cfg.min_eig)
                | (edge.abs() < 1e-3).any(dim=1))
        # how far the coarsest level moves each feature (plain version)
        top = 2 ** (L - 1)
        g_top, _ = lk.lk_level_plain(pyr0[-1], pyr1[-1], pts / top,
                                     init / top, iters)
        moved = (g_top - init / top).abs().max(dim=1).values
        torch.cuda.synchronize()
        both = ok_k & ok_p
        pos_err = float((out_k - out_p)[both].abs().max()) if bool(
            both.any()) else float("nan")
        eig_rel = float(((eig_k - eig_p).abs()
                         / eig_p.abs().clamp(min=1e-12)).max())
        flow = (out_k - pts)[ok_k].median(dim=0).values.cpu().numpy()
        t_k = time_cuda(lambda: lk.lk_track(*args), 200)
        t_p = time_cuda(lambda: lk.lk_track_plain(*args), 10)
        t_dev = graph_ms(lambda: lk.lk_track(*args), 50)
        t_dev0 = graph_ms(lambda: lk.lk_track(*args[:4], 0), 50)
        one = (pyr0, pyr1, pts[:1].contiguous(), init[:1].contiguous(), iters)
        t_dev1 = graph_ms(lambda: lk.lk_track(*one), 50)
        bound, bound_by = k1_bound_ms(N, iters)
        rec = {"case": name, "levels": [list(p.shape) for p in pyr0],
               "n": N, "n_ok": int(ok_k.sum()), "n_ok_plain": int(ok_p.sum()),
               "n_ok_differ": int((ok_k != ok_p).sum()),
               "n_near_gate": int(near.sum()),
               "n_beyond_window": int((moved > SEARCH_MARGIN + 1).sum()),
               "max_pos_err_px": pos_err, "max_eig_rel_err": eig_rel,
               "shift_err_px": float(np.abs(flow - np.array([dx, dy])).max()),
               "ms": t_k, "device_ms": t_dev, "plain_ms": t_p,
               "device_ms_iters0": t_dev0, "device_ms_n1": t_dev1,
               "device_us_per_round": (t_dev - t_dev0) * 1e3 / (2 * L * iters),
               "bound_ms": 2 * L * bound, "bound_by": bound_by,
               "latency_floor_rounds": 2 * L * (1 + iters)}
        cases.append(rec)
        emit({"phase": "k1_track", **rec})
        ok_agree = not bool(((ok_k != ok_p) & ~near).any())
        if not (pos_err <= 1e-3 and ok_agree and eig_rel <= 1e-4
                and rec["shift_err_px"] <= 0.15 and rec["n_ok"] >= N // 2
                and (name != "large_motion"
                     or rec["n_beyond_window"] >= N // 2)):
            raise SystemExit(f"K1 (fused track) disagrees with its plain "
                             f"version: {rec}")

    def mean(key):
        return float(np.mean([r[key] for r in cases]))

    return {"max_abs_err": max(r["max_pos_err_px"] for r in cases),
            "ms": mean("ms"), "device_ms": mean("device_ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": cases[0]["bound_by"]}


def replay(sim, imgs, camera, tcfg, vio_cfg, device):
    """The image-in main path, as `bench.py --mode image` drives it with
    lag=0 and the synchronous estimator: per frame, the gyro-predicted
    rotation, `FusedTracker.step` and `CtrlVIO.process_frame`. Returns the
    estimated and true positions of the solved frames, the estimator, the
    host times of each frame from the fifth on (as the bench times them)
    but the last, and a `torch.profiler` trace of the last frame."""
    timed_from = 4
    H, W = imgs.shape[1:]
    tracker = FusedTracker(tcfg, camera, (H, W), device=device)
    q_CtoI = so3np.quat_exp(np.asarray(sim.cfg.ext_rot, np.float64))
    R_CtoI = so3np.quat_to_matrix(q_CtoI[None])[0]
    vio = CtrlVIO(vio_cfg, q_CtoI, np.array(sim.cfg.ext_pos), device=device)
    init = bootstrap_from_sim(sim)
    for k in range(len(sim.imu_t_ns)):
        vio.process_imu(sim.imu_t_ns[k], sim.gyro[k], sim.accel[k])
    vio.set_initial_state(init.t_ns, init.q, init.p, init.bg, init.ba,
                          init.gravity, v0=init.v)
    imgs_dev = torch.as_tensor(imgs, device=device)
    est, gt = [], []

    def frame(i):
        """One frame; returns its front-end and estimator host seconds."""
        fr = sim.frames[i]
        sync(device)
        t0 = time.perf_counter()
        M = (rotation_flow(sim.imu_t_ns, sim.gyro, sim.frames[i - 1].t_ns,
                           fr.t_ns, R_CtoI) if i else None)
        feat = tracker.step(fr.t_ns, imgs_dev[i], R_rel=M)
        sync(device)
        t1 = time.perf_counter()
        out = None
        if feat is not None and len(feat["ids"]) >= 8:
            out = vio.process_frame(feat["t_ns"], feat["ids"], feat["pts"],
                                    feat["rows"])
        sync(device)
        t2 = time.perf_counter()
        if out is not None:
            est.append(out[1])
            gt.append(sim.pose_at(feat["t_ns"] * 1e-9)[1])
        return t1 - t0, t2 - t1

    n = len(sim.frames)
    times = []
    for i in range(n - 1):
        if i == timed_from:
            vio.timing.clear()
        times.append(frame(i))
    timing = dict(vio.timing)  # the estimator's phases, unprofiled frames
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t_last = sum(frame(n - 1))
    vio.flush()
    times = np.asarray(times[timed_from:])
    return dict(est=np.asarray(est), gt=np.asarray(gt), vio=vio, n_frames=n,
                t_feat=times[:, 0], t_est=times[:, 1], timing=timing,
                prof=prof, prof_s=t_last)


def device_share(prof, prof_s, frame_ms):
    """Device time of the profiled frame (kernels and copies on the card),
    its share of `frame_ms` (the median host time of an unprofiled frame:
    the profiler slows the host, not the card), device operations, and the
    five kernels that took the most device time."""
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) * 1e-3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    return {"profiled_frame_wall_ms": prof_s * 1e3,
            "device_ms": busy_ms,
            "device_busy_share": busy_ms / frame_ms if dev else None,
            "device_ops": sum(e.count for e in dev),
            "top_device_ms": {e.key[:80]: e.self_device_time_total * 1e-3
                              for e in top}}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_main():
    """`bench.py --mode image --scene blobs` at full width: 1280x1024
    Kannala-Brandt (`cam_tumrs.yaml`), 150 features, min_dist 25, CLAHE and
    the FB check on, pred_levels 3, the bench's window; f32 solve and f64
    marginalization on the card. Depth cut: 6 s of imagery."""
    H, W, duration = 1024, 1280, 6.0
    cam = Equidistant(
        mu=739.1654756101043, mv=739.1438452683457,
        u0=625.826167006398, v0=517.3370973594253,
        k2=0.019327620961435945, k3=0.006784242994724914,
        k4=-0.008658628531456217, k5=0.0051893686731546585)
    noise = {k: v for k, v in synthetic.REFERENCE_NOISE.items()
             if k != "pixel_noise"}
    t0 = time.perf_counter()
    sim = synthetic.generate(synthetic.SimConfig(
        duration=duration, n_landmarks=1500, seed=3, image_h=H, image_w=W,
        **noise))
    imgs = render.render_sequence(sim, H, W, camera=cam, seed=1,
                                  big_every=6, texture=6.0)
    t_render = time.perf_counter() - t0
    tcfg = TrackerConfig(max_cnt=150, min_dist=25, use_clahe=True,
                         fb_check=True, klt=klt.KLTConfig(pred_levels=3))
    vio_cfg = VIOConfig(
        window_config=WindowConfig(KW=32, NB=11, LM=256, OBS=768, MIMU=256),
        fix_ld=False, ld_init=0.0, ld_upper=3.5e-5, dtype=torch.float32)

    # the counts of the main path's run: zero just before, read just after
    lk.lk_track.launches = lk.lk_level.launches = 0
    lk.lk_track_plain.calls = lk.lk_level_plain.calls = 0
    t0 = time.perf_counter()
    run = replay(sim, imgs, cam, tcfg, vio_cfg, "cuda")
    wall = time.perf_counter() - t0
    launches = lk.lk_track.launches
    level_launches = lk.lk_level.launches
    plain_calls = lk.lk_level_plain.calls + lk.lk_track_plain.calls

    est, gt, vio = run["est"], run["gt"], run["vio"]
    ate = ate_rmse(est[10:], gt[10:], align="yaw")
    ld_err = abs(vio.traj.line_delay - sim.cfg.line_delay)
    n = len(run["t_feat"])
    rec = {"phase": "main", "frames": run["n_frames"], "solved": len(est),
           "render_s": t_render, "wall_s": wall,
           "ate_m": ate, "line_delay_s": vio.traj.line_delay,
           "line_delay_true_s": sim.cfg.line_delay, "ld_err_s": ld_err,
           "k1_track_launches": launches,
           "k1_level_launches": level_launches, "plain_lk_calls": plain_calls,
           "frontend_ms_median": float(np.median(run["t_feat"])) * 1e3,
           "estimator_ms_median": float(np.median(run["t_est"])) * 1e3,
           "frontend_ms_mean": float(np.mean(run["t_feat"])) * 1e3,
           "estimator_ms_mean": float(np.mean(run["t_est"])) * 1e3,
           "timing_ms_per_frame": {k: v / n * 1e3
                                   for k, v in run["timing"].items()},
           "profile_last_frame": device_share(
               run["prof"], run["prof_s"],
               float(np.median(run["t_feat"] + run["t_est"])) * 1e3)}
    emit(rec)
    finite = bool(np.isfinite(est).all()) and np.isfinite(vio.traj.line_delay)
    if not (finite and len(est) > 20 and ate < 0.15 and ld_err < 5e-6):
        raise SystemExit(f"main path fails its accuracy gates "
                         f"(ATE < 0.15 m, line-delay error < 5 us): {rec}")
    if launches == 0 or launches != run["n_frames"] or plain_calls:
        raise SystemExit(f"main path did not run through the fused K1 "
                         f"track once a frame: {rec}")
    return rec


def main():
    phase_device()
    phase_build()
    level = phase_k1_level()
    k1 = phase_k1_track()
    launches = phase_main()["k1_track_launches"]
    kernels = [{
        "name": "K1 lk_track", "route": "cuda",
        "source": "ctrlvio_tpu_torch/csrc/lk.cu",
        "replaces": "ctrlvio_tpu/ops/pallas/lk_kernel.py:118",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "device_ms": k1["device_ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
        "level_ms": level["ms"], "level_device_ms": level["device_ms"],
        "level_max_abs_err": level["max_abs_err"]}]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
