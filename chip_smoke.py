"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. device  - CUDA present; the card's name and power limit (nvidia-smi);
               then the textured frames of phase 7 start rendering in a
               separate process (host numpy, minutes) beside phases 2-6;
  2. build   - every hand-written kernel compiled from the repo's sources
               (K1, the LM exit's WHILE-node helper, K2 and K3, K4), and
               the native feature table's host library (g++);
  3. k1_level - the LK kernel's one-level case against its plain PyTorch
               version at the main path's shapes (each of the three pyramid
               levels of a 1280x1024 pair);
  4. k1_track - the fused forward-backward track (one launch a frame, what
               the image paths run) against its plain version at their
               shapes: three levels for interior features, features near
               the borders and a large motion that sends taps outside the
               kernel's staged windows; four levels with init = pts, the
               classic tracker's track; two levels, the command line's
               track (`KLTConfig`'s default pred_levels);
               then lm_accept: K4 (`csrc/lm_accept.cu`, the LM's accept
               step) against its plain version at e2e's window, f32 and
               f64, in every accept case, functional, in place and
               vmapped over 8 lanes, bit for bit; then while_node: the
               LM's exit (`graphs.run_while`, a CUDA-graph WHILE node
               whose condition K4 sets) on a solve's iterations, bit for
               bit against the plain loop, its trips counted on the card;
               then factor_kernels: K2 and K3 (`csrc/factors.cu`, every
               image and IMU factor's rows, residuals and cost in one
               launch each) and K5 (the same file, the streamed frame's
               whole residual summary: image, IMU, bias and prior sums
               into five numbers, one launch) against their plain
               versions at e2e's and batch's windows (a window of the e2e
               sequence, perturbed; K5's with bias pairs and a prior),
               f32 and f64, K2 and K3 with marg_mode off and on,
               vmapped over 8 lanes equal to each lane's own launch bit
               for bit, two replays of a launch bit for bit; times by
               graph replay, the plain versions' times,
               the bounds; each instance's registers, spill bytes, shared
               bytes and threads a block beside the build's ptxas log;
  5. main    - the image-in path of `bench.py --mode image --scene blobs`:
               4 s of rendered 1280x1024 Kannala-Brandt rolling-shutter frames
               through the port's FusedTracker, rotation_flow and the
               synchronous CtrlVIO.process_frame, with accuracy gates and a
               check that the path launched every kernel; per-frame
               front-end and estimator times, the estimator's phases, and a
               torch.profiler trace of the last frame (device time, busy
               share, device operations, top kernels);
               then main_marg_dev: the same frames, not rendered again,
               through the same path with VIOConfig(marg_on_host=False)
               (the marginalization prior in f32 on the card, not f64):
               the image gates, every frame after the bootstrap solved,
               one K1 launch a frame, and the JAX package's run of it
               (NaN prior from the same solved frame, no LM step
               accepted after, ATE and line-delay error within 1 mm and
               0.01 us of its own); the `prior` phase's and the
               estimator's ms a frame beside main's, and where the f32
               prior first went non-finite;
  6. e2e     - `bench.py`'s default run: a 12 s synthetic feature sequence
               (reference sensor noise, seed 3) through CtrlVIO with the
               visual bootstrap, the native feature table and the
               streaming megastep, f32 on the card; bench.py's gates
               (online and post-hoc ATE < 0.10 m, line-delay error
               < 2 us), the visual bootstrap initialized the run, 40 or
               more streamed frames, no synchronous window solve after the
               warmup handoff, and no synchronizing CUDA call inside any
               streamed dispatch; per-frame times (warmup and streamed
               apart), sustained fps, the estimator's phases, a
               torch.profiler trace of one streamed frame (its sums lower
               bounds where the tracer missed trips of a WHILE node), and
               one megastep run eagerly and profiled by stage range (image
               and IMU factors, normal equations, Schur solve, retract,
               LM accept, QR prior, slide, residual summary: device ms and
               operations each; each factor range one K2 or K3 launch,
               the residual summary one K5 launch and the LM accept range
               one K4 launch, each with at most STAGE_OTHER_OPS other
               device operations a call); no capture of a program on a
               timed frame;
  7. image_textured - `bench.py --mode image` as its chip preset runs it,
               its 12 s cut to 10 s of the textured ray-cast scene
               (moving occluders, photometric drift, pixel noise) through
               FusedTracker with the F-RANSAC gate and lag=1 into the
               streaming CtrlVIO;
               bench.py's image gates (ATE < 0.15 m, line-delay error
               < 5 us), one 3-level K1 launch a frame and no plain LK call,
               the gate fired, >= 40 megasteps with no synchronizing call;
               front-end and estimator times, warmup and streamed medians,
               sustained fps, render time, the front end's synchronizing
               calls and a torch.profiler trace of one streamed frame;
               then image_textured_classic: the first 4 s through
               CtrlVIO.process_image with the classic FeatureTracker, its
               four stages captured programs (one 4-level K1 launch a
               frame by replays, >= 100 features);
  8. serve   - `bench.py --mode serve` at its default width, cut from 12 s
               to 6 s: 8 streaming CtrlVIOs behind one BatchedStream, one
               batched megastep (torch.func.vmap) a frame for all lanes;
               each lane to bench.py's serve gates (ATE < 0.10 m,
               line-delay error < 5 us), >= 30 batched steps, no
               synchronizing call in the coordinator's dispatch, a traced
               step's device operations (the trace complete: every K4
               launch seen) at most twice those of e2e's single-lane
               megastep run eagerly, no capture of a program on a timed
               step; step times, aggregate frames/s, the host split;
  9. batch   - `bench.py --mode batch`'s sweep: make_batched_solver over
               B = 1, 2, 4, 8, 16 copies of the bench's window against the
               single solve, and the CG Schur path beside chol at B = 8,
               each B one captured program, timed by replays;
 10. cli     - the command line as a user runs it, in subprocesses of
               `python -m ctrlvio_tpu_torch` on the card: 10 s of
               `bench.py --mode image`'s 1280x1024 blobs scene (seed 3) at
               0.4x its motion (the visual bootstrap cannot initialize at
               the bench's own motion, in either package), written as a
               rosbag (raw mono8 `sensor_msgs/Image`,
               `sensor_msgs/Imu`, absolute stamps, uncompressed chunks)
               beside a reference-schema three-file config (cam_tumrs's
               Kannala-Brandt camera and tracker knobs); `convert`, then
               `run --bootstrap visual` (FusedTracker with K1, the visual
               bootstrap, the streaming estimator in f32 with the
               command line's window, OBS=2048), then `viz` (HTML); gates:
               the TUM file's stamps increase and its quaternions are
               unit, ATE against ground truth < 0.15 m (yaw-aligned, from
               the bootstrap frame on), line-delay error < 5 us, >= 10
               megasteps with no synchronizing call, one 2-level K1 launch
               a frame and no plain LK call;
               phases 8 and 9 run in one spawned process and phase 10 in
               another, both from the end of phase 4, beside phases 5-7;
               they print after them;
 11. multichip - the multi-device layer over torch.distributed, in a third
               spawned process beside them: (a) NCCL at world size 1 on
               the bench's batch window (f32, 15 LM iterations): the
               factor-sharded solve timed in turns with the single solve,
               its synchronizing calls, and, under deterministic
               algorithms, the sharded solve equal to the single one, the
               sharded step to an unsharded step and the seq-sharded
               batch (B = 8) to the batch lane by lane; the megastep
               chain; (b) `dryrun_multichip(2, backend="gloo")`: two rank
               processes sharing the card (NCCL takes one rank a card),
               the fac-sharded solve against the unsharded one under the
               dry run's 1e-4 gates;
 12. bench   - the port's measuring entry points, in a fourth spawned
               process beside them: `python -m ctrlvio_tpu_torch.bench` at
               the accuracy matrix's lissajous row (e2e, seed 3, 1.0x, cut
               from 16 s to 12 s; bench.py's keys and gates) and
               `--mode image --scene blobs --duration 12` (the card
               preset's length: frames timed after the stream's warm-up,
               a positive frame rate, at least one megastep and one K5
               launch, one 3-level K1 launch a frame, read from its stats
               line), then
               `python -m ctrlvio_tpu_torch.tools.profile_serve --sweep`
               (ms a batched megastep at B = 1..16), `tools.ne_ab` (dense
               against chunked normal equations, each variant's program
               replayed), then `entry()` on the card against
               `entry(device="cpu")`;
 13. graphs  - in a fifth side process, the same frames run with every
               program replayed from its captured CUDA graph and eagerly:
               10 synchronous `main` frames with the front end on every
               frame, ~20 streamed e2e frames, 10 serve steps at B = 8,
               12 frames of the classic tracker, the batched solver at
               B = 8; `main` and `e2e` (LM exit nodes inside) and the
               batched solver bit for bit, the rest within the gpu tests'
               tolerances, ATE within 1 mm, host ms a frame both ways; the
               e2e run's last streamed megastep and synchronous window
               solve replayed from their held inputs (CUDA events, from
               one state under deterministic algorithms: times that
               compare across trees);
 14. kernels - one line listing every kernel with launches, error and times
               (K2, K3, K4 and K5 with their launches on every path;
               every path must have launched K2, K3 and K4, every
               streamed path K5, and none run a plain accept step or a
               plain summary).
Every path runs as the port runs on the card: each per-frame program (the
streamed and batched megasteps, the synchronous solve, prior and predict,
the f64 bootstrap BA, the fused front end, the classic tracker's four
stages, the batched solver, NCCL's sharded solve and step) a captured
CUDA graph (`utils/graphs.py`), the LM's iterations after the first the
body of a WHILE node that stops once the solve is done. Each
phase's line lists the graphs it captured (key, seconds, reserved memory
before and after), their seconds, the shared graph pool's size, the
replays and the K1 launches made by replays and by the warm-up runs before
captures; "one K1 launch a frame" counts through replays, and a capture on
a timed (steady) frame fails the e2e and serve phases (the other lines
count them, `captures_in_timed_frames`). The estimator lines add each
solve kind's histogram of LM iterations (`lm_iters_hist`), the iterations
needed, executed (the WHILE nodes' trips the card ran, counted on the
card, `while_trips`) and those a fixed count would run; the trips run
must equal what the histograms need. `e2e` and `cli` add the bootstrap's
timing keys.
The last line is {"ok": true, "device": {...}}; any failed phase exits
non-zero without it. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import warnings
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ctrlvio_tpu_torch.bench import started_vio, tumrs_camera
from ctrlvio_tpu_torch.entry import entry
from ctrlvio_tpu_torch.estimator import native, odometry, stream
from ctrlvio_tpu_torch.estimator.odometry import (CtrlVIO, VIOConfig,
                                                  iters_histogram)
from ctrlvio_tpu_torch.frontend import klt
from ctrlvio_tpu_torch.frontend import tracker as tracker_mod
from ctrlvio_tpu_torch.frontend.fused import FusedTracker, rotation_flow
from ctrlvio_tpu_torch.frontend.tracker import FeatureTracker, TrackerConfig
from ctrlvio_tpu_torch.ops import factor_kernels as fk
from ctrlvio_tpu_torch.ops import lk, so3np
from ctrlvio_tpu_torch.ops import lm_kernels as k4
from ctrlvio_tpu_torch.parallel import batch, multihost, sharded_lm
from ctrlvio_tpu_torch.parallel import mesh as pmesh
from ctrlvio_tpu_torch.parallel.stream_batch import BatchedStream
from ctrlvio_tpu_torch.sim import render, synthetic, tiny
from ctrlvio_tpu_torch.sim.windows import (ACCEPT_CASES, FACTOR_WINDOWS,
                                           accept_case, factor_window,
                                           summary_window)
from ctrlvio_tpu_torch.solver import assemble, lm
from ctrlvio_tpu_torch.solver.layout import (SolveOptions, WindowConfig,
                                             column_mask, retract)
from ctrlvio_tpu_torch.utils import cuda_build, graphs
from ctrlvio_tpu_torch.utils.ate import ate_rmse
from ctrlvio_tpu_torch.utils.device import recorded_syncs
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


def reset_counts():
    """Zero K1's, K2's, K3's and K4's launch counts and the captured
    programs' records, just before a phase drives its path."""
    lk.reset_counts()
    fk.reset_counts()
    k4.reset_counts()
    graphs.reset_counts()


def factor_fields(counts=None, k4_counts=None):
    """K2's, K3's and K5's launches in a phase (`factor_kernels.counts()`
    of this process, or `counts` from a subprocess's stats line), K4's
    (`lm_kernels.counts()`, or `k4_counts`), and the runs of their plain
    versions (K5's and its per-slot pieces'). A launch recorded into a
    captured program counts on each replay, one inside a WHILE node's
    body once a trip the node ran."""
    c = counts or fk.counts()
    a = k4_counts or k4.counts()
    return {"k4_launches": a["lm_accept"],
            "plain_accept_calls": a["lm_accept_plain"],
            "k2_launches": c["image_factor_rows"],
            "k3_launches": c["imu_factor_rows"],
            "k5_launches": c["residual_summary"],
            "plain_factor_calls": c["image_factor_rows_plain"]
            + c["imu_factor_rows_plain"],
            "plain_summary_calls": c["residual_summary_plain"]
            + c["image_factor_residuals_plain"]
            + c["imu_factor_residuals_plain"]}


def graph_fields(st=None):
    """What the captured programs did in a phase (`graphs.stats()` of this
    process, or `st` from a subprocess's stats line): every capture (its
    key, warm-up and capture seconds, the reserved device memory before
    and after), their seconds in all, the shared graph pool's size, the
    replays, and K1's launches made by replays and by the warm-up runs
    before captures; the WHILE nodes captured and the trips their bodies
    ran."""
    st = st or graphs.stats()
    return {"graphs_captured": st["graphs_captured"],
            "graphs_captured_n": len(st["graphs_captured"]),
            "capture_s": st["capture_s"],
            "graph_pool_mb": st["graph_pool_mb"], "replays": st["replays"],
            "k1_launches_replayed": st["launches_replayed"].get("lk_track", 0),
            "k1_launches_warm_up": st["launches_warm_up"].get("lk_track", 0),
            "while_nodes": st["while_nodes"],
            "while_trips": st["while_trips"]}


# the bootstrap's timing keys of `CtrlVIO.timing`: the visual SfM and
# initializer, the IMU-only predict fit, the f64 BA and its prior
BOOT_KEYS = ("vio_init", "boot_predict", "boot_solve", "boot_prior")
# `CtrlVIO.timing`'s keys that no other key holds
RUN_TOP_KEYS = BOOT_KEYS + ("consume", "predict", "triangulate", "dispatch",
                            "slide", "ba")


def iters_fields(records, g, batched_stream=False):
    """The LM iteration counts of a phase's estimators
    (`CtrlVIO.lm_iters_record`, one a lane): each kind's histogram
    {iterations: solves} and `max_iters`, and over every solve the
    iterations needed (the histograms' sum), those the card executed and
    those a fixed count runs (`max_iters` each, as before the exit
    node). A solve of a program with an exit node executes its first
    iteration and the trips the WHILE node's body ran (`while_trips`,
    counted on the card); the batched megastep (`batched_stream`) runs
    all `max_iters`. `while_trips_expected` is what the histograms say the
    nodes must have run."""
    needed = fixed = node_solves = expected = batched = 0
    for r in records:
        for kind, h in r["hist"].items():
            most = r["max_iters"][kind]
            for k, n in h.items():
                needed += int(k) * n
                fixed += most * n
                if batched_stream and kind == "stream":
                    batched += most * n
                else:
                    node_solves += n
                    expected += (int(k) - 1) * n
    return {"lm_iters_hist": [r["hist"] for r in records]
            if len(records) > 1 else records[0]["hist"],
            "lm_max_iters": records[0]["max_iters"],
            "lm_iters_needed": needed,
            "lm_iters_executed": node_solves + g["while_trips"] + batched,
            "lm_iters_fixed_count": fixed,
            "while_trips_expected": expected}


def lanes_done_early(lane_iters, most):
    """Of the lockstep batched steps (each lane's streamed solves in
    order), how many had every lane done before `most` iterations: the
    steps a node on "any lane not done" would have cut short."""
    steps = min(len(x) for x in lane_iters)
    early = sum(max(x[i] for x in lane_iters) < most for i in range(steps))
    return {"lm_batched_steps": steps, "lm_steps_all_lanes_done_early": early,
            "lm_steps_all_lanes_done_early_share": early / max(steps, 1)}


def iters_exact(rec):
    """The WHILE nodes ran exactly the iterations the solves needed."""
    return rec["while_trips"] == rec["while_trips_expected"]


def k1_once_a_frame(launches, g, frames):
    """One K1 track launch a frame counted through replays, and no other
    launch than the warm-up runs' before captures."""
    return (g["k1_launches_replayed"] == frames
            and launches == frames + g["k1_launches_warm_up"])


def replay_times(prog, reps=5):
    """A captured program replayed `reps` times on the inputs it holds
    (after one replay): the card's ms a replay by CUDA events, without the
    profiler, and the host's ms a replay call (the graph's launch). A
    program that carries state advances it: time it after its run."""
    prog(*prog.inputs)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        prog(*prog.inputs)
    host = (time.perf_counter() - t0) / reps
    b.record()
    torch.cuda.synchronize()
    return {"replay_device_ms": a.elapsed_time(b) / reps,
            "replay_host_ms": host * 1e3, "program": prog.label}


def replays_from_held(prog, reps=20):
    """`reps` replays of a captured program, each from the inputs it holds
    now (copied back before every replay, outside the timing), timed by
    CUDA events around the replay alone: ms a replay, the mean and the
    fewest. From a state reached under deterministic algorithms every run
    of a tree, and every tree whose solves give the same bits, replays the
    same work, so the times compare across trees (run them in turns on
    one card)."""
    start = graphs.clone(prog.inputs)
    ms = []
    for _ in range(reps):
        graphs.copy_tree(prog.inputs, start)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        prog(*prog.inputs)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return {"program": prog.label, "reps": reps,
            "ms_mean": float(np.mean(ms)), "ms_min": float(np.min(ms))}


def program(cache, *words):
    """The program of `cache` whose key holds every one of `words`."""
    return next(p for p in cache._programs.values()
                if all(w in p.label for w in words))


def captured_once(g, most):
    """Each program captured once (a key never twice: steady frames replay
    what the first frames captured), and at most `most` of them."""
    keys = [c["key"] for c in g["graphs_captured"]]
    return len(keys) == len(set(keys)) and len(keys) <= most


def card_name_and_power_limit():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(2)
    card = card_name_and_power_limit()
    print(card, flush=True)
    pin_f32_matmuls()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          # whether torch offers CUDA-graph conditional nodes itself (it
          # does not in 2.11; `graphs.run_while` takes
          # `csrc/graph_cond.cu`'s)
          "torch_if_node": hasattr(torch.cuda.CUDAGraph,
                                   "begin_capture_to_if_node")})


def phase_build():
    t0 = time.perf_counter()
    names = ["lk", "graph_cond", "factors", "lm_accept"]
    paths = cuda_build.build(names)
    for n in names:
        cuda_build.load(n)
    native.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {**{n: str(p.name) for n, p in paths.items()},
                        "feature_table": native.library_path().name},
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


TRACK_CASES = ("interior", "border", "large_motion", "four_levels",
               "two_levels")
# pyramid levels of each case (three unless named)
CASE_LEVELS = {"four_levels": 4, "two_levels": 2}
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
    features beyond the staged search window. four_levels: the classic
    tracker's track, the interior features over all four levels (1280x1024
    down to 160x128) with init = pts. two_levels: the command line's
    track (`KLTConfig.pred_levels` 2), the interior case over two levels.
    Returns (pyr0, pyr1, pts, init, shift)."""
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
    init = pts if name == "four_levels" else pts + np.array([dx, dy]) + off
    levels = CASE_LEVELS.get(name, 3)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return (klt.pyramid(f32(img0), levels), klt.pyramid(f32(img1), levels),
            f32(pts), f32(init), (dx, dy))


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


LOOP_ITERS = 12
LOOP_CONVERGE_AT = 5


def k4_loop(st, trial, ne_t, max_iters, converge_at, plain=False):
    """A solve's iterations with the trial fixed (`trial`, `ne_t`), its
    cost the state's times 0.95 (accepted, not converged) before iteration
    `converge_at` and times 0.999 from it (accepted, converged: done
    there): as `lm.solve_window_fixed` runs them, the first iteration
    through K4's functional instance setting the WHILE node's handle, the
    later ones a `graphs.run_while` body through its in-place instance;
    `plain`: every iteration through the plain version, functional, as the
    solve ran before the WHILE node."""
    opts = SolveOptions(max_iters=max_iters, tol=1e-2)

    def cost_t(s):
        late = (s.iters >= converge_at - 1).to(s.cost.dtype)
        return s.cost * (0.95 + 0.049 * late)

    if plain:
        for _ in range(max_iters):
            st = k4.accept_step_plain(st, trial, ne_t, cost_t(st),
                                      opts.lm_lambda_down,
                                      opts.lm_lambda_up, opts.tol)
        return st
    handle = graphs.while_handle(st.cost.device)
    st = k4.accept_step(st, trial, ne_t, cost_t(st), opts, handle)

    def body(s, h):
        k4.accept_step(s, trial, ne_t, cost_t(s), opts, h, in_place=True)

    graphs.run_while(body, st, max_iters - 1, handle)
    return st


def loop_args(cfg, device):
    """`k4_loop`'s inputs at `cfg`: the accepted case's state, trial and
    normal equations, in f32, the state before a solve's first iteration
    (no step accepted, none run)."""
    st, trial, ne_t, _, _ = accept_case(cfg, torch.float32, device,
                                        "accepted")
    st = st._replace(n_acc=torch.zeros_like(st.n_acc),
                     iters=torch.zeros_like(st.iters))
    return st, trial, ne_t


def tree_err(got, ref):
    """Largest absolute difference over two trees' leaves (NaN where both
    are NaN counts as equal); inf where an integer or bool leaf differs."""
    err = 0.0
    for a, b in zip(graphs.leaves(got), graphs.leaves(ref)):
        if a.is_floating_point():
            same_nan = torch.isnan(a) & torch.isnan(b)
            d = torch.where(same_nan, torch.zeros_like(a),
                            (a.double() - b.double()).abs())
            err = max(err, float(torch.nan_to_num(d, nan=float("inf")).max()))
        elif not torch.equal(a, b):
            err = float("inf")
    return err


def traced_kernels(fn, name):
    """The device kernels whose name holds `name` that a torch.profiler
    trace of `fn()` saw (a kernel inside a conditional node's body, which
    the card launches itself, included only if the tracer sees it)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(name in e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda)


def phase_while_node():
    """The LM's exit (`graphs.run_while`: a CUDA-graph WHILE node from
    `csrc/graph_cond.cu` whose condition K4 sets) on `k4_loop` at the e2e
    window, f32: the captured program replayed, held bit for bit to the
    plain loop and to the same loop run eagerly (every trip), for a solve
    that converges at iteration LOOP_CONVERGE_AT (the node ran
    LOOP_CONVERGE_AT - 1 trips, counted on the card, K4 launched once a
    trip and once before the node) and one that runs all LOOP_ITERS. Times
    by CUDA events over replays: the node's program, the plain loop's
    program (every iteration, as captured solves ran before the node), ms
    an iteration each; and the K4 launches a torch.profiler trace of one
    replay sees (whether the tracer sees kernels inside the node's
    body)."""
    dev = torch.device("cuda")
    cfg = FACTOR_WINDOWS["e2e"]
    args = loop_args(cfg, dev)
    cache = graphs.ProgramCache()
    rec = {"phase": "while_node", "window": dict(cfg._asdict()),
           "max_iters": LOOP_ITERS}
    err = 0.0
    for conv in (LOOP_CONVERGE_AT, LOOP_ITERS + 1):
        static = dict(max_iters=LOOP_ITERS, converge_at=conv)
        prog = cache.get(k4_loop, args, dev, static)
        reset_counts()
        got = graphs.clone(prog(*args))
        st_g = graphs.stats()
        launches = k4.counts()["lm_accept"]
        eager = k4_loop(*graphs.clone(args), **static)
        plain = k4_loop(*graphs.clone(args), **static, plain=True)
        torch.cuda.synchronize()
        key = "converging" if conv <= LOOP_ITERS else "full"
        rec[key] = {"iters": int(got.iters), "done": bool(got.done),
                    "trips": st_g["while_trips"],
                    "k4_launches_replayed": launches,
                    "err_plain": tree_err(got, plain),
                    "err_eager": tree_err(got, eager)}
        err = max(err, rec[key]["err_plain"], rec[key]["err_eager"])
        rec[key]["traced_k4_launches"] = traced_kernels(
            lambda: prog(*args), "lm_accept_kernel")
        t_node = replay_times(prog, reps=20)
        t_plain = replay_times(cache.get(k4_loop, args, dev,
                                         {**static, "plain": True}), reps=20)
        rec[key].update(node_ms=t_node["replay_device_ms"],
                        plain_ms=t_plain["replay_device_ms"])
    full, conv = rec["full"], rec["converging"]
    rec.update(max_abs_err=err,
               ms_per_iteration=full["node_ms"] / LOOP_ITERS,
               plain_ms_per_iteration=full["plain_ms"] / LOOP_ITERS)
    emit(rec)
    if not (err == 0.0 and conv["iters"] == LOOP_CONVERGE_AT and conv["done"]
            and conv["trips"] == LOOP_CONVERGE_AT - 1
            and conv["k4_launches_replayed"] == LOOP_CONVERGE_AT
            and full["iters"] == LOOP_ITERS
            and full["trips"] == LOOP_ITERS - 1):
        raise SystemExit(f"the WHILE node disagrees with its plain loop, "
                         f"or ran other trips than the loop needed: {rec}")
    return rec


ACCEPT_LANES = 8


def stack_tree(items):
    """Equal-shaped trees of tensors (named or plain tuples) stacked into
    one with a leading lane axis."""
    first = items[0]
    if isinstance(first, tuple):
        parts = [stack_tree(list(f)) for f in zip(*items)]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(
            parts)
    return torch.stack(items)


def accept_bound_ms(leaves, dtype, moved):
    """K4's least time: `moved` (the leaves copied: 1 on an accept or in
    the functional instance, 0 on an in-place rejection) times every
    leaf read once and written once, over the HBM rate, beside its
    operations (a few dozen a lane) over the card's rate for `dtype`."""
    byts = moved * 2 * sum(t.numel() * t.element_size() for t in leaves)
    rate = F64_FLOP_PER_S if dtype == torch.float64 else F32_FLOP_PER_S
    t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, 30 / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": byts}


def phase_lm_accept():
    """K4 (`csrc/lm_accept.cu`) against its plain version on the card at
    the e2e window, f32 and f64, in every case of `ACCEPT_CASES`
    (accepted, rejected, done, NaN and infinite trial cost, at `tol`,
    lambda at both clamps): the functional instance, the in-place one,
    and the functional one under torch.func.vmap over ACCEPT_LANES lanes
    of mixed cases (one launch); every output equal bit for bit
    (`max_abs_err` 0 gated), one launch counted a call. Times by CUDA
    events over the replay of a graph of launches: the functional
    instance on an accept (`ms`), the in-place one on an accept and on a
    rejection, the vmapped launch; the plain version as a replayed graph,
    functional (`plain_ms`) and in place (its copy into the state, as the
    IF nodes' bodies ran it before K4). First a line of each instance's
    resources (`lm_kernels.kernel_attributes`) beside the ptxas log."""
    dev = torch.device("cuda")
    cfg = FACTOR_WINDOWS["e2e"]
    attributes = k4.kernel_attributes()
    emit({"phase": "lm_accept", "attributes": attributes,
          "ptxas": [ln.strip() for ln in
                    cuda_build.build_log.get("lm_accept", "").splitlines()
                    if "Compiling entry" in ln or "registers" in ln
                    or "spill" in ln]})
    out = {}
    for dtype in (torch.float32, torch.float64):
        rec = {"phase": "lm_accept", "dtype": str(dtype),
               "window": dict(cfg._asdict()), "err": {}, "counted": True}
        for case in ACCEPT_CASES:
            st, trial, ne_t, cost_t, opts = accept_case(cfg, dtype, dev, case)
            ref = k4.accept_step_plain(st, trial, ne_t, cost_t,
                                       opts.lm_lambda_down,
                                       opts.lm_lambda_up, opts.tol)
            n0 = k4.accept_step.launches
            got = k4.accept_step(st, trial, ne_t, cost_t, opts)
            inp = graphs.clone(st)
            k4.accept_step(inp, trial, ne_t, cost_t, opts, in_place=True)
            torch.cuda.synchronize()
            rec["counted"] &= k4.accept_step.launches == n0 + 2
            rec["err"][case] = max(tree_err(got, ref), tree_err(inp, ref))
        # vmapped: lane k in case k mod the cases, its own draw
        names = list(ACCEPT_CASES)
        lanes = [accept_case(cfg, dtype, dev, names[k % len(names)], seed=k)
                 for k in range(ACCEPT_LANES)]
        opts = lanes[0][4]
        stacked = [stack_tree([ln[k] for ln in lanes]) for k in range(4)]

        def one(s, tr, ne, c):
            return k4.accept_step(s, tr, ne, c, opts)

        n0 = k4.accept_step.launches
        got = torch.func.vmap(one)(*stacked)
        rec["vmapped_launches"] = k4.accept_step.launches - n0
        rec["vmapped_err"] = max(
            tree_err(graphs.tree_map(lambda t, k=k: t[k], got),
                     k4.accept_step_plain(*ln[:4], opts.lm_lambda_down,
                                          opts.lm_lambda_up, opts.tol))
            for k, ln in enumerate(lanes))
        # times at the accepted case
        st, trial, ne_t, cost_t, opts = accept_case(cfg, dtype, dev,
                                                    "accepted")
        leaves = graphs.leaves(st.p) + list(st.ne)
        work = graphs.clone(st)
        cost0 = st.cost.clone()

        def in_place_accept():
            work.cost.copy_(cost0)  # accept again: 8 bytes
            k4.accept_step(work, trial, ne_t, cost_t, opts, in_place=True)

        rejected = graphs.clone(st)._replace(
            cost=torch.zeros((), dtype=dtype, device=dev))
        work_plain = graphs.clone(st)
        rec.update(
            ms=graph_ms(lambda: k4.accept_step(st, trial, ne_t, cost_t,
                                               opts), 20),
            in_place_accept_ms=graph_ms(in_place_accept, 20),
            in_place_reject_ms=graph_ms(
                lambda: k4.accept_step(rejected, trial, ne_t, cost_t, opts,
                                       in_place=True), 20),
            vmapped_ms=graph_ms(lambda: torch.func.vmap(one)(*stacked), 10),
            plain_ms=graph_ms(lambda: k4.accept_step_plain(
                st, trial, ne_t, cost_t, opts.lm_lambda_down,
                opts.lm_lambda_up, opts.tol), 5),
            plain_in_place_ms=graph_ms(lambda: k4.accept_step_plain(
                work_plain, trial, ne_t, cost_t, opts.lm_lambda_down,
                opts.lm_lambda_up, opts.tol, in_place=True), 5),
            in_place_reject_bound_ms=accept_bound_ms(leaves, dtype, 0)[
                "bound_ms"],
            **accept_bound_ms(leaves, dtype, 1))
        rec["max_abs_err"] = max(max(rec["err"].values()), rec["vmapped_err"])
        emit(rec)
        out[str(dtype)] = rec
        if not (rec["max_abs_err"] == 0.0 and rec["counted"]
                and rec["vmapped_launches"] == 1):
            raise SystemExit(f"K4 lm_accept disagrees with its plain version "
                             f"(bit for bit, one launch a call, vmapped one "
                             f"launch): {rec}")
    f32 = out[str(torch.float32)]
    return {**{k: f32[k] for k in (
        "ms", "in_place_accept_ms", "in_place_reject_ms", "vmapped_ms",
        "plain_ms", "plain_in_place_ms", "bound_ms", "bound_by",
        "in_place_reject_bound_ms")},
        "max_abs_err": max(r["max_abs_err"] for r in out.values()),
        "f64": {k: out[str(torch.float64)][k]
                for k in ("ms", "plain_ms", "bound_ms")},
        "attributes": attributes}


def phase_k1_track():
    """The fused track against `lk_track_plain`, 150 features, 10
    iterations, fb_thresh and min_eig of `KLTConfig`. Positions within
    1e-3 px where both say ok; ok equal except where the plain version's
    fb lies within 1e-3 px of fb_thresh, its min_eig within 1e-4 relative
    of min_eig, or its position within 1e-3 px of the in-bounds edge
    (counted as `n_near_gate`); min_eig within 1e-4 relative; the known
    shift recovered to 0.15 px. Times: `device_ms` by graph replay of
    whole tracks, `ms` by CUDA events over back-to-back calls, `plain_ms`;
    the bound of the 2L level-passes; the latency floor's 2L x (1
    template + iters rounds) dependent reductions. The launch is counted
    under its level count. What the
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
        by_levels = lk.lk_track.launches_by_levels.get(L, 0)
        out_k, ok_k, eig_k = lk.lk_track(*args)
        counted = lk.lk_track.launches_by_levels.get(L, 0) == by_levels + 1
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
        if not (counted and pos_err <= 1e-3 and ok_agree and eig_rel <= 1e-4
                and rec["shift_err_px"] <= 0.15 and rec["n_ok"] >= N // 2
                and (name != "large_motion"
                     or rec["n_beyond_window"] >= N // 2)):
            raise SystemExit(f"K1 (fused track) disagrees with its plain "
                             f"version: {rec}")

    # the kernels line's times: the fused tracker's three-level cases
    three = [r for r in cases if len(r["levels"]) == 3]

    def mean(key):
        return float(np.mean([r[key] for r in three]))

    def case(name):
        rec = next(r for r in cases if r["case"] == name)
        return {k: rec[k] for k in ("max_pos_err_px", "ms", "device_ms",
                                    "plain_ms", "bound_ms")}

    return {"max_abs_err": max(r["max_pos_err_px"] for r in cases),
            "ms": mean("ms"), "device_ms": mean("device_ms"),
            "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
            "bound_by": cases[0]["bound_by"],
            "four_levels": case("four_levels"),
            "two_levels": case("two_levels")}


# K2 and K3 (`csrc/factors.cu`) at the windows of the e2e phase and of the
# batch phase (`sim/windows.py::FACTOR_WINDOWS`), each held to its plain
# version within FACTOR_TOL of each output's largest entry
FACTOR_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
FACTOR_LANES = 8
# operations a factor slot, estimated from `csrc/factors.cu`: K2 ~2.1k for
# each of its two observation times (blending, deltas, rotation and
# per-knot Jacobians, positions, velocity), ~0.6k for the residual and its
# blocks, ~2 a row entry (2 x 259); K3 12 dual passes of ~0.7k dual
# operations (~3 real operations each) and ~2 a row entry (6 x 259)
K2_OPS_SLOT = 6000
K3_OPS_SLOT = 28000
# K5, likewise: an image slot ~0.45k for each observation time (blending,
# 3 deltas, the spline's 3 exponentials and products, position) and ~0.15k
# for the transfer, residual, cost and terms; an IMU slot ~0.75k (deltas,
# body rate, rotation, acceleration, residual and |r|^2); a knot's
# boxminus ~0.1k (3 entries, each a product, a log); 4 an entry of J (its
# product with x [-] x0 and its square); the sums a few a term
K5_OPS_IMAGE_SLOT = 1050
K5_OPS_IMU_SLOT = 750
K5_OPS_KNOT = 100
K5_OPS_J_ENTRY = 4
# each factor kernel's name in the kernels line and the record_function
# range of the megastep that runs it
FACTOR_KERNELS = {
    "k2": ("K2 image_factor_rows", "image factors"),
    "k3": ("K3 imu_factor_rows", "IMU factors"),
    "k5": ("K5 residual_summary", "residual summary")}
# K5 against its plain version: each of its five outputs within this of
# that output's largest entry (f32 FACTOR_TOL's)
SUMMARY_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}


def k5_ops(cfg):
    """K5's operations at `cfg`'s window (what its bound counts)."""
    return (K5_OPS_IMAGE_SLOT * cfg.OBS + K5_OPS_IMU_SLOT * cfg.MIMU
            + K5_OPS_KNOT * cfg.KW + K5_OPS_J_ENTRY * cfg.C * cfg.C)
# H100 SXM f64 rate outside the tensor cores (NVIDIA data sheet)
F64_FLOP_PER_S = 34e12


def factor_calls(window, cfg, marg_mode):
    """(K2 call, K2 plain call, K3 call, K3 plain call) on `window` as
    `assemble.linearize` makes them, marg_mode as it takes it."""
    params, img, imu, ext, grav, info, w = window
    act_i = (img.valid & img.marg_drop) if marg_mode else img.valid
    act_m = (imu.valid & imu.marg_drop) if marg_mode else imu.valid
    c = 1.0 if marg_mode else SolveOptions().cauchy_c

    def k2(f=fk.image_factor_rows):
        return f(params, img, act_i, ext, w, c, cfg)

    def k3(f=fk.imu_factor_rows):
        return f(params, imu, act_m, grav, info, cfg)

    return (k2, lambda: k2(fk.image_factor_rows_plain), k3,
            lambda: k3(fk.imu_factor_rows_plain))


def summary_calls(window, cfg):
    """(K5 call, K5 plain call) on `window` (`summary_window`'s) as
    `assemble.residual_rms` and `total_cost` make them."""
    c = SolveOptions().cauchy_c

    def k5(f=fk.residual_summary):
        return f(*window, c, cfg)

    return k5, lambda: k5(fk.residual_summary_plain)


def kernel_calls(kname, window, cfg, marg_mode=False):
    """(kernel call, plain call) of `kname` ("k2", "k3", "k5") on `window`
    (K5's a `summary_window`); marg_mode for K2 and K3. Each call returns
    a tuple of its outputs."""
    if kname == "k5":
        k5, p5 = summary_calls(window, cfg)
        return (lambda: (k5(),)), (lambda: (p5(),))
    calls = factor_calls(window, cfg, marg_mode)
    k = 0 if kname == "k2" else 2
    return calls[k], calls[k + 1]


def kernel_wrapper(kname):
    """The wrapper whose `launches` counts `kname`'s launches."""
    return {"k2": fk.image_factor_rows, "k3": fk.imu_factor_rows,
            "k5": fk.residual_summary}[kname]


def kernel_inputs(kname, window):
    """The op's tensor inputs of `kname` on `window` (what its bound
    counts as read)."""
    if kname == "k5":
        return fk.summary_inputs(*window)
    params, img, imu, ext, grav, info, w = window
    return {"k2": lambda: fk.image_inputs(params, img, img.valid, ext, w),
            "k3": lambda: fk.imu_inputs(params, imu, imu.valid, grav,
                                        info)}[kname]()


def lane_args(kname, window):
    """What of `window` is a lane's own under torch.func.vmap: its
    parameters and `kname`'s factors (K5: every factor and the prior)."""
    if kname == "k5":
        return window[:5]
    return window[0], window[1 if kname == "k2" else 2]


def lane_call(kname, cfg, side):
    """`kname`'s wrapper as a function of one lane's `lane_args`, the
    window's constants `side` (ext, gravity, imu_info, sqrt_info) shared:
    what torch.func.vmap maps over the lanes. Returns a tuple of its
    outputs."""
    ext, grav, info, w = side
    c = SolveOptions().cauchy_c

    def call(p, *fa):
        if kname == "k2":
            return fk.image_factor_rows(p, fa[0], fa[0].valid, ext, w, c,
                                        cfg)
        if kname == "k3":
            return fk.imu_factor_rows(p, fa[0], fa[0].valid, grav, info,
                                      cfg)
        return (fk.residual_summary(p, *fa, ext, grav, info, w, c, cfg),)

    return call


def rel_err(got, ref):
    """Largest deviation of each output from its plain version, over that
    output's largest entry."""
    return max(float((a.double() - b.double()).abs().max())
               / max(float(b.double().abs().max()), 1e-30)
               for a, b in zip(got, ref))


def abs_err(got, ref):
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(got, ref))


def factor_bound_ms(inputs, outputs, ops, dtype):
    """The least time for a launch: each input read once and each output
    written once over the HBM rate, or its operations over the card's
    rate for `dtype`; the larger, and which it is."""
    byts = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    rate = F64_FLOP_PER_S if dtype == torch.float64 else F32_FLOP_PER_S
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bytes": byts, "operations": ops}


def replays_equal(fn):
    """Whether two replays of a CUDA graph of one fn() give the same bits
    (no atomic, no order that changes from replay to replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    first = [x.clone() for x in out]
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, out))


def col_rel_err(got, ref):
    """K5's largest deviation from its plain version over its outputs,
    each relative to that output's largest entry over the lanes."""
    a, b = got[0].double().reshape(-1, 5), ref[0].double().reshape(-1, 5)
    return float(((a - b).abs().amax(0)
                  / b.abs().amax(0).clamp(min=1e-300)).max())


def phase_factor_kernels():
    """K2, K3 and K5 against their plain versions on the card, at e2e's
    window and batch's (K5's with bias pairs and a prior,
    `sim/windows.py::summary_window`), in f32 (the per-frame solve and
    residual summary) and f64 (the bootstrap BA, the host-side prior), K2
    and K3 with `marg_mode` off and on: every output of K2 and K3 within
    FACTOR_TOL of its largest entry, each of K5's five within SUMMARY_TOL
    of itself, one launch counted a call; unbatched, and under
    torch.func.vmap over FACTOR_LANES windows (each lane its own
    perturbation of the window, the constants shared): one launch, every
    lane equal bit for bit to its own unbatched launch; two replays of a
    graph of one launch give the same bits. Int32 indices give int64's
    results bit for bit (K2, K5). Times: `ms` by CUDA events over
    the replay of a graph of launches (the card's time a launch),
    `call_ms` by events over back-to-back calls (with the host's
    dispatch), `plain_ms` the plain version's by events over back-to-back
    calls, `plain_graph_ms` by a graph's replay (what a captured solve
    paid for it before these kernels); `vmapped_ms` one launch over the
    lanes by a graph's replay. First a line of each instance's resources
    (`factor_kernels.kernel_attributes`: registers, local spill bytes,
    static shared bytes, threads a block) beside the ptxas log of the
    build."""
    dev = torch.device("cuda")
    attributes = fk.kernel_attributes()
    emit({"phase": "factor_kernels", "attributes": attributes,
          "ptxas": [ln.strip() for ln in
                    cuda_build.build_log.get("factors", "").splitlines()
                    if "Compiling entry" in ln or "registers" in ln
                    or "spill" in ln]})
    out = {}
    for name, cfg in FACTOR_WINDOWS.items():
        for dtype in (torch.float32, torch.float64):
            window = factor_window(cfg, dtype, dev)
            lanes = [factor_window(cfg, dtype, dev, seed=7 + k)
                     for k in range(FACTOR_LANES)]
            windows = {"k2": (window, lanes), "k3": (window, lanes), "k5": (
                summary_window(cfg, dtype, dev, window=window),
                [summary_window(cfg, dtype, dev, seed=7 + k, window=w)
                 for k, w in enumerate(lanes)])}
            params, img, imu = window[:3]
            rec = {"phase": "factor_kernels", "window": name,
                   "cfg": dict(cfg._asdict()), "dtype": str(dtype),
                   "image_slots_valid": int(img.valid.sum()),
                   "image_slots_marg": int((img.valid & img.marg_drop).sum()),
                   "imu_slots_valid": int(imu.valid.sum())}
            ops = {"k2": K2_OPS_SLOT * cfg.OBS, "k3": K3_OPS_SLOT * cfg.MIMU,
                   "k5": k5_ops(cfg)}
            for kname in FACTOR_KERNELS:
                win, win_lanes = windows[kname]
                counter = kernel_wrapper(kname)
                k = {"rel_err": {}, "abs_err": {}, "counted": True}
                for marg in ((False, True) if kname in ("k2", "k3")
                             else (False,)):
                    kern, plain = kernel_calls(kname, win, cfg, marg)
                    n0 = counter.launches
                    got = kern()
                    k["counted"] &= counter.launches == n0 + 1
                    ref = plain()
                    torch.cuda.synchronize()
                    key = "marg" if marg else "solve"
                    k["rel_err"][key] = (col_rel_err(got, ref)
                                         if kname == "k5"
                                         else rel_err(got, ref))
                    k["abs_err"][key] = abs_err(got, ref)
                    if kname == "k5":
                        k["values"] = got[0].tolist()
                # vmapped over the lanes against each lane's own launch
                vmapped = lane_call(kname, cfg, win[3:] if kname != "k5"
                                    else win[5:])
                own = [lane_args(kname, w) for w in win_lanes]
                stacked = [batch.stack([a[i] for a in own])
                           for i in range(len(own[0]))]
                n0 = counter.launches
                got_b = torch.func.vmap(vmapped)(*stacked)
                k["vmapped_launches"] = counter.launches - n0
                each = [vmapped(*a) for a in own]
                k["vmapped_equal"] = all(
                    torch.equal(got_b[f][ln], each[ln][f])
                    for ln in range(FACTOR_LANES) for f in range(len(got_b)))
                if kname != "k3" and dtype == torch.float32:
                    # the same window with int32 indices
                    a = list(lane_args(kname, win))
                    a[1] = a[1]._replace(**{
                        f: getattr(a[1], f).to(torch.int32)
                        for f in ("i0_i", "i0_j", "lm_idx")})
                    if kname == "k5":
                        a[2] = a[2]._replace(**{
                            f: getattr(a[2], f).to(torch.int32)
                            for f in ("i0", "bias_idx")})
                    k["int32_equal"] = all(
                        torch.equal(x, y) for x, y in zip(
                            vmapped(*a), vmapped(*lane_args(kname, win))))
                kern, plain = kernel_calls(kname, win, cfg)
                k["replays_equal"] = replays_equal(kern)
                k["ms"] = graph_ms(kern, 20)
                k["call_ms"] = time_cuda(kern, 50)
                k["plain_ms"] = time_cuda(plain, 5)
                k["plain_graph_ms"] = graph_ms(plain, 2)
                k["vmapped_ms"] = graph_ms(lambda: torch.func.vmap(vmapped)(
                    *stacked), 10)
                k.update(factor_bound_ms(kernel_inputs(kname, win), kern(),
                                         ops[kname], dtype))
                rec[kname] = k
            emit(rec)
            out[(name, str(dtype))] = rec
            for kname in FACTOR_KERNELS:
                k = rec[kname]
                tol = (SUMMARY_TOL if kname == "k5" else FACTOR_TOL)[dtype]
                if not (max(k["rel_err"].values()) <= tol and k["counted"]
                        and k["vmapped_launches"] == 1
                        and k["vmapped_equal"] and k["replays_equal"]
                        and k.get("int32_equal", True)):
                    raise SystemExit(f"{FACTOR_KERNELS[kname][0]} disagrees "
                                     f"with its plain version (within {tol} "
                                     f"of the largest entry, one launch a "
                                     f"call, vmapped equal to its lanes, two "
                                     f"replays equal): {rec}")

    def summary(kname):
        main = out[("e2e", str(torch.float32))][kname]
        return {"max_abs_err": max(main["abs_err"].values()),
                "max_rel_err": max(max(r[kname]["rel_err"].values())
                                   for r in out.values()),
                **{f: main[f] for f in ("ms", "call_ms", "plain_ms",
                                        "plain_graph_ms", "vmapped_ms",
                                        "bound_ms", "bound_by", "bytes",
                                        "operations")},
                "f64": {f: out[("e2e", str(torch.float64))][kname][f]
                        for f in ("ms", "plain_ms", "bound_ms")},
                "batch_window": {f: out[("batch", str(torch.float32))][kname][f]
                                 for f in ("ms", "plain_ms", "bound_ms")}}

    return {kname: {**summary(kname), "attributes": {
        name.split(" ", 1)[1]: a for name, a in attributes.items()
        if name.split(" ")[0] == FACTOR_KERNELS[kname][0].split(" ")[0]}}
        for kname in FACTOR_KERNELS}


def image_sim(duration, n_landmarks, speed=1.0):
    """`bench.py --mode image`'s sequence: reference IMU noise without the
    simulator's pixel noise (the images carry their own), seed 3; `speed`
    scales the motion (`SimConfig.speed`)."""
    noise = {k: v for k, v in synthetic.REFERENCE_NOISE.items()
             if k != "pixel_noise"}
    return synthetic.generate(synthetic.SimConfig(
        duration=duration, n_landmarks=n_landmarks, seed=3, image_h=1024,
        image_w=1280, speed=speed, **noise))


def image_vio_config(stream, marg_on_host=True):
    """`bench.py --mode image`'s estimator (`bench.py:452-455`), f32."""
    return VIOConfig(
        window_config=WindowConfig(KW=32, NB=11, LM=256, OBS=768, MIMU=256),
        fix_ld=False, ld_init=0.0, ld_upper=3.5e-5, dtype=torch.float32,
        stream=stream, marg_on_host=marg_on_host)


@contextlib.contextmanager
def device_trace():
    """A torch.profiler session over the card's activity only: the traced
    frame's kernels and copies (what `device_share` reads); aggregating a
    frame's host events as well took the profiler up to a minute. On
    exit the session's `k4_run` holds the K4 launches the traced span ran
    (the settled counts: a WHILE node's trips included), which
    `device_share` holds the trace's own K4 launches to."""
    k0 = k4.counts()["lm_accept"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield prof
    prof.k4_run = k4.counts()["lm_accept"] - k0


def replay(sim, imgs, camera, tcfg, vio_cfg, device, probe=None):
    """The image-in main path, as `bench.py --mode image` drives it with
    lag=0 and the synchronous estimator: per frame, the gyro-predicted
    rotation, `FusedTracker.step` and `CtrlVIO.process_frame`. Returns the
    estimated and true positions of the solved frames, the published
    features, the estimator, the host times of each frame from the fifth
    on (as the bench times them) but the last, the programs captured
    during those timed frames, and a `torch.profiler` trace of the last
    frame.
    `probe(vio)` runs after each solved frame, outside its timed span."""
    timed_from = 4
    H, W = imgs.shape[1:]
    tracker = FusedTracker(tcfg, camera, (H, W), device=device)
    R_CtoI = so3np.quat_to_matrix(so3np.quat_exp(
        np.asarray(sim.cfg.ext_rot, np.float64))[None])[0]
    vio = started_vio(sim, vio_cfg, device)
    imgs_dev = torch.as_tensor(imgs, device=device)
    est, gt, feats = [], [], []

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
        feats.append(feat)
        out = None
        if feat is not None and len(feat["ids"]) >= 8:
            out = vio.process_frame(feat["t_ns"], feat["ids"], feat["pts"],
                                    feat["rows"])
        sync(device)
        t2 = time.perf_counter()
        if out is not None:
            est.append(out[1])
            gt.append(sim.pose_at(feat["t_ns"] * 1e-9)[1])
            if probe is not None:
                probe(vio)
        return t1 - t0, t2 - t1

    n = len(sim.frames)
    times = []
    for i in range(n - 1):
        if i == timed_from:
            vio.timing.clear()
            tracker.timing.clear()
            captures = len(graphs.stats()["graphs_captured"])
        times.append(frame(i))
    timing = dict(vio.timing)  # the estimator's phases, unprofiled frames
    fe_timing = dict(tracker.timing)
    captures = len(graphs.stats()["graphs_captured"]) - captures
    with device_trace() as prof:
        t_last = sum(frame(n - 1))
    vio.flush()
    times = np.asarray(times[timed_from:])
    return dict(est=np.asarray(est), gt=np.asarray(gt), feats=feats,
                vio=vio, n_frames=n, t_feat=times[:, 0], t_est=times[:, 1],
                timing=timing, fe_timing=fe_timing, prof=prof,
                prof_s=t_last, captures_in_timed_frames=captures)


# what `device_share` reads off a trace, which a trace that misses
# kernels only bounds from below
TRACE_SUMS = ("device_ms", "device_busy_share", "device_ops",
              "top_device_ms")


def device_share(prof, prof_s, frame_ms):
    """Device time of the profiled frame (kernels and copies on the card),
    its share of `frame_ms` (the median host time of an unprofiled frame:
    the profiler slows the host, not the card), device operations, the
    five kernels that took the most device time, and the K4 and K2
    launches the trace holds beside the K4 launches the frame ran
    (`device_trace`'s `k4_run`). The tracer does not always see the
    kernels of a WHILE node's body: where it saw fewer K4 launches than
    ran, `trace_complete` is false and the TRACE_SUMS fields carry the
    suffix `_lower_bound`."""
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) * 1e-3
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    rec = {"profiled_frame_wall_ms": prof_s * 1e3,
           "device_ms": busy_ms,
           "device_busy_share": busy_ms / frame_ms if dev else None,
           "device_ops": sum(e.count for e in dev),
           "top_device_ms": {e.key[:80]: e.self_device_time_total * 1e-3
                             for e in top},
           **{f"traced_{k}_launches": sum(e.count for e in dev
                                          if name in e.key)
              for k, name in (("k4", "lm_accept_kernel"),
                              ("k2", "image_rows_kernel"))},
           "k4_launches_run": prof.k4_run}
    rec["trace_complete"] = rec["traced_k4_launches"] == prof.k4_run
    if not rec["trace_complete"]:
        for k in TRACE_SUMS:
            rec[f"{k}_lower_bound"] = rec.pop(k)
    return rec


# the record_function ranges of the megastep and the window solve
# (`solver/assemble.py`, `solver/lm.py`, `estimator/stream.py`), the
# kernels each factor range, the LM's accept step and the residual summary
# launch once a call, and the most other device operations a call of it
# may make: a factor range's are the wrapper's casts and copies (4), the
# accept step's none and the summary's the zeroing of its arrival
# counters (both held to the same 4)
STAGES = ("image factors", "IMU factors", "normal equations", "Schur solve",
          "retract", "LM accept", "QR prior", "slide", "residual summary")
STAGE_KERNELS = {"image factors": ("image_rows_kernel",),
                 "IMU factors": ("imu_rows_kernel",),
                 "LM accept": ("lm_accept_kernel",),
                 "residual summary": ("residual_summary_kernel",)}
STAGE_OTHER_OPS = 4
STAGE_OTHER_LIMIT = {n: STAGE_OTHER_OPS for n in STAGE_KERNELS}


def stage_split(prof):
    """Per range of STAGES in a torch.profiler trace with CPU and CUDA
    activity: its calls, the device operations launched from inside it
    (kernels, copies, sets) and their device ms, nested ranges counted in
    each one that holds them; for the factor ranges the launches of their
    kernels (in all, and the fewest and most of any one of them in a
    call) and the most other device operations in one call. A device
    operation belongs to the host op that launched it (the profiler's
    correlation), and so to every range open on that op's thread when it
    started."""
    cuda = torch.autograd.DeviceType.CUDA
    front, dev, ranges = {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if e.name() not in STAGES:
                dev.append(e)
        elif e.linked_correlation_id() == 0:
            front[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
            if e.name() in STAGES:
                ranges.append((e.name(), e.start_thread_id(), e.start_ns(),
                               e.start_ns() + e.duration_ns()))
    held = [[] for _ in ranges]
    unlinked = 0
    for d in dev:
        src = front.get(d.linked_correlation_id())
        if src is None:
            unlinked += 1
            continue
        for i, (_, tid, a, b) in enumerate(ranges):
            if tid == src[0] and a <= src[1] <= b:
                held[i].append(d)
    out = {n: {"calls": 0, "device_ops": 0, "device_ms": 0.0}
           for n in STAGES}
    for (n, *_), ds in zip(ranges, held):
        rec = out[n]
        rec["calls"] += 1
        rec["device_ops"] += len(ds)
        rec["device_ms"] += sum(d.duration_ns() for d in ds) * 1e-6
        kerns = STAGE_KERNELS.get(n)
        if kerns is not None:
            ks = [sum(kern in d.name() for d in ds) for kern in kerns]
            rec["kernel_launches"] = rec.get("kernel_launches", 0) + sum(ks)
            rec["min_kernel_launches_per_call"] = min(
                rec.get("min_kernel_launches_per_call", min(ks)), min(ks))
            rec["max_kernel_launches_per_call"] = max(
                rec.get("max_kernel_launches_per_call", 0), max(ks))
            rec["max_other_ops_per_call"] = max(
                rec.get("max_other_ops_per_call", 0), len(ds) - sum(ks))
    return {"ranges": out, "device_ops": len(dev),
            "device_ms": sum(d.duration_ns() for d in dev) * 1e-6,
            "unlinked_device_ops": unlinked}


def eager_megastep_stages(prog):
    """A streamed megastep's program (`prog`) run once eagerly on copies of
    its inputs (after one eager warm run), profiled with CPU and CUDA
    activity: `stage_split` of it, and its host seconds. A replayed graph
    carries no host ranges; the eager run computes what the replay does,
    every LM iteration included (eagerly the WHILE node's body runs every
    trip)."""
    prog.run_eagerly(graphs.clone(prog.inputs))
    torch.cuda.synchronize()
    inputs = graphs.clone(prog.inputs)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prog.run_eagerly(inputs)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec = stage_split(prof)
    rec.update(host_s=host_s, analysis_s=time.perf_counter() - t0)
    return rec


def stages_hold_their_kernels(st):
    """Each factor range's, the accept step's and the residual summary's
    every call launched each of its kernels once and at most
    STAGE_OTHER_LIMIT other device operations."""
    return all(st["ranges"][n]["calls"] > 0
               and st["ranges"][n]["min_kernel_launches_per_call"] == 1
               and st["ranges"][n]["max_kernel_launches_per_call"] == 1
               and st["ranges"][n]["kernel_launches"]
               == st["ranges"][n]["calls"] * len(kerns)
               and st["ranges"][n]["max_other_ops_per_call"]
               <= STAGE_OTHER_LIMIT[n] for n, kerns in STAGE_KERNELS.items())


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_main():
    """`bench.py --mode image --scene blobs` at full width: 1280x1024
    Kannala-Brandt (`cam_tumrs.yaml`), 150 features, min_dist 25, CLAHE and
    the FB check on, pred_levels 3, the bench's window; f32 solve and f64
    marginalization on the card. Depth cut: 4 s of imagery (the script's
    time limit; the bench renders 12 s). Returns the record and the
    rendered sequence (sim, images, camera, tracker config)."""
    H, W, duration = 1024, 1280, 4.0
    cam = tumrs_camera()
    t0 = time.perf_counter()
    sim = image_sim(duration, 1500)
    imgs = render.render_sequence(sim, H, W, camera=cam, seed=1,
                                  big_every=6, texture=6.0)
    t_render = time.perf_counter() - t0
    tcfg = TrackerConfig(max_cnt=150, min_dist=25, use_clahe=True,
                         fb_check=True, klt=klt.KLTConfig(pred_levels=3))
    vio_cfg = image_vio_config(stream=False)

    # the counts of the main path's run: zero just before, read just after
    reset_counts()
    t0 = time.perf_counter()
    run = replay(sim, imgs, cam, tcfg, vio_cfg, "cuda")
    wall = time.perf_counter() - t0
    launches = lk.lk_track.launches
    level_launches = lk.lk_level.launches
    plain_calls = lk.lk_level_plain.calls + lk.lk_track_plain.calls
    fc = factor_fields()
    g = graph_fields()
    its = iters_fields([run["vio"].lm_iters_record()], g)
    replayed = replay_times(program(odometry._SYNC_PROGRAMS, "window_solve",
                                    "restore=True"))

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
           "frontend_timing_ms_per_frame": {
               k: v / n * 1e3 for k, v in run["fe_timing"].items()},
           "profile_last_frame": device_share(
               run["prof"], run["prof_s"],
               float(np.median(run["t_feat"] + run["t_est"])) * 1e3),
           "captures_in_timed_frames": run["captures_in_timed_frames"],
           "window_solve_replay": replayed, **fc, **its, **g}
    emit(rec)
    finite = bool(np.isfinite(est).all()) and np.isfinite(vio.traj.line_delay)
    if not (finite and len(est) > 20 and ate < 0.15 and ld_err < 5e-6):
        raise SystemExit(f"main path fails its accuracy gates "
                         f"(ATE < 0.15 m, line-delay error < 5 us): {rec}")
    if not k1_once_a_frame(launches, g, run["n_frames"]) or plain_calls:
        raise SystemExit(f"main path did not run through the fused K1 "
                         f"track once a frame: {rec}")
    # the front end's two programs, the window solve, prior and predict,
    # the f64 bootstrap BA
    if not captured_once(g, 6):
        raise SystemExit(f"main path captured a program twice: {rec}")
    if not (iters_exact(rec) and g["while_nodes"] > 0):
        raise SystemExit(f"main path: the LM's exit nodes did not run "
                         f"exactly the iterations its solves needed: {rec}")
    return rec, (sim, imgs, cam, tcfg)


# the JAX package's run of the main phase's path with marg_on_host=False
# (float32, on the CPU, plain LK; `tests/torch_marg_dev_ref.py`): 26 frames
# solved, ATE 0.090385 m, line-delay error 0.2109 us; its float32 prior is
# NaN from the 4th solved frame (index 3) on, and no LM step is accepted
# after it, so the estimator dead-reckons from there. The image gates
# cannot tell a right float32 build from a wrong one: the port's run is held
# to the reference's NaN onset, to no accepted step after it, and to its
# ATE within 1 mm and its line-delay error within 0.01 us.
MARG_DEV_REF = {"first_nonfinite_prior": 3, "accepted_from_then": 0,
                "ate_m": 0.09038535689227546, "ld_err_s": 2.108864795614047e-07}
def phase_main_marg_dev(main_rec, seq):
    """The main phase's path again on the same rendered frames, with
    `VIOConfig(marg_on_host=False)`: the synchronous path's
    marginalization prior built in the solve dtype (f32) on the card
    instead of f64. The image gates as in `main`, every frame after the
    bootstrap solved, finite poses, one K1 launch a frame, and the JAX
    package's run of the same path (`MARG_DEV_REF`); the `prior` phase's
    and the estimator's host ms a frame beside the f64 run's, the solved
    frame whose prior first held a non-finite entry and the LM steps
    accepted from then on."""
    sim, imgs, cam, tcfg = seq
    probes = []

    def probe(vio):
        probes.append((bool(torch.isfinite(vio.prior.J).all()),
                       int(vio.last_solve_stats.accepted)))

    reset_counts()
    t0 = time.perf_counter()
    run = replay(sim, imgs, cam, tcfg,
                 image_vio_config(stream=False, marg_on_host=False), "cuda",
                 probe=probe)
    wall = time.perf_counter() - t0
    launches = lk.lk_track.launches
    plain_calls = lk.lk_level_plain.calls + lk.lk_track_plain.calls
    fc = factor_fields()
    g = graph_fields()

    est, gt, vio = run["est"], run["gt"], run["vio"]
    ate = ate_rmse(est[10:], gt[10:], align="yaw")
    ld_err = abs(vio.traj.line_delay - sim.cfg.line_delay)
    n = len(run["t_feat"])
    bad = [k for k, (ok, _) in enumerate(probes) if not ok]
    first_bad = bad[0] if bad else None
    prior_ms = run["timing"].get("prior", 0.0) / n * 1e3
    rec = {"phase": "main_marg_dev", "marg_on_host": False,
           "frames": run["n_frames"], "solved": len(est),
           "sync_solves": vio.counts["sync_solve"], "wall_s": wall,
           "ate_m": ate, "ld_err_s": ld_err,
           "line_delay_s": vio.traj.line_delay,
           "prior_dtype": str(vio.prior.J.dtype).replace("torch.", ""),
           "prior64_held": vio._prior64 is not None,
           "first_nonfinite_prior": first_bad,
           "accepted_from_then": (None if first_bad is None else
                                  sum(a for _, a in probes[first_bad + 1:])),
           "prior_ms_per_frame": prior_ms,
           "main_prior_ms_per_frame":
               main_rec["timing_ms_per_frame"].get("prior", 0.0),
           "estimator_ms_median": float(np.median(run["t_est"])) * 1e3,
           "estimator_ms_mean": float(np.mean(run["t_est"])) * 1e3,
           "main_estimator_ms_median": main_rec["estimator_ms_median"],
           "main_ate_m": main_rec["ate_m"],
           "k1_track_launches": launches, "plain_lk_calls": plain_calls,
           "timing_ms_per_frame": {k: v / n * 1e3
                                   for k, v in run["timing"].items()},
           "profile_last_frame": device_share(
               run["prof"], run["prof_s"],
               float(np.median(run["t_feat"] + run["t_est"])) * 1e3),
           "captures_in_timed_frames": run["captures_in_timed_frames"],
           **fc, **g}
    emit(rec)
    finite = bool(np.isfinite(est).all()) and np.isfinite(vio.traj.line_delay)
    if not (finite and len(est) == main_rec["solved"]
            and vio.counts["sync_solve"] == len(est) - 1
            and ate < 0.15 and ld_err < 5e-6):
        raise SystemExit(f"main path with marg_on_host=False fails its "
                         f"gates (every frame solved, finite, ATE < 0.15 m, "
                         f"line-delay error < 5 us): {rec}")
    ref = MARG_DEV_REF
    if (first_bad != ref["first_nonfinite_prior"]
            or rec["accepted_from_then"] != ref["accepted_from_then"]
            or abs(ate - ref["ate_m"]) > 1e-3
            or abs(ld_err - ref["ld_err_s"]) > 1e-8):
        raise SystemExit(f"main path with marg_on_host=False departs from "
                         f"the JAX package's run (NaN prior from solved "
                         f"frame 3, no step accepted after, ATE within 1 mm, "
                         f"line-delay error within 0.01 us of {ref}): {rec}")
    if rec["prior_dtype"] != "float32" or rec["prior64_held"]:
        raise SystemExit(f"marg_on_host=False kept the f64 prior: {rec}")
    if not k1_once_a_frame(launches, g, run["n_frames"]) or plain_calls:
        raise SystemExit(f"main path with marg_on_host=False did not run "
                         f"through the fused K1 track once a frame: {rec}")
    if not captured_once(g, 6):
        raise SystemExit(f"main path with marg_on_host=False captured a "
                         f"program twice: {rec}")
    return rec


def phase_e2e():
    """`bench.py`'s default run (`--mode e2e`, the chip preset) on the card
    at full width, its depth cut from the bench's 16 s to 12 s for the
    script's time limit (still >= 40 streamed frames after the bootstrap
    and the 40 warmup frames): `reference_noise(duration=12,
    n_landmarks=300, seed=3)` with spline ground truth, the bench's window, f32, the visual
    bootstrap with reject-and-retry, the native feature table and the
    streaming megastep after its 40 warmup frames; IMU fed 0.25 s ahead
    of each frame, no ground-truth hint. Times as the bench takes them:
    per-frame host time from the frame `stream_warmup + 8` after init
    (`timed_from`), sustained fps = timed frames over their summed time
    plus the final flush() and torch.cuda.synchronize(). One streamed
    frame in the timed region is traced with torch.profiler (after a
    synchronize, ending in one) and left out of the timed frames."""
    duration = 12.0
    t0 = time.perf_counter()
    sim = synthetic.generate(synthetic.reference_noise(
        duration=duration, n_landmarks=300, seed=3, speed=1.0))
    t_sim = time.perf_counter() - t0
    cfg = VIOConfig(
        window_config=WindowConfig(KW=32, NB=11, LM=256, OBS=768, MIMU=256),
        fix_ld=False, ld_init=0.0, dtype=torch.float32, bootstrap="visual",
        stream=True)
    q_CtoI = so3np.quat_exp(np.asarray(sim.cfg.ext_rot, np.float64))
    # the counts of the e2e run: zero just before, read just after
    reset_counts()
    t_run0 = time.perf_counter()
    vio = CtrlVIO(cfg, q_CtoI, np.array(sim.cfg.ext_pos), device="cuda")
    vio.check_dispatch_syncs = True
    est, gt, t_est_ns = [], [], []
    frame_times, kinds = [], []
    init_frame = timed_from = profiled = None
    prof = prof_s = None
    imu_idx = 0
    ahead_ns = int(0.25e9)
    for i, fr in enumerate(sim.frames):
        while imu_idx < len(sim.imu_t_ns) and \
                sim.imu_t_ns[imu_idx] <= fr.t_ns + ahead_ns:
            vio.process_imu(sim.imu_t_ns[imu_idx], sim.gyro[imu_idx],
                            sim.accel[imu_idx])
            imu_idx += 1
        n_mega, n_sync = vio.counts["megastep"], vio.counts["sync_solve"]
        trace = (timed_from is not None and profiled is None
                 and i >= timed_from + 20)
        if trace:
            torch.cuda.synchronize()
            with device_trace() as prof:
                t0 = time.perf_counter()
                out = vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
                torch.cuda.synchronize()
                prof_s = time.perf_counter() - t0
        else:
            t0 = time.perf_counter()
            out = vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
        dt = time.perf_counter() - t0
        kind = ("stream" if vio.counts["megastep"] > n_mega else
                "sync" if vio.counts["sync_solve"] > n_sync else "other")
        if trace:
            profiled = i
            if kind != "stream":
                raise SystemExit(f"e2e: the traced frame {i} did not stream")
        if out is not None:
            if timed_from is None:
                init_frame = i
                timed_from = i + cfg.stream_warmup + 8
            est.append(out[1])
            t_est_ns.append(fr.t_ns)
            gt.append(sim.pose_at(fr.t_ns * 1e-9)[1])
        if timed_from is not None and i == timed_from:
            boot_s = {k: vio.timing.get(k, 0.0) for k in BOOT_KEYS}
            vio.timing.clear()
            captures = len(graphs.stats()["graphs_captured"])
        if timed_from is not None and i >= timed_from and not trace:
            frame_times.append(dt)
            kinds.append(kind)
        elif init_frame is not None and i > init_frame and kind == "sync":
            kinds.append("warmup")
            frame_times.append(dt)
    t0 = time.perf_counter()
    vio.flush()
    torch.cuda.synchronize()
    t_flush = time.perf_counter() - t0
    wall = time.perf_counter() - t_run0
    k1_launches = lk.lk_track.launches + lk.lk_level.launches
    fc = factor_fields()
    g = graph_fields()
    its = iters_fields([vio.lm_iters_record()], g)
    captures = g["graphs_captured_n"] - captures
    mega = program(vio._programs, "marg_old=True", "host_seeds=False")
    replayed = replay_times(mega)
    stages = eager_megastep_stages(mega)

    est, gt = np.asarray(est), np.asarray(gt)
    err = ate_rmse(est[10:], gt[10:], align="yaw")
    base = vio.data_start_ns or 0
    post = np.stack([vio.traj.pose(t - base)[1][0] for t in t_est_ns])
    err_post = ate_rmse(post[10:], gt[10:], align="yaw")
    ld_err = abs(vio.traj.line_delay - sim.cfg.line_delay)
    kinds = np.asarray(kinds)
    times = np.asarray(frame_times, np.float64)
    timed = times[kinds != "warmup"]
    n_timed = len(timed)
    streamed = times[kinds == "stream"]
    warm = times[kinds == "warmup"]
    c = vio.counts
    rec = {"phase": "e2e", "duration_s": duration, "sim_s": t_sim,
           "wall_s": wall, "frames": len(sim.frames), "solved": len(est),
           "init_frame": init_frame,
           "bootstrap_visual": c["bootstrap_visual"],
           "bootstrap_rejections": c["bootstrap_rejected"],
           "sync_solves": c["sync_solve"],
           "sync_solves_after_handoff": c["sync_solve_after_handoff"],
           "streamed_frames": int((kinds == "stream").sum()) + (
               1 if profiled is not None else 0),
           "megastep_calls": c["megastep"],
           "megastep_syncs": c["megastep_syncs"],
           "sync_messages": sorted(set(vio.sync_warnings))[:5],
           "marg_overflows": c["marg_overflow"],
           "ate_online_m": err, "ate_posthoc_m": err_post,
           "line_delay_s": vio.traj.line_delay,
           "line_delay_true_s": sim.cfg.line_delay, "ld_err_s": ld_err,
           "timed_from": timed_from, "timed_frames": n_timed,
           "frame_ms_median": float(np.median(timed)) * 1e3,
           "sustained_fps": n_timed / (float(np.sum(timed)) + t_flush),
           "flush_s": t_flush,
           "warmup_ms_median": float(np.median(warm)) * 1e3
           if len(warm) else None, "warmup_frames": len(warm),
           "streamed_ms_median": float(np.median(streamed)) * 1e3
           if len(streamed) else None,
           "streamed_ms_mean": float(np.mean(streamed)) * 1e3
           if len(streamed) else None,
           "timing_ms_per_frame": {k: v / max(n_timed, 1) * 1e3
                                   for k, v in vio.timing.items()},
           "k1_launches": k1_launches,
           "profiled_frame": profiled,
           "profile_streamed_frame": device_share(
               prof, prof_s, float(np.median(streamed)) * 1e3)
           if prof is not None and len(streamed) else None,
           "captures_in_timed_frames": captures,
           "bootstrap_s": boot_s,
           "megastep_replay": replayed, "eager_megastep_stages": stages,
           **fc, **its, **g}
    emit(rec)
    finite = bool(np.isfinite(est).all()) and np.isfinite(vio.traj.line_delay)
    if not (finite and err < 0.10 and err_post < 0.10 and ld_err < 2e-6):
        raise SystemExit(f"e2e fails bench.py's gates (online and post-hoc "
                         f"ATE < 0.10 m, line-delay error < 2 us): {rec}")
    if not (vio.initialized and c["bootstrap_visual"] >= 1
            and c["megastep"] >= 40 and c["sync_solve_after_handoff"] == 0
            and c["megastep_syncs"] == 0 and prof is not None):
        raise SystemExit(f"e2e did not run the streamed path as required "
                         f"(visual bootstrap, >= 40 megasteps, no sync solve "
                         f"after the handoff, no sync inside a megastep, "
                         f"one traced streamed frame): {rec}")
    # the megastep a slide branch and seed source, the synchronous four
    if not captured_once(g, 4 + 4) or g["replays"] < c["megastep"]:
        raise SystemExit(f"e2e did not replay a captured megastep on every "
                         f"streamed frame, or captured a program twice: "
                         f"{rec}")
    if not iters_exact(rec):
        raise SystemExit(f"e2e: the LM's exit nodes did not run exactly the "
                         f"iterations its solves needed: {rec}")
    if not stages_hold_their_kernels(stages):
        raise SystemExit(f"e2e: an eager megastep's factor, accept and "
                         f"summary ranges did not each launch each of their "
                         f"kernels once and at "
                         f"most {STAGE_OTHER_LIMIT} other device operations "
                         f"a call: {stages}")
    if captures != 0:
        raise SystemExit(f"e2e captured {captures} programs on timed frames "
                         f"(PERF.md's limit: none): {rec}")
    return rec


# bench.py --mode image's chip preset: 12 s of the textured scene, cut to
# 10 s for the script's time limit
TEXTURED_S = 10.0
CLASSIC_FRAMES = 40
FRAMES_FILE = Path(__file__).resolve().parent / "build" / "textured_frames.npy"


def render_textured(path):
    """Child process: the image_textured phase's frames (host numpy, as in
    `bench.py:437-441`), saved to `path` as uint8 (F, H, W); the seconds
    it took go to `path` + ".json"."""
    t0 = time.perf_counter()
    imgs = render.render_textured_sequence(
        image_sim(TEXTURED_S, 300), 1024, 1280, tumrs_camera(), seed=1,
        n_occluders=4, occluder_speed=0.4, photometric=True,
        pixel_noise=2.0)
    np.save(path, imgs)
    Path(path + ".json").write_text(json.dumps(
        {"render_s": time.perf_counter() - t0}))


def start_render():
    """Render the textured frames in a separate process while the earlier
    phases run (the renderer is host code and takes minutes)."""
    import multiprocessing

    FRAMES_FILE.parent.mkdir(parents=True, exist_ok=True)
    for f in (FRAMES_FILE, Path(str(FRAMES_FILE) + ".json")):
        f.unlink(missing_ok=True)
    proc = multiprocessing.get_context("spawn").Process(
        target=render_textured, args=(str(FRAMES_FILE),), daemon=True)
    proc.start()
    return proc


def textured_frames(proc):
    """Wait for the render process; returns (frames, render_s, wait_s)."""
    t0 = time.perf_counter()
    proc.join()
    wait_s = time.perf_counter() - t0
    if proc.exitcode != 0:
        raise SystemExit(f"textured render failed (exit code {proc.exitcode})")
    meta = Path(str(FRAMES_FILE) + ".json")
    imgs = np.load(FRAMES_FILE)
    render_s = json.loads(meta.read_text())["render_s"]
    FRAMES_FILE.unlink()
    meta.unlink()
    return imgs, render_s, wait_s


def gated_tracker_config():
    """`bench.py:446-449` for the textured scene: cam_tumrs.yaml's tracker
    block with the F-RANSAC gate on."""
    return TrackerConfig(max_cnt=150, min_dist=25, use_clahe=True,
                         fb_check=True, reject_wf=True, f_threshold=1.0,
                         klt=klt.KLTConfig(pred_levels=3))


def phase_image_textured(render_proc):
    """`bench.py --mode image` as its chip preset runs it
    (`bench.py:411-512`), at full width, its depth cut from the preset's
    12 s to 10 s for the script's time limit (still >= 40 megasteps): the
    textured scene (ray-cast room, 4 occluders, the even ones moving at
    0.4 m/s, photometric drift, vignetting, pixel noise) at 1280x1024
    Kannala-Brandt; FusedTracker with the F-RANSAC gate and lag=1; CtrlVIO
    streaming in f32 from the ground-truth bootstrap; images preloaded on
    the card. Per frame: rotation_flow, tracker.step, process_frame; then
    tracker.flush() and vio.flush(). No synchronize inside a frame: host
    times as the bench takes them, from frame `stream_warmup + 10`
    (`timed_from`); sustained fps = timed frames over their summed time
    (`bench.py:527-536`). One streamed frame from timed_from + 20 is traced
    with torch.profiler (after a synchronize, ending in one) and left out
    of the timed frames. Gates: bench.py's (ATE < 0.15 m from the 11th
    solved frame, yaw-aligned; line-delay error < 5 us); one 3-level K1
    track launch a frame and no plain LK call; the F-gate fired; >= 40
    megasteps, none with a synchronizing call, no synchronous solve after
    the handoff. Then the classic tracker's check on the same frames."""
    H, W = 1024, 1280
    cam = tumrs_camera()
    sim = image_sim(TEXTURED_S, 300)
    imgs, render_s, render_wait_s = textured_frames(render_proc)
    imgs_dev = torch.as_tensor(imgs, device="cuda")
    torch.cuda.synchronize()
    cfg = image_vio_config(stream=True)
    R_CtoI = so3np.quat_to_matrix(so3np.quat_exp(
        np.asarray(sim.cfg.ext_rot, np.float64))[None])[0]

    # the counts of this path's run: zero just before, read just after
    reset_counts()
    t_run0 = time.perf_counter()
    tracker = FusedTracker(gated_tracker_config(), cam, (H, W), lag=1,
                           device="cuda")
    tracker.check_dispatch_syncs = True
    vio = started_vio(sim, cfg)
    vio.check_dispatch_syncs = True
    est, gt = [], []

    def estimate(feat):
        if feat is None or len(feat["ids"]) < 8:
            return
        out = vio.process_frame(feat["t_ns"], feat["ids"], feat["pts"],
                                feat["rows"])
        if out is not None:
            est.append(out[1])
            gt.append(sim.pose_at(feat["t_ns"] * 1e-9)[1])

    timed_from = cfg.stream_warmup + 10
    t_feat, t_est, kinds, warm = [], [], [], []
    prof = prof_s = profiled = None
    prev_t = None
    for i, fr in enumerate(sim.frames):
        n_mega, n_sync = vio.counts["megastep"], vio.counts["sync_solve"]
        trace = i >= timed_from + 20 and profiled is None
        if trace:
            torch.cuda.synchronize()
        if i == timed_from:
            vio.timing.clear()
            tracker.timing.clear()
            captures = len(graphs.stats()["graphs_captured"])
        with (device_trace() if trace
              else contextlib.nullcontext()) as p:
            t0 = time.perf_counter()
            M = (rotation_flow(sim.imu_t_ns, sim.gyro, prev_t, fr.t_ns,
                               R_CtoI) if prev_t is not None else None)
            feat = tracker.step(fr.t_ns, imgs_dev[i], R_rel=M)
            prev_t = fr.t_ns
            t1 = time.perf_counter()
            estimate(feat)
            if trace:
                torch.cuda.synchronize()
            t2 = time.perf_counter()
        kind = ("stream" if vio.counts["megastep"] > n_mega else
                "sync" if vio.counts["sync_solve"] > n_sync else "other")
        if trace:
            prof, prof_s, profiled = p, t2 - t0, i
            if kind != "stream":
                raise SystemExit(f"image_textured: the traced frame {i} "
                                 f"did not stream")
        elif i >= timed_from:
            t_feat.append(t1 - t0)
            t_est.append(t2 - t1)
            kinds.append(kind)
        elif kind == "sync":
            warm.append(t2 - t0)
    estimate(tracker.flush())
    vio.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run0
    launches = lk.lk_track.launches
    by_levels = dict(lk.lk_track.launches_by_levels)
    plain_calls = lk.lk_level_plain.calls + lk.lk_track_plain.calls
    level_launches = lk.lk_level.launches
    fc = factor_fields()
    g = graph_fields()
    its = iters_fields([vio.lm_iters_record()], g)
    captures = g["graphs_captured_n"] - captures

    est, gt = np.asarray(est), np.asarray(gt)
    ate = ate_rmse(est[10:], gt[10:], align="yaw")
    ld_err = abs(vio.traj.line_delay - sim.cfg.line_delay)
    t_feat, t_est = np.asarray(t_feat), np.asarray(t_est)
    times = t_feat + t_est
    kinds = np.asarray(kinds)
    streamed = times[kinds == "stream"]
    n_timed = len(times)
    c = vio.counts
    rec = {"phase": "image_textured", "duration_s": TEXTURED_S,
           "frames": len(sim.frames), "solved": len(est),
           "render_s": render_s, "render_wait_s": render_wait_s,
           "wall_s": wall, "ate_m": ate,
           "line_delay_s": vio.traj.line_delay,
           "line_delay_true_s": sim.cfg.line_delay, "ld_err_s": ld_err,
           "n_rejected": tracker.n_rejected,
           "k1_track_launches": launches,
           "k1_track_launches_by_levels": by_levels,
           "k1_level_launches": level_launches, "plain_lk_calls": plain_calls,
           "frontend_dispatch_syncs": tracker.dispatch_syncs,
           "frontend_sync_messages": sorted(set(tracker.sync_warnings))[:5],
           "megastep_calls": c["megastep"],
           "megastep_syncs": c["megastep_syncs"],
           "sync_messages": sorted(set(vio.sync_warnings))[:5],
           "sync_solves": c["sync_solve"],
           "sync_solves_after_handoff": c["sync_solve_after_handoff"],
           "marg_overflows": c["marg_overflow"],
           "timed_from": timed_from, "timed_frames": n_timed,
           "frontend_ms_median": float(np.median(t_feat)) * 1e3,
           "frontend_ms_mean": float(np.mean(t_feat)) * 1e3,
           "estimator_ms_median": float(np.median(t_est)) * 1e3,
           "estimator_ms_mean": float(np.mean(t_est)) * 1e3,
           "frame_ms_median": float(np.median(times)) * 1e3,
           "sustained_fps": n_timed / float(np.sum(times)),
           "warmup_ms_median": float(np.median(warm)) * 1e3
           if len(warm) else None, "warmup_frames": len(warm),
           "streamed_ms_median": float(np.median(streamed)) * 1e3
           if len(streamed) else None,
           "streamed_frames": len(streamed),
           "timing_ms_per_frame": {k: v / max(n_timed, 1) * 1e3
                                   for k, v in vio.timing.items()},
           "frontend_timing_ms_per_frame": {
               k: v / max(n_timed, 1) * 1e3
               for k, v in tracker.timing.items()},
           "profiled_frame": profiled,
           "profile_streamed_frame": device_share(
               prof, prof_s, float(np.median(streamed)) * 1e3)
           if prof is not None and len(streamed) else None,
           "captures_in_timed_frames": captures, **fc, **its,
           **g}
    emit(rec)
    finite = bool(np.isfinite(est).all()) and np.isfinite(vio.traj.line_delay)
    if not (finite and len(est) > 20 and ate < 0.15 and ld_err < 5e-6):
        raise SystemExit(f"image_textured fails bench.py's gates (ATE < "
                         f"0.15 m, line-delay error < 5 us): {rec}")
    if not (k1_once_a_frame(launches, g, len(sim.frames))
            and by_levels == {3: launches} and plain_calls == 0
            and level_launches == 0 and captured_once(g, 2 + 4 + 4)):
        raise SystemExit(f"image_textured did not run through one 3-level "
                         f"K1 track launch a frame, or captured a program "
                         f"twice: {rec}")
    if not (tracker.n_rejected > 0 and c["megastep"] >= 40
            and c["megastep_syncs"] == 0
            and c["sync_solve_after_handoff"] == 0 and prof is not None):
        raise SystemExit(f"image_textured did not run the gated, streamed "
                         f"path as required (F-gate fired, >= 40 "
                         f"megasteps, no sync inside a megastep, no sync "
                         f"solve after the handoff, one traced streamed "
                         f"frame): {rec}")
    if not iters_exact(rec):
        raise SystemExit(f"image_textured: the LM's exit nodes did not run "
                         f"exactly the iterations its solves needed: {rec}")
    rec["classic"] = phase_image_classic(sim, imgs_dev, cam)
    return rec


def phase_image_classic(sim, imgs_dev, cam):
    """The classic tracker on the card, briefly: the first 4 s of the same
    frames through `CtrlVIO.process_image` with `attach_frontend` and the
    gated tracker config, which routes to `FeatureTracker` (all 4 levels,
    no initial flow); the synchronous estimator from the ground-truth
    bootstrap. The tracker's four stages run as captured programs (the
    preprocessing, the track with K1 inside, the corner detection, the
    lift). Gates: finite poses, one 4-level K1 track launch a frame from
    the second on (the first has no previous pyramid), counted through
    replays, and no plain LK call; each program captured once; 100 or
    more published features a frame after the first. ATE and line-delay
    error are reported, not gated."""
    H, W = imgs_dev.shape[1:]
    reset_counts()
    t_run0 = time.perf_counter()
    vio = started_vio(sim, image_vio_config(stream=False))
    vio.attach_frontend(cam, (H, W), gated_tracker_config())
    tracker = vio.tracker
    if not isinstance(tracker, FeatureTracker):
        raise SystemExit(f"attach_frontend with reject_wf gave "
                         f"{type(tracker).__name__}, not FeatureTracker")
    est, gt, n_pub = [], [], []
    frame_ms = []
    est_ms = []
    for i, fr in enumerate(sim.frames[:CLASSIC_FRAMES]):
        pub = tracker._pub_count
        est0 = sum(vio.timing.get(k, 0.0) for k in RUN_TOP_KEYS)
        t0 = time.perf_counter()
        out = vio.process_image(fr.t_ns, imgs_dev[i])
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        est_ms.append((sum(vio.timing.get(k, 0.0) for k in RUN_TOP_KEYS)
                       - est0) * 1e3)
        if tracker._pub_count > pub:
            n_pub.append(int((tracker.ids >= 0).sum()))
        if out is not None:
            est.append(out[1])
            gt.append(sim.pose_at(fr.t_ns * 1e-9)[1])
    vio.flush()
    torch.cuda.synchronize()
    n = min(CLASSIC_FRAMES, len(sim.frames))
    launches = lk.lk_track.launches
    by_levels = dict(lk.lk_track.launches_by_levels)
    plain_calls = lk.lk_level_plain.calls + lk.lk_track_plain.calls
    est, gt = np.asarray(est), np.asarray(gt)
    fc = factor_fields()
    g = graph_fields()
    rec = {"phase": "image_textured_classic", "frames": n,
           "solved": len(est), "published": len(n_pub),
           "wall_s": time.perf_counter() - t_run0,
           "features_min_after_first": min(n_pub[1:]) if len(n_pub) > 1
           else None,
           "features_median": float(np.median(n_pub)) if n_pub else None,
           "ate_m": ate_rmse(est[10:], gt[10:], align="yaw")
           if len(est) > 12 else None,
           "ld_err_s": abs(vio.traj.line_delay - sim.cfg.line_delay),
           "frame_ms_median": float(np.median(frame_ms[1:])),
           "frame_ms_median_steady": float(np.median(frame_ms[12:])),
           # the estimator's share of a steady frame (its timed phases),
           # the rest the classic tracker's and process_image's own
           "estimator_ms_median_steady": float(np.median(est_ms[12:])),
           "frontend_ms_median_steady": float(np.median(
               np.subtract(frame_ms, est_ms)[12:])),
           "k1_track_launches": launches,
           "k1_track_launches_by_levels": by_levels,
           "plain_lk_calls": plain_calls,
           "tracker_programs": sorted(p.label for p in
                                      tracker_mod._PROGRAMS._programs
                                      .values()), **fc, **g}
    emit(rec)
    if not (len(est) > 0 and bool(np.isfinite(est).all())
            and k1_once_a_frame(launches, g, n - 1)
            and by_levels == {4: launches}
            and plain_calls == 0 and lk.lk_level.launches == 0
            and rec["features_min_after_first"] is not None
            and rec["features_min_after_first"] >= 100):
        raise SystemExit(f"the classic tracker's check failed (finite "
                         f"poses, one 4-level K1 launch a frame after the "
                         f"first through replays, no plain LK call, >= 100 "
                         f"features): {rec}")
    # the tracker's four programs, the synchronous estimator's four
    if not (captured_once(g, 4 + 4) and len(rec["tracker_programs"]) == 4):
        raise SystemExit(f"the classic tracker did not run as four captured "
                         f"programs, or captured one twice: {rec}")
    return rec


# bench.py --mode serve at its default width: 8 lanes, the bench's window,
# its 4 warmup frames; depth cut from the bench's 12 s to 6 s
SERVE_LANES = 8
SERVE_S = 6.0
SERVE_WARMUP = 4


def phase_serve():
    """`bench.py --mode serve` (`bench.py:546-700`) on the card: 8
    sequences (`SimConfig(duration=6, n_landmarks=300, seed=3 + lane)`),
    one CtrlVIO a lane (f32, the bench's window, ground-truth bootstrap,
    line delay started at its true value and still optimized, 4 warmup
    frames), all behind one BatchedStream: one batched megastep a frame
    for every lane. Times as the bench takes them, from frame
    `timed_from = 11 + 4 + 8`: the lockstep step's median and mean,
    sustained aggregate frames/s (lanes x steps over their summed time),
    the host split a step, `device_steady_ms`, the matrix-product flops of
    one batched megastep (FlopCounterMode) at the median step rate against
    the card's f32 peak. The last frame's batched step is traced with
    torch.profiler (after a synchronize, ending in one) and left out of
    the timed steps. Gates: every lane's ATE (yaw-aligned, frames from
    timed_from + 6) < 0.10 m and line-delay error < 5 us
    (`bench.py:633`); >= 30 batched steps; no synchronizing call in the
    coordinator's dispatch; no K1 launch. Returns the record; the gate on
    its device operations against e2e's is `check_serve_device_ops`."""
    timed_from = 11 + SERVE_WARMUP + 8
    t0 = time.perf_counter()
    sims = [synthetic.generate(synthetic.SimConfig(
        duration=SERVE_S, n_landmarks=300, seed=3 + lane))
        for lane in range(SERVE_LANES)]
    n_frames = min(len(s.frames) for s in sims)
    reset_counts()
    t_run0 = time.perf_counter()
    vios = [started_vio(sim, VIOConfig(
        window_config=WindowConfig(KW=32, NB=11, LM=256, OBS=768, MIMU=256),
        fix_ld=False, ld_init=sim.cfg.line_delay, dtype=torch.float32,
        stream=True, stream_warmup=SERVE_WARMUP)) for sim in sims]
    coord = BatchedStream(vios)
    coord.check_dispatch_syncs = True
    t_setup = time.perf_counter() - t0
    times = []
    for k in range(n_frames - 1):
        t0 = time.perf_counter()
        coord.step(sim_frames(sims, k))
        if k == timed_from:
            for v in vios:
                v.timing.clear()
            coord.timing.clear()
            coord._n_steps = 0
            captures = len(graphs.stats()["graphs_captured"])
        if k >= timed_from:
            times.append(time.perf_counter() - t0)
    n_timed = max(coord._n_steps, 1)
    split = {k: v / n_timed * 1e3 for k, v in coord.timing.items()}
    lane_phases = defaultdict(float)
    for v in vios:
        for k, s in v.timing.items():
            lane_phases[k] += s / n_timed * 1e3
    # the last frame's batched step, traced (not timed)
    steps = coord._n_steps
    torch.cuda.synchronize()
    with device_trace() as prof:
        t0 = time.perf_counter()
        coord.step(sim_frames(sims, n_frames - 1))
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    if coord._n_steps != steps + 1:
        raise SystemExit("serve: the traced last frame ran no batched step")
    fc = factor_fields()
    dev_ms = coord.device_steady_ms(reps=3)
    flops = coord.cost_analysis()["flops"]
    coord.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run0
    k1_launches = lk.lk_track.launches + lk.lk_level.launches
    g = graph_fields()
    its = iters_fields([v.lm_iters_record() for v in vios], g,
                       batched_stream=True)
    its.update(lanes_done_early([v.lm_iters()["stream"] for v in vios],
                                vios[0].cfg.ba_iters))
    captures = g["graphs_captured_n"] - captures

    lanes = []
    for lane, (vio, sim) in enumerate(zip(vios, sims)):
        t_eval = [f.t_ns for f in sim.frames[timed_from + 6 : n_frames]]
        base = vio.data_start_ns or 0
        est = np.stack([vio.traj.pose(t - base)[1][0] for t in t_eval])
        gt = np.stack([sim.pose_at(t * 1e-9)[1] for t in t_eval])
        lanes.append({"lane": lane, "seed": sim.cfg.seed,
                      "ate_m": ate_rmse(est, gt, align="yaw"),
                      "ld_err_s": abs(vio.traj.line_delay
                                      - sim.cfg.line_delay),
                      "finite": bool(np.isfinite(est).all()),
                      "megasteps": vio.counts["megastep"],
                      "sync_solves_after_handoff":
                          vio.counts["sync_solve_after_handoff"],
                      "marg_overflows": vio.counts["marg_overflow"]})
    times = np.asarray(times)
    per_step = float(np.median(times))
    t0 = time.perf_counter()
    profile = device_share(prof, prof_s, per_step * 1e3)
    profile["analysis_s"] = time.perf_counter() - t0
    if not profile["trace_complete"]:
        raise SystemExit(f"serve: the trace of the batched step saw "
                         f"{profile['traced_k4_launches']} of the "
                         f"{prof.k4_run} K4 launches it ran: its device "
                         f"operations, which the serve gate reads, are "
                         f"not all there")
    rec = {"phase": "serve", "lanes": SERVE_LANES, "duration_s": SERVE_S,
           "frames": n_frames, "setup_s": t_setup, "wall_s": wall,
           "timed_from": timed_from, "timed_steps": len(times),
           "batched_steps": min(r["megasteps"] for r in lanes),
           "step_ms_median": per_step * 1e3,
           "step_ms_mean": float(np.mean(times)) * 1e3,
           "aggregate_fps": SERVE_LANES * len(times) / float(np.sum(times)),
           "host_ms_per_step": split,
           "lane_phases_ms_per_step": dict(sorted(lane_phases.items())),
           "device_steady_ms": dev_ms,
           "matmul_flops_per_step": flops,
           "dispatch_syncs": coord.dispatch_syncs,
           "sync_messages": sorted(set(coord.sync_warnings))[:5],
           "k1_launches": k1_launches, "profiled_frame": n_frames - 1,
           "profile_batched_step": profile, "per_lane": lanes,
           "captures_in_timed_frames": captures, **fc, **its,
           **g}
    bad = [r for r in lanes if not (r["finite"] and r["ate_m"] < 0.10
                                    and r["ld_err_s"] < 5e-6)]
    if bad:
        raise SystemExit(f"serve: lanes fail bench.py's gates (ATE < "
                         f"0.10 m, line-delay error < 5 us): {bad}; {rec}")
    if not (rec["batched_steps"] >= 30 and coord.dispatch_syncs == 0
            and k1_launches == 0
            and all(r["sync_solves_after_handoff"] == 0 for r in lanes)):
        raise SystemExit(f"serve did not run the batched path as required "
                         f"(>= 30 batched steps, no synchronizing call in "
                         f"the dispatch, no sync solve after the handoff): "
                         f"{rec}")
    # the batched megastep, the lanes' synchronous four
    if not captured_once(g, 1 + 4) or g["replays"] < rec["batched_steps"]:
        raise SystemExit(f"serve did not replay a captured batched megastep "
                         f"every step, or captured a program twice: {rec}")
    if not iters_exact(rec):
        raise SystemExit(f"serve: the lanes' synchronous solves' exit nodes "
                         f"did not run exactly the iterations needed: {rec}")
    if captures != 0:
        raise SystemExit(f"serve captured {captures} programs on timed steps "
                         f"(PERF.md's limit: none): {rec}")
    return rec


# the graphs line: frames run graphed and eagerly on the card, both under
# deterministic algorithms (as the multichip phase compares). In the
# default mode CUDA's atomic `index_add` sums in another order on each run
# and the chained windows carry that (1.6-2.1 mm apart after 11-17 frames,
# ATE within 0.4 mm, on an H100); under them a replay equals its eager
# call bit for bit (0.0 on both megastep branches, no synchronizing call).
# Gates: the tolerances of `tests/test_torch_graphs_gpu.py` (positions
# 1e-3 m) and ATE within 1 mm
GRAPH_TOL_M = 1e-3
GRAPH_ATE_M = 1e-3
GRAPH_TOL_PX = 1e-3


@contextlib.contextmanager
def eager_programs():
    """For the graphs line only: inside, every program's function runs
    eagerly on the card (the comparison's other side), by patching the
    package's rule of which devices run graphs (`graphs.graphed_on`). The
    package itself has no switch that turns graphs off."""
    on = graphs.graphed_on
    graphs.graphed_on = lambda device: False
    try:
        yield
    finally:
        graphs.graphed_on = on


def both_ways(run):
    """`run()` with its programs replayed, then eagerly."""
    got = run()
    with eager_programs():
        ref = run()
    return got, ref


def graphs_main(seq):
    """The main path's synchronous frames after its 11-frame window filled
    (2.5 s of the blobs scene, rendered here as `phase_main` renders it:
    about 14 solved frames), and the front end on every frame: positions
    and ATE, the published features, each solve's LM iterations. The
    rendered sequence is left in `seq` (sim, images, camera)."""
    sim = image_sim(2.5, 1500)
    cam = tumrs_camera()
    imgs = render.render_sequence(sim, 1024, 1280, camera=cam, seed=1,
                                  big_every=6, texture=6.0)
    tcfg = TrackerConfig(max_cnt=150, min_dist=25, use_clahe=True,
                         fb_check=True, klt=klt.KLTConfig(pred_levels=3))
    n = len(sim.frames)

    def run():
        r = replay(sim, imgs, cam, tcfg, image_vio_config(stream=False),
                   "cuda")
        est, gt = r["est"], r["gt"]
        return dict(est=est, ate=ate_rmse(est, gt, align="yaw"),
                    feats=r["feats"], vio=r["vio"],
                    est_ms=float(np.median(r["t_est"][-10:])) * 1e3,
                    fe_ms=float(np.median(r["t_feat"])) * 1e3)

    g, e = both_ways(run)
    seq[:] = [sim, imgs, cam]
    same_ids = all((a is None and b is None) or np.array_equal(
        a["ids"], b["ids"]) for a, b in zip(g["feats"], e["feats"]))
    uv = max((float(np.abs(a["uv"] - b["uv"]).max()) for a, b in
              zip(g["feats"], e["feats"]) if a is not None and len(a["uv"])
              and np.array_equal(a["ids"], b["ids"])), default=0.0)
    return {"frames": n, "solved": len(g["est"]),
            "frontend_frames": sum(f is not None for f in g["feats"]),
            "max_pos_dev_m": float(np.abs(g["est"] - e["est"]).max()),
            "ate_m": g["ate"], "ate_eager_m": e["ate"],
            "ld_dev_s": abs(g["vio"].traj.line_delay
                            - e["vio"].traj.line_delay),
            "lm_iters": g["vio"].lm_iters_record()["hist"],
            "lm_iters_equal": g["vio"].lm_iters() == e["vio"].lm_iters(),
            "features_same_ids": same_ids, "features_max_uv_dev_px": uv,
            "estimator_ms_median": g["est_ms"],
            "estimator_ms_median_eager": e["est_ms"],
            "frontend_ms_median": g["fe_ms"],
            "frontend_ms_median_eager": e["fe_ms"]}


def graphs_e2e(held):
    """About 20 streamed frames of the e2e sequence (`phase_e2e`'s: f32,
    the bench's window, the native table) from the ground-truth bootstrap
    with 4 warmup frames, so that the stream starts after 15 frames: the
    forecast poses, the post-hoc trajectory at the frame times, the
    consumed summaries' statistics, host ms a streamed frame. The graphed
    run's megastep program (the slide that marginalizes the oldest
    keyframe) and synchronous window solve program are left in `held`,
    with their last inputs, each as (name, program, a reader of the LM
    iterations its last replay ran)."""
    sim = synthetic.generate(synthetic.reference_noise(
        duration=4.0, n_landmarks=300, seed=3, speed=1.0))
    cfg = VIOConfig(
        window_config=WindowConfig(KW=32, NB=11, LM=256, OBS=768, MIMU=256),
        fix_ld=False, ld_init=0.0, dtype=torch.float32, stream=True,
        stream_warmup=4)

    def run():
        vio = started_vio(sim, cfg)
        est, ts, ms = [], [], []
        for fr in sim.frames:
            n = vio.counts["megastep"]
            t0 = time.perf_counter()
            out = vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
            dt = time.perf_counter() - t0
            if out is not None:
                est.append(out[1])
                ts.append(fr.t_ns)
            if vio.counts["megastep"] > n:
                ms.append(dt)
        vio.flush()
        torch.cuda.synchronize()
        base = vio.data_start_ns or 0
        post = np.stack([vio.traj.pose(t - base)[1][0] for t in ts])
        gt = np.stack([sim.pose_at(t * 1e-9)[1] for t in ts])
        return dict(est=np.asarray(est), post=post, vio=vio,
                    ate=ate_rmse(post, gt, align="yaw"),
                    ms=float(np.median(ms[2:])) * 1e3)

    g, e = both_ways(run)
    held[:] = [("megastep", program(g["vio"]._programs, "marg_old=True",
                                    "host_seeds=False"),
                lambda p: stream.unpack_summary(
                    p.outputs.double().cpu().numpy(),
                    cfg.window_config)["iters"]),
               ("window_solve", program(odometry._SYNC_PROGRAMS,
                                        "window_solve", "restore=True"),
                lambda p: float(p.outputs[-1]))]
    sg, se = g["vio"].last_solve_stats, e["vio"].last_solve_stats
    return {"frames": len(sim.frames), "streamed": g["vio"].counts["megastep"],
            "streamed_eager": e["vio"].counts["megastep"],
            "max_pos_dev_m": float(np.abs(g["est"] - e["est"]).max()),
            "max_posthoc_dev_m": float(np.abs(g["post"] - e["post"]).max()),
            "ate_m": g["ate"], "ate_eager_m": e["ate"],
            "ld_dev_s": abs(g["vio"].traj.line_delay
                            - e["vio"].traj.line_delay),
            "lm_iters": g["vio"].lm_iters_record()["hist"],
            "lm_iters_equal": g["vio"].lm_iters() == e["vio"].lm_iters(),
            "last_summary_cost_rel_dev":
                abs(sg.cost - se.cost) / max(abs(se.cost), 1e-30),
            "streamed_ms_median": g["ms"], "streamed_ms_median_eager": e["ms"]}


def graphs_serve():
    """10 or more batched steps of `phase_serve`'s 8 lanes (its sequences
    cut to 3.2 s: the 11-frame windows, 4 warmup frames, then the steps): each
    lane's trajectory at its frame times and its ATE, host ms a step."""
    sims = [synthetic.generate(synthetic.SimConfig(
        duration=3.2, n_landmarks=300, seed=3 + lane))
        for lane in range(SERVE_LANES)]
    n_frames = min(len(s.frames) for s in sims)

    def run():
        vios = [started_vio(sim, VIOConfig(
            window_config=WindowConfig(KW=32, NB=11, LM=256, OBS=768,
                                       MIMU=256),
            fix_ld=False, ld_init=sim.cfg.line_delay, dtype=torch.float32,
            stream=True, stream_warmup=SERVE_WARMUP)) for sim in sims]
        coord = BatchedStream(vios)
        ms = []
        for k in range(n_frames):
            n = coord._n_steps
            t0 = time.perf_counter()
            coord.step(sim_frames(sims, k))
            if coord._n_steps > n:
                ms.append(time.perf_counter() - t0)
        coord.flush()
        torch.cuda.synchronize()
        pos, ates = [], []
        for vio, sim in zip(vios, sims):
            ts = [f.t_ns for f in sim.frames[11:n_frames]]
            base = vio.data_start_ns or 0
            p = np.stack([vio.traj.pose(t - base)[1][0] for t in ts])
            pos.append(p)
            ates.append(ate_rmse(p, np.stack([sim.pose_at(t * 1e-9)[1]
                                              for t in ts]), align="yaw"))
        return dict(pos=np.asarray(pos), ates=ates, steps=coord._n_steps,
                    ms=float(np.median(ms[2:])) * 1e3)

    g, e = both_ways(run)
    return {"lanes": SERVE_LANES, "steps": g["steps"],
            "steps_eager": e["steps"],
            "max_pos_dev_m": float(np.abs(g["pos"] - e["pos"]).max()),
            "max_ate_dev_m": float(np.max(np.abs(np.subtract(g["ates"],
                                                             e["ates"])))),
            "ate_m": g["ates"], "ate_eager_m": e["ates"],
            "step_ms_median": g["ms"], "step_ms_median_eager": e["ms"]}


def graphs_classic(sim, imgs, cam, frames=12):
    """The classic `FeatureTracker` (the gated config, all 4 levels) on
    the first frames of `graphs_main`'s sequence: its four stages
    replayed against run eagerly; the published ids and points, host ms a
    frame."""
    H, W = imgs.shape[1:]
    imgs_dev = torch.as_tensor(imgs[:frames], device="cuda")

    def run():
        tr = FeatureTracker(gated_tracker_config(), cam, (H, W),
                            device="cuda")
        outs, ms = [], []
        for i in range(frames):
            t0 = time.perf_counter()
            outs.append(tr.process(sim.frames[i].t_ns, imgs_dev[i]))
            torch.cuda.synchronize()
            ms.append(time.perf_counter() - t0)
        return outs, float(np.median(ms[2:])) * 1e3

    (g, g_ms), (e, e_ms) = both_ways(run)
    pub = [(a, b) for a, b in zip(g, e) if a is not None or b is not None]
    same = all(a is not None and b is not None
               and np.array_equal(a["ids"], b["ids"]) for a, b in pub)
    uv = max((float(np.abs(a["uv"] - b["uv"]).max()) for a, b in pub
              if same and len(a["uv"])), default=0.0)
    return {"frames": frames, "published": len(pub),
            "features_same_ids": same, "features_max_uv_dev_px": uv,
            "frame_ms_median": g_ms, "frame_ms_median_eager": e_ms}


def graphs_batch(B=8):
    """`phase_batch`'s window (f32, 15 LM iterations) solved B times by
    the batched solver's program and by the same vmapped solve run
    eagerly: lane by lane equal bit for bit."""
    cfg = WindowConfig(KW=48, NB=11, LM=256, OBS=768, MIMU=512, dt=0.05)
    prob = tiny.tiny_problem(torch.float32, cfg, device="cuda")
    args = (*multihost.stacked(prob, B), *prob.aux)
    solve = batch.make_batched_solver(cfg, SolveOptions(max_iters=15))
    g, e = both_ways(lambda: graphs.clone(solve(*args)))
    torch.cuda.synchronize()
    return {"B": B, "bit_equal": all(torch.equal(a, b) for a, b in zip(
        graphs.leaves(g), graphs.leaves(e))),
        "max_abs_dev": max(float((a.double() - b.double()).abs().max())
                           for a, b in zip(graphs.leaves(g),
                                           graphs.leaves(e))),
        "lm_iters": iters_histogram(g[1].iters.cpu().numpy())}


def phase_graphs():
    """The graphs line: the same frames run with every program replayed
    from its captured graph and with every function run eagerly, on the
    card, in this (side) process, under deterministic algorithms: 10 or
    more synchronous `main` frames with the front end on every frame, ~20
    streamed e2e frames, 10 or more serve steps at B = 8. Gates: the graphed run's positions and summaries within the
    gpu tests' tolerances of the eager run's (1e-3 m; the line delay within
    1e-8 s; the last summary's cost within 1e-3 relative), ATE within 1 mm,
    the front end's published ids equal and points within 1e-3 px, both
    runs the same frame and step counts; the synchronous solves and the
    streamed megasteps, whose LM exit nodes skip what the eager run
    freezes, equal bit for bit (`main`, `e2e`), with the same LM
    iteration counts; the classic tracker's ids equal and points within
    1e-4 px; the batched solver's lanes equal bit for bit. Host ms a frame
    both ways."""
    t0 = time.perf_counter()
    reset_counts()
    seq, held = [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            rec = {"phase": "graphs", "deterministic": True,
                   "main": graphs_main(seq), "e2e": graphs_e2e(held),
                   "serve": graphs_serve(), "classic": graphs_classic(*seq),
                   "batch": graphs_batch()}
        finally:
            torch.use_deterministic_algorithms(False)
    rec.update(graph_fields(), wall_s=time.perf_counter() - t0,
               ops_without_deterministic_version=sorted({
                   str(w.message).split(" does not")[0] for w in caught
                   if "deterministic" in str(w.message)}))
    # after the counts above: these replays are measurement, not the run
    rec["e2e"]["replays_from_held"] = {
        name: {**replays_from_held(prog), "lm_iters": int(iters(prog))}
        for name, prog, iters in held}
    m, e2e, sv = rec["main"], rec["e2e"], rec["serve"]
    cl, bt = rec["classic"], rec["batch"]
    ok = (m["max_pos_dev_m"] == 0.0 and e2e["max_pos_dev_m"] == 0.0
          and e2e["max_posthoc_dev_m"] == 0.0
          and m["lm_iters_equal"] and e2e["lm_iters_equal"]
          and cl["features_same_ids"] and cl["published"] >= 6
          and cl["features_max_uv_dev_px"] <= 1e-4 and bt["bit_equal"]
          and m["max_pos_dev_m"] <= GRAPH_TOL_M
          and abs(m["ate_m"] - m["ate_eager_m"]) <= GRAPH_ATE_M
          and m["ld_dev_s"] <= 1e-8 and m["features_same_ids"]
          and m["features_max_uv_dev_px"] <= GRAPH_TOL_PX
          and m["solved"] >= 10 and m["frontend_frames"] >= 10
          and e2e["streamed"] == e2e["streamed_eager"] >= 18
          and e2e["max_pos_dev_m"] <= GRAPH_TOL_M
          and e2e["max_posthoc_dev_m"] <= GRAPH_TOL_M
          and abs(e2e["ate_m"] - e2e["ate_eager_m"]) <= GRAPH_ATE_M
          and e2e["ld_dev_s"] <= 1e-8
          and e2e["last_summary_cost_rel_dev"] <= 1e-3
          and sv["steps"] == sv["steps_eager"] >= 10
          and sv["max_pos_dev_m"] <= GRAPH_TOL_M
          and sv["max_ate_dev_m"] <= GRAPH_ATE_M)
    if not ok:
        raise SystemExit(f"graphs: the replayed programs depart from the "
                         f"eager run: {rec}")
    return rec


def check_serve_device_ops(serve, e2e_device_ops):
    """The traced batched step (8 lanes) has at most twice the device
    operations of e2e's single-lane megastep run eagerly (every LM
    iteration, as the batched step runs them, each operation launched from
    the host, so the profiler sees all of them; in a replayed frame it
    misses trips of the WHILE node): a per-lane loop or a vmap fallback
    would multiply them by the lanes."""
    ops = serve["profile_batched_step"]["device_ops"]
    serve["e2e_device_ops"] = e2e_device_ops
    serve["device_ops_ratio_to_e2e"] = ops / max(e2e_device_ops, 1)
    if not 0 < ops <= 2 * e2e_device_ops:
        raise SystemExit(f"serve: a batched step made {ops} device "
                         f"operations, not within 2x e2e's single-lane "
                         f"megastep ({e2e_device_ops})")


# the paths that run the streamed megastep, whose summary computes the
# window's residual RMS every frame
SUMMARY_PATHS = ("e2e", "image_textured", "serve", "cli", "bench_image")


def check_factor_launches(paths):
    """Every path launched K2 and K3 and, in its LM solves, K4, the
    streamed paths K5 too (counted through replays), and none ran the
    plain summary or the plain accept step."""
    bad = {p: {k: r[k] for k in ("k2_launches", "k3_launches", "k5_launches",
                                 "k4_launches", "plain_factor_calls",
                                 "plain_summary_calls",
                                 "plain_accept_calls")}
           for p, r in paths.items()
           if not (r["k2_launches"] > 0 and r["k3_launches"] > 0
                   and r["k4_launches"] > 0
                   and r["plain_summary_calls"] == 0
                   and r["plain_accept_calls"] == 0
                   and (p not in SUMMARY_PATHS or r["k5_launches"] > 0))}
    if bad:
        raise SystemExit(f"paths that did not linearize through K2 and K3 "
                         f"and accept through K4, or whose residual summary "
                         f"did not go through K5: {bad}")


def sim_frames(sims, k):
    """Frame k of every lane's sequence, as BatchedStream.step takes them."""
    return [(s.frames[k].t_ns, s.frames[k].ids, s.frames[k].pts,
             s.frames[k].rows) for s in sims]


def solve_devs(ref, got):
    """Each field's largest deviation of `got` (WindowParams, optionally
    with a leading lane axis) from `ref`: absolute, but relative to the
    largest entry for the inverse depths."""
    dev = {k: float((b - a).abs().max())
           for k, a, b in zip(ref._fields, ref, got)}
    dev["dinv"] /= max(float(ref.dinv.abs().max()), 1e-30)
    return dev


def time_min(fn, reps=3):
    """Min over `reps` calls after a warm call, each ending in a
    synchronize (`bench.py:736-743`); returns (seconds, last result)."""
    out = fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return min(ts), out


def phase_batch():
    """`bench.py --mode batch` (`bench.py:703-760`) on the card: the
    window of `__graft_entry__._tiny_problem` at the bench's config
    (KW=48, NB=11, LM=256, OBS=768, MIMU=512; `sim/tiny.py`), f32, 15 LM
    iterations, solved B times by one `make_batched_solver` call for B in
    1, 2, 4, 8, 16: min of 3 after a warm call, windows/s and per-window
    efficiency; each B's solve is one captured program (`batch.
    batched_solve`, captured by the warm call), so the times are replays.
    Then B = 8 with the CG Schur path (48 iterations) beside
    chol. The window is noiseless (its cost falls from ~1e3 to the f32
    floor, ~1e-9 of cost0), so lanes are compared in each field's own
    units and CG's cost against chol's decrease. Gates: every lane of
    every B agrees with the single `solve_window_fixed` (knots, biases
    within 1e-3 absolute, inverse depths within 1e-3 of the largest, the
    line delay within 1e-8 s, the final cost within 1e-4 of cost0, the
    normalization of `__graft_entry__.dryrun_multichip`), no cost above
    its cost0; CG's final costs finite and within 1 % of chol's decrease
    (cost0 - cost) of chol's final cost."""
    cfg = WindowConfig(KW=48, NB=11, LM=256, OBS=768, MIMU=512, dt=0.05)
    prob = tiny.tiny_problem(torch.float32, cfg, device="cuda")
    opts = SolveOptions(max_iters=15)
    reset_counts()
    t_run0 = time.perf_counter()
    t_single, (p1, s1) = time_min(lambda: lm.solve_window_fixed(
        prob.params, prob.img, prob.imu, prob.bias, prob.prior, prob.fixed,
        *prob.aux, cfg, opts), reps=1)
    cost0, cost1 = float(s1.cost0), float(s1.cost)

    sweep, wps, results = [], {}, {}
    for B in (1, 2, 4, 8, 16):
        solve = batch.make_batched_solver(cfg, opts)
        args = multihost.stacked(prob, B)
        tB, (pb, sb) = time_min(lambda: solve(*args, *prob.aux))
        wps[B] = B / tB
        costs = sb.cost.double().cpu().numpy()
        iters = sb.iters.cpu().numpy()
        rec = {"B": B, "ms": tB * 1e3, "windows_per_s": wps[B],
               "efficiency": wps[B] / (B * wps[1]),
               "lm_iters": iters_histogram(iters),
               "all_lanes_done_early": bool(iters.max() < opts.max_iters),
               "max_lane_dev": solve_devs(p1, pb),
               "max_cost_dev_over_cost0":
                   float(np.abs(costs - cost1).max()) / cost0,
               "cost_above_cost0": int((sb.cost > sb.cost0).sum())}
        sweep.append(rec)
        results[B] = costs
    solve_cg = batch.make_batched_solver(cfg, opts._replace(solver="cg"))
    args8 = multihost.stacked(prob, 8)
    t_cg, (_, s_cg) = time_min(lambda: solve_cg(*args8, *prob.aux))
    cg_costs = s_cg.cost.double().cpu().numpy()
    cg_off = np.abs(cg_costs - results[8])
    wall = time.perf_counter() - t_run0
    rec = {"phase": "batch", "cfg": dict(cfg._asdict()), "max_iters": 15,
           "single_ms": t_single * 1e3, "cost0": cost0, "cost_single": cost1,
           "sweep": sweep,
           "cg": {"B": 8, "cg_iters": opts.cg_iters, "ms": t_cg * 1e3,
                  "chol_ms": next(r["ms"] for r in sweep if r["B"] == 8),
                  "costs": cg_costs.tolist(),
                  "chol_costs": results[8].tolist(),
                  "max_cost_ratio": float(np.max(cg_costs / results[8])),
                  "max_diff_over_chol_decrease":
                      float(np.max(cg_off / (cost0 - results[8])))},
           "k1_launches": lk.lk_track.launches + lk.lk_level.launches,
           "wall_s": wall, **factor_fields(), **graph_fields()}
    rec["calls_all_lanes_done_early"] = sum(r["all_lanes_done_early"]
                                            for r in sweep)
    # one program a B and the CG one, captured once each, replayed by
    # every timed call
    if not (captured_once(rec, len(sweep) + 1)
            and rec["graphs_captured_n"] == len(sweep) + 1
            and rec["replays"] >= 4 * (len(sweep) + 1)):
        raise SystemExit(f"batch: the solves did not run as one captured "
                         f"program a B: {rec}")
    if not all(max(r["max_lane_dev"][k] for k in ("knots_q", "knots_p",
                                                  "bg", "ba", "dinv"))
               <= 1e-3 and r["max_lane_dev"]["ld"] <= 1e-8
               and r["max_cost_dev_over_cost0"] <= 1e-4
               and r["cost_above_cost0"] == 0 for r in sweep):
        raise SystemExit(f"batch: a lane disagrees with the single solve: "
                         f"{rec}")
    if not (np.isfinite(cg_costs).all()
            and rec["cg"]["max_diff_over_chol_decrease"] <= 0.01
            and rec["k1_launches"] == 0):
        raise SystemExit(f"batch: CG's final costs are not within 1 % of "
                         f"chol's decrease of chol's: {rec}")
    return rec


# the multi-device phase: the bench's batch window, as phase_batch solves it
MULTICHIP_CFG = WindowConfig(KW=48, NB=11, LM=256, OBS=768, MIMU=512, dt=0.05)
MULTICHIP_ITERS = 15


def solve_agrees(dev, dcost_over_cost0):
    """phase_batch's gates: knots and biases within 1e-3 absolute, inverse
    depths within 1e-3 of the largest, the cost within 1e-4 of cost0."""
    return (max(dev[k] for k in ("knots_q", "knots_p", "bg", "ba", "dinv"))
            <= 1e-3 and dcost_over_cost0 <= 1e-4)


def phase_multichip():
    """The multi-device layer (`parallel/mesh.py`, `sharded_lm.py`,
    `batch.py`'s mesh, `multihost.py`) on the one card. (a) The production
    backend: NCCL at world size 1, mesh (1, 1), on the bench's batch window
    (`MULTICHIP_CFG`, f32, 15 LM iterations). Times of the single
    `lm.solve_window_fixed` and of the factor-sharded solve, in turns
    (single, sharded, sharded, single, single, sharded; min of 3 after a
    warm call each), and the synchronizing CUDA calls of the sharded
    solve's first and of a steady call. CUDA's `index_add` sums by atomics
    in no fixed order, so two runs of the same solve differ by f32
    rounding, and near this noiseless window's f32 floor an accept can
    flip: the comparisons run once more under
    `torch.use_deterministic_algorithms`, where the sharded solve must
    equal the single one (the same accepted count and phase_batch's
    gates; a difference of 0 is expected, the all-reduce over one rank
    being a copy), the factor-sharded step must agree with one unsharded
    dense step, and the seq-sharded batch at B = 8 lane by lane with
    `make_batched_solver` without a mesh; then the two-megastep chain's
    cost must fall. (b) The factor split for real:
    `multihost.dryrun_multichip(2, backend="gloo")`, two rank processes
    sharing cuda:0 (NCCL refuses two ranks on one card), their CUDA
    tensors all-reduced through gloo, on the same window and depth, held
    to the dry run's gates."""
    # cuBLAS's deterministic workspace, for the exact comparisons; set
    # before this process's first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    cfg, opts = MULTICHIP_CFG, SolveOptions(max_iters=MULTICHIP_ITERS)
    reset_counts()
    t_run0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="multichip_") as store:
        dev = pmesh.init_distributed(0, 1, store, device="cuda")
        try:
            backend = str(dist.get_backend())
            m = pmesh.make_mesh(1, 1)
            prob = tiny.tiny_problem(torch.float32, cfg, device=dev)
            args = (prob.params, prob.img, prob.imu, prob.bias, prob.prior,
                    prob.fixed, *prob.aux)
            solve_sh = sharded_lm.make_sharded_solve(m, cfg, opts)
            # the sharded solve is a captured program on NCCL: its outputs
            # are kept as copies
            fns = {"single": lambda: lm.solve_window_fixed(*args, cfg, opts),
                   "sharded": lambda: graphs.clone(solve_sh(*args))}
            fns["single"]()
            with recorded_syncs() as syncs_first:
                fns["sharded"]()
                torch.cuda.synchronize()
            with recorded_syncs() as syncs:
                fns["sharded"]()
            torch.cuda.synchronize()
            ts, outs = defaultdict(list), defaultdict(list)
            for order in (("single", "sharded"), ("sharded", "single"),
                          ("single", "sharded")):
                for k in order:
                    t0 = time.perf_counter()
                    outs[k].append(fns[k]())
                    torch.cuda.synchronize()
                    ts[k].append(time.perf_counter() - t0)
            (pa, sa), (pb, sb) = outs["single"][:2]
            p_d, s_d = outs["sharded"][0]
            cost0 = float(sa.cost0)
            default_mode = {
                "single_repeat_dev": solve_devs(pa, pb),
                "single_repeat_accepted": [int(sa.accepted),
                                           int(sb.accepted)],
                "sharded_dev": solve_devs(pa, p_d),
                "sharded_dcost_over_cost0":
                    abs(float(s_d.cost) - float(sa.cost)) / cost0,
                "sharded_accepted": int(s_d.accepted)}

            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    p1, s1 = fns["single"]()
                    p_sh, s_sh = fns["sharded"]()
                    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
                    o1 = SolveOptions(max_iters=1)
                    p_st, c_st = sharded_lm.make_factor_sharded_step(
                        m, cfg, o1)(*args, lam)
                    cmask = column_mask(cfg, o1, prob.fixed, torch.float32)
                    lin = assemble.linearize(*args[:5], *args[6:], cfg, o1)
                    dx, dx_lm = lm.schur_solve(
                        *lm.build_normal_equations(lin, cfg, cmask), lam,
                        cmask)
                    p_ref = retract(prob.params, dx, cfg, o1)._replace(
                        dinv=prob.params.dinv + dx_lm)
                    args8 = multihost.stacked(prob, 8)
                    p_b, s_b = batch.make_batched_solver(cfg, opts)(
                        *args8, *prob.aux)
                    p_bm, s_bm = batch.make_batched_solver(
                        cfg, opts, mesh=m)(*args8, *prob.aux)
                    torch.cuda.synchronize()
                finally:
                    torch.use_deterministic_algorithms(False)
            solve = {"max_dev": solve_devs(p1, p_sh),
                     "dcost_over_cost0": abs(float(s_sh.cost)
                                             - float(s1.cost)) / cost0,
                     "accepted": int(s_sh.accepted),
                     "accepted_single": int(s1.accepted),
                     "cost0": cost0, "cost": float(s_sh.cost)}
            step_rec = {"max_dev": solve_devs(p_ref, p_st),
                        "dcost_over_cost": abs(float(c_st) - float(lin.cost))
                        / float(lin.cost)}
            batch_rec = {
                "B": 8, "max_lane_dev": solve_devs(p_b, p_bm),
                "max_cost_dev_over_cost0":
                    float((s_bm.cost - s_b.cost).abs().max()) / cost0,
                "accepted_equal": bool(torch.equal(s_bm.accepted,
                                                   s_b.accepted))}
            nondeterministic_ops = sorted({
                str(w.message).split(" does not")[0] for w in caught
                if "deterministic" in str(w.message)})
            m1, m2 = multihost.megastep_chain(prob, SolveOptions(max_iters=3))
        finally:
            dist.destroy_process_group()
    world1_s = time.perf_counter() - t_run0
    world1_graphs = graph_fields()
    world1_factors = factor_fields()
    t0 = time.perf_counter()
    two = multihost.dryrun_multichip(2, device="cuda", backend="gloo",
                                     cfg=cfg, solve_iters=MULTICHIP_ITERS)
    rec = {"phase": "multichip", "cfg": dict(cfg._asdict()),
           "max_iters": MULTICHIP_ITERS, "world1_backend": backend,
           "single_ms": min(ts["single"]) * 1e3,
           "sharded_world1_ms": min(ts["sharded"]) * 1e3,
           "single_ms_all": [t * 1e3 for t in ts["single"]],
           "sharded_world1_ms_all": [t * 1e3 for t in ts["sharded"]],
           "sharded_2rank_gloo_ms": two["solve"]["ms"],
           "allreduce_bytes_per_iter":
               sharded_lm.reduced_bytes_per_iteration(cfg, torch.float32),
           "allreduce_bytes_H": cfg.C * cfg.C * 4,
           "sharded_solve_syncs": len(syncs), "sharded_solve_sync_sites":
               sorted(set(syncs)),
           "first_call_syncs": len(syncs_first),
           "first_call_sync_sites": sorted(set(syncs_first)),
           "default_mode": default_mode,
           "deterministic": {"solve": solve, "step": step_rec,
                             "batch": batch_rec,
                             "ops_without_deterministic_version":
                                 nondeterministic_ops},
           "megastep": [m1["cost0"], m1["cost"], m2["cost"]],
           "two_ranks": two,
           "k1_launches": lk.lk_track.launches + lk.lk_level.launches,
           "world1_s": world1_s, "two_ranks_s": time.perf_counter() - t0,
           **world1_factors, **world1_graphs}
    if not solve_agrees(default_mode["sharded_dev"],
                        default_mode["sharded_dcost_over_cost0"]):
        raise SystemExit(f"multichip: the world-1 sharded solve disagrees "
                         f"with the single solve: {rec}")
    if not (solve_agrees(solve["max_dev"], solve["dcost_over_cost0"])
            and solve["accepted"] == solve["accepted_single"]):
        raise SystemExit(f"multichip: the world-1 sharded solve disagrees "
                         f"with the single solve: {rec}")
    # the solve captured in the default mode and under deterministic
    # algorithms, the step under them; 6 solves, a step, a batch replayed
    keys = [c["key"] for c in world1_graphs["graphs_captured"]]
    if not (backend == "nccl"
            and sorted(k for k in keys if k.startswith(("solve(", "step(")))
            == ["solve()", "solve(deterministic)", "step(deterministic)"]
            and world1_graphs["replays"] >= 6 + 1 + 1):
        raise SystemExit(f"multichip: the world-1 NCCL sharded solve and "
                         f"step did not run as captured programs: {rec}")
    if not solve_agrees(step_rec["max_dev"], step_rec["dcost_over_cost"]):
        raise SystemExit(f"multichip: the sharded step disagrees with the "
                         f"unsharded step: {rec}")
    if not (solve_agrees(batch_rec["max_lane_dev"],
                         batch_rec["max_cost_dev_over_cost0"])
            and batch_rec["accepted_equal"]):
        raise SystemExit(f"multichip: the seq-sharded batch disagrees with "
                         f"the batch: {rec}")
    if not (np.isfinite(m2["cost"]) and m1["cost"] < m1["cost0"]):
        raise SystemExit(f"multichip: the megastep chain's cost did not "
                         f"fall: {rec}")
    if not (two["backend"] == "gloo" and two["device"].startswith("cuda")
            and two["mesh"] == {"seq": 1, "fac": 2}
            and rec["k1_launches"] == 0):
        raise SystemExit(f"multichip: the two-rank run is not gloo over "
                         f"CUDA tensors at fac = 2: {rec}")
    return rec


# the command line's phase: bench.py --mode image's blobs scene, its
# motion slowed to 0.4x: at the bench's own motion (~1.3 rad/s, ~75 px a
# frame) the 10 Hz tracks live one frame (median), and neither package's
# visual bootstrap finds 20 tracks across its 11-frame window. At 0.4x
# both packages initialize at frame 25; 10 s then leave 30 megasteps after
# the 40 warmup frames
CLI_S = 10.0
CLI_SPEED = 0.4
ROOT = Path(__file__).resolve().parent
CLI_DIR = ROOT / "build" / "cli"
# absolute stamps of the bag: the sequence starts at this ROS time (s)
CLI_T0_S = 1_600_000_000
_U32 = struct.Struct("<I")


def _bag_header(**fields):
    return b"".join(_U32.pack(len(k) + 1 + len(v)) + k.encode() + b"=" + v
                    for k, v in fields.items())


def _bag_record(header, data):
    return _U32.pack(len(header)) + header + _U32.pack(len(data)) + data


def _ros_stamp(t_ns):
    return struct.pack("<II", t_ns // 1_000_000_000, t_ns % 1_000_000_000)


def _ros_msg_header(t_ns, frame_id):
    return _U32.pack(0) + _ros_stamp(t_ns) + _U32.pack(len(frame_id)) \
        + frame_id


def imu_message(t_ns, gyro, accel):
    """A serialized sensor_msgs/Imu (no orientation, zero covariances)."""
    z4, z9 = np.zeros(4).tobytes(), np.zeros(9).tobytes()
    return (_ros_msg_header(t_ns, b"imu") + z4 + z9
            + np.asarray(gyro, "<f8").tobytes() + z9
            + np.asarray(accel, "<f8").tobytes() + z9)


def image_message(t_ns, img):
    """A serialized sensor_msgs/Image, mono8."""
    h, w = img.shape
    return (_ros_msg_header(t_ns, b"cam") + _U32.pack(h) + _U32.pack(w)
            + _U32.pack(5) + b"mono8" + b"\x00" + _U32.pack(w)
            + _U32.pack(h * w) + np.ascontiguousarray(img, np.uint8).tobytes())


def write_bag(path, chunks):
    """A rosbag 2.0 file (http://wiki.ros.org/Bags/Format/2.0) with
    uncompressed chunks. chunks: lists of (conn id, topic, type, t_ns,
    payload); each chunk declares the connections it uses, as rosbag
    record writes them. No index records (the reader scans chunks)."""
    conns = {m[0] for c in chunks for m in c}
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        hdr = _bag_header(op=b"\x03", index_pos=struct.pack("<Q", 0),
                          conn_count=_U32.pack(len(conns)),
                          chunk_count=_U32.pack(len(chunks)))
        f.write(_bag_record(hdr, b" " * (4096 - len(hdr))))
        for msgs in chunks:
            body, seen = [], set()
            for cid, topic, mtype, t_ns, payload in msgs:
                if cid not in seen:
                    seen.add(cid)
                    body.append(_bag_record(
                        _bag_header(op=b"\x07", conn=_U32.pack(cid),
                                    topic=topic.encode()),
                        _bag_header(topic=topic.encode(), type=mtype.encode(),
                                    md5sum=b"0" * 32,
                                    message_definition=b"")))
                t = struct.pack("<Q", (t_ns % 1_000_000_000) << 32
                                | (t_ns // 1_000_000_000))
                body.append(_bag_record(
                    _bag_header(op=b"\x02", conn=_U32.pack(cid), time=t),
                    payload))
            data = b"".join(body)
            f.write(_bag_record(_bag_header(op=b"\x05", compression=b"none",
                                            size=_U32.pack(len(data))), data))


def write_cli_config(d, sim, cam):
    """The reference's three-file config (main, camera, IMU) for the
    sequence: knots 0.05 s, image weight 800, the reference's IMU noise,
    the line delay free in [0, 3.5e-5], T_CtoI from the sim's extrinsics;
    cam_tumrs.yaml's Kannala-Brandt camera and tracker knobs."""
    T = np.eye(4)
    T[:3, :3] = so3np.quat_to_matrix(so3np.quat_exp(
        np.asarray(sim.cfg.ext_rot, np.float64))[None])[0]
    T[:3, 3] = sim.cfg.ext_pos
    (d / "cam.yaml").write_text(f"""%YAML:1.0
---
model_type: KANNALA_BRANDT
camera_name: camera
image_width: 1280
image_height: 1024
projection_parameters:
   k2: {cam.k2!r}
   k3: {cam.k3!r}
   k4: {cam.k4!r}
   k5: {cam.k5!r}
   mu: {cam.mu!r}
   mv: {cam.mv!r}
   u0: {cam.u0!r}
   v0: {cam.v0!r}
max_cnt: 150
min_dist: 25
freq: 10
F_threshold: 1.0
equalize: 1
reject_wf: 0
""")
    (d / "imu.yaml").write_text(f"%YAML:1.0\n---\nimu_topic: /imu0\n"
                                f"gravity_mag: {sim.cfg.gravity!r}\n")
    data = ", ".join(repr(float(x)) for x in T.reshape(-1))
    (d / "main.yaml").write_text(f"""%YAML:1.0
---
config_path: {d}/
imu_yaml: imu.yaml
camera_yaml: cam.yaml
knot_distance: 0.05
image_weight: 800
gyroscope_noise_density: 4.0e-3
accelerometer_noise_density: 8.0e-2
gyroscope_random_walk: 2.0e-5
accelerometer_random_walk: 4.0e-4
ld_init: 0.0
fix_ld: 0
ld_lower: 0.0
ld_upper: 3.5e-5
T_CtoI: !!opencv-matrix
   rows: 4
   cols: 4
   dt: d
   data: [ {data} ]
""")
    return d / "main.yaml"


def run_module(module, *args, timeout, log):
    """Run `python -m <module> <args>` from the repository root; returns
    (seconds, stdout, stderr), both written to `log`. The process is
    killed if this one is stopped first."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", module,
                             *map(str, args)], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log.write_text(out + err)
    if proc.returncode != 0:
        raise SystemExit(f"`python -m {module} {' '.join(map(str, args))}` "
                         f"exited with {proc.returncode}:\n{err[-3000:]}")
    return time.perf_counter() - t0, out, err


def cli(*args, timeout):
    """Run `python -m ctrlvio_tpu_torch <args>` from the repository root;
    returns (seconds, stderr)."""
    seconds, _, err = run_module("ctrlvio_tpu_torch", *args, timeout=timeout,
                                 log=CLI_DIR / f"{args[0]}.log")
    return seconds, err


def phase_cli():
    """The port's command line on the card, as a user runs the
    reference's full operating mode: `bench.py --mode image`'s blobs
    scene (1280x1024 Kannala-Brandt, seed 3, 1500 landmarks, clutter) for
    10 s at 0.4x its motion (`CLI_SPEED`), rendered and written as a
    rosbag with a three-file config, then
    `convert`, `run --bootstrap visual --out traj.tum --check-syncs` (the
    card, f32, stream on: FusedTracker with the 2-level K1 track, the
    visual bootstrap, 40 warmup frames, then the megastep) and `viz`
    (HTML). Gates on the trajectory the user gets: stamps increasing,
    quaternions unit; ATE against ground truth < 0.15 m, yaw-aligned, over
    the TUM samples from the bootstrap frame on; line-delay error < 5 us
    (`run`'s line_delay= line); >= 10 megasteps and no synchronizing call
    inside any; one 2-level K1 track launch a frame, no other K1 launch
    and no plain LK call (`run`'s stats line, counted in its process)."""
    from ctrlvio_tpu_torch.utils.viz import load_tum

    CLI_DIR.mkdir(parents=True, exist_ok=True)
    cam = tumrs_camera()
    t0 = time.perf_counter()
    sim = image_sim(CLI_S, 1500, speed=CLI_SPEED)
    imgs = render.render_sequence(sim, 1024, 1280, camera=cam, seed=1,
                                  big_every=6, texture=6.0)
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    base = CLI_T0_S * 1_000_000_000
    msgs = [(0, "/imu0", "sensor_msgs/Imu", base + int(t),
             imu_message(base + int(t), g, a))
            for t, g, a in zip(sim.imu_t_ns, sim.gyro, sim.accel)]
    msgs += [(1, "/cam0/image_raw", "sensor_msgs/Image", base + fr.t_ns,
              image_message(base + fr.t_ns, imgs[i]))
             for i, fr in enumerate(sim.frames)]
    msgs.sort(key=lambda m: m[3])
    bag, npz = CLI_DIR / "seq.bag", CLI_DIR / "seq.npz"
    tum, html = CLI_DIR / "traj.tum", CLI_DIR / "traj.html"
    write_bag(bag, [msgs[i:i + 400] for i in range(0, len(msgs), 400)])
    main_yaml = write_cli_config(CLI_DIR, sim, cam)
    t_bag = time.perf_counter() - t0
    del imgs, msgs

    convert_s, _ = cli("convert", bag, npz, timeout=300)
    run_s, err = cli("run", main_yaml, npz, "--bootstrap", "visual",
                     "--out", tum, "--check-syncs", timeout=900)
    viz_s, _ = cli("viz", tum, "-o", html, timeout=120)
    stats = json.loads(next(ln for ln in err.splitlines()
                            if ln.startswith("[run] stats "))[12:])
    ld = float(re.search(r"line_delay=([-\d.]+) us", err).group(1)) * 1e-6

    if stats["init_t_ns"] is None:
        raise SystemExit(f"cli: the visual bootstrap never initialized: "
                         f"{stats}")
    t, p, q = load_tum(str(tum))
    t_rel = t - CLI_T0_S
    after = t_rel >= (stats["init_t_ns"] - base) * 1e-9
    gt = np.stack([sim.pose_at(x)[1] for x in t_rel[after]])
    ate = ate_rmse(p[after], gt, align="yaw")
    ld_err = abs(ld - sim.cfg.line_delay)
    c = stats["counts"]
    frames = stats["frames"]
    rec = {"phase": "cli", "duration_s": CLI_S, "frames": frames,
           "render_s": t_render, "bag_s": t_bag,
           "bag_mb": bag.stat().st_size / 2**20, "convert_s": convert_s,
           "run_s": run_s, "viz_s": viz_s, "run_wall_s": stats["wall_s"],
           "poses": stats["poses"], "bootstrap_frame": stats["init_frame"],
           "tum_rows": len(t), "ate_rows": int(after.sum()), "ate_m": ate,
           "line_delay_s": ld, "line_delay_true_s": sim.cfg.line_delay,
           "ld_err_s": ld_err, "megasteps": c.get("megastep", 0),
           "megastep_syncs": c.get("megastep_syncs", 0),
           "sync_solves": c.get("sync_solve", 0),
           "sync_solves_after_handoff": c.get("sync_solve_after_handoff", 0),
           "bootstrap_visual": c.get("bootstrap_visual", 0),
           "bootstrap_rejected": c.get("bootstrap_rejected", 0),
           "marg_overflows": c.get("marg_overflow", 0),
           "frontend_dispatch_syncs": stats["frontend_dispatch_syncs"],
           "frame_ms_median": stats["frame_ms_median"],
           "sustained_fps": stats["sustained_fps"],
           "k1_track_launches": stats["k1_track_launches"],
           "k1_track_launches_by_levels": stats["k1_track_launches_by_levels"],
           "k1_level_launches": stats["k1_level_launches"],
           "plain_lk_track_calls": stats["plain_lk_track_calls"],
           "plain_lk_level_calls": stats["plain_lk_level_calls"],
           **factor_fields(stats["factor_kernels"], stats["lm_kernels"]),
           "html_bytes": html.stat().st_size,
           "card": card_name_and_power_limit(),
           "timing_s": stats["timing_s"],
           "bootstrap_s": {k: stats["timing_s"].get(k, 0.0)
                           for k in BOOT_KEYS},
           **graph_fields(stats["graphs"])}
    rec.update(iters_fields([stats["lm_iters"]], rec))
    # where `run`'s wall time went: the estimator's top-level phases (the
    # bootstrap's among them; the captures happen inside them) and the
    # front end's
    top = {k: stats["timing_s"].get(k, 0.0) for k in RUN_TOP_KEYS}
    fe = stats["frontend_timing_s"]
    top["frontend"] = fe.get("dispatch", 0.0) + fe.get("consume", 0.0)
    rec["run_attributed_s"] = top
    rec["run_unattributed_s"] = stats["wall_s"] - sum(top.values())
    steps = np.diff(t)
    unit = np.abs(np.linalg.norm(q, axis=1) - 1.0).max()
    if not (len(t) > 100 and bool((steps > 0).all()) and unit < 1e-6
            and np.isfinite(p).all()):
        raise SystemExit(f"cli: the TUM trajectory is malformed (stamps "
                         f"increasing, unit quaternions): {rec}")
    if not (ate < 0.15 and ld_err < 5e-6):
        raise SystemExit(f"cli fails its accuracy gates (ATE < 0.15 m, "
                         f"line-delay error < 5 us): {rec}")
    if not (rec["megasteps"] >= 10 and rec["megastep_syncs"] == 0):
        raise SystemExit(f"cli did not stream (>= 10 megasteps, no "
                         f"synchronizing call inside one): {rec}")
    if not (iters_exact(rec) and "window_solve(bootstrap, float64)" in [
            c["key"] for c in rec["graphs_captured"]]):
        raise SystemExit(f"cli: the f64 bootstrap BA did not run as a "
                         f"program, or the LM's exit nodes did not run "
                         f"exactly the iterations its solves needed: {rec}")
    if not (k1_once_a_frame(rec["k1_track_launches"], rec, frames)
            and rec["k1_track_launches_by_levels"] == {
                "2": rec["k1_track_launches"]}
            and rec["k1_level_launches"] == 0
            and rec["plain_lk_track_calls"] == 0
            and rec["plain_lk_level_calls"] == 0):
        raise SystemExit(f"cli did not run through one 2-level K1 track "
                         f"launch a frame: {rec}")
    for f in (bag, npz):
        f.unlink()
    return rec


# the bench phase: the port's measuring entry points as a user runs them.
# e2e at the accuracy matrix's row 7 (lissajous ground truth, seed 3,
# 1.0x), its 16 s cut to 12 s as the e2e phase's; the blobs image run at
# the card preset's 12 s (`ctrlvio_tpu_torch/bench.py`): its timing starts
# after the stream's warm-up and 10 frames more, frame 50
BENCH_DIR = ROOT / "build" / "bench"
BENCH_E2E = ("--mode", "e2e", "--gt", "lissajous", "--seed", 3, "--speed",
             1.0, "--duration", 12)
BENCH_IMAGE = ("--mode", "image", "--scene", "blobs", "--duration", 12)
# the keys of bench.py's e2e line (`bench.py:365-374`)
BENCH_E2E_KEYS = ["metric", "value", "unit", "vs_baseline", "ate_online_cm",
                  "ate_posthoc_cm", "ld_err_us", "gt", "seed", "speed"]
SWEEP_BATCHES = [1, 2, 4, 8, 16]


def last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def phase_bench():
    """The port's measuring entry points on the card, as subprocesses:
    `python -m ctrlvio_tpu_torch.bench` at the accuracy matrix's lissajous
    row (e2e, the visual bootstrap, the stream, f32; 12 s), gated on exit
    code 0, its JSON line with bench.py's keys and `gt == "lissajous"`,
    and bench.py's gates read from that line (online and post-hoc ATE
    < 10 cm, line-delay error < 2 us); `--mode image --scene blobs
    --duration 12` (FusedTracker with lag=1 and K1, the streaming
    estimator from the ground-truth bootstrap, frames timed from the 50th,
    after the stream's warm-up), gated on exit code 0, its JSON line with
    a positive frame rate and, from its `[bench-image] stats` line (counts
    zeroed before its replay and read after), at least one megastep and
    one K5 launch, one 3-level K1 launch a frame and no plain LK call; `python -m ctrlvio_tpu_torch.tools.profile_serve
    --sweep --reps 3`: ms a batched megastep at B = 1..16; `python -m
    ctrlvio_tpu_torch.tools.ne_ab` at its defaults (dense against
    chunked/128 normal equations at B = 1 and 16, each variant's batched
    megastep a captured program, replayed: the verdict from the card's
    time, not the host's dispatch). Then, in this
    process, `entry()` on the card: its outputs finite and within f32
    rounding of `entry(device="cpu")` (knots_p within 1e-5 m, the line
    delay within 1e-9 s, the cost within 1e-7 of the starting cost). The
    phase runs at a lower scheduling priority (nice 10, inherited by its
    subprocesses): it is the fourth process dispatching beside the earlier
    phases, and they keep the host's cores first, so their host times stay
    comparable with earlier runs; this phase gates no time."""
    os.nice(10)
    BENCH_DIR.mkdir(parents=True, exist_ok=True)
    t_run0 = time.perf_counter()
    e2e_s, out, _ = run_module("ctrlvio_tpu_torch.bench", *BENCH_E2E,
                               timeout=900, log=BENCH_DIR / "e2e.log")
    e2e = last_json(out)
    image_s, out, err = run_module("ctrlvio_tpu_torch.bench", *BENCH_IMAGE,
                                   timeout=600, log=BENCH_DIR / "image.log")
    image = last_json(out)
    stats = json.loads(next(ln for ln in err.splitlines()
                            if ln.startswith("[bench-image] stats "))[20:])
    sweep_s, out, _ = run_module(
        "ctrlvio_tpu_torch.tools.profile_serve", "--sweep", "--reps", 3,
        timeout=600, log=BENCH_DIR / "profile_serve.log")
    sweep = last_json(out)
    ne_ab_s, out, _ = run_module("ctrlvio_tpu_torch.tools.ne_ab",
                                 timeout=600, log=BENCH_DIR / "ne_ab.log")
    ne_ab = last_json(out)

    fn, args = entry("cuda")
    t_entry, got = time_min(lambda: fn(*args))
    fn_c, args_c = entry("cpu")
    ref = fn_c(*args_c)
    prob = tiny.tiny_problem(torch.float32, device="cpu")
    _, st = lm.solve_window(*args_c, *prob.aux, prob.cfg,
                            SolveOptions(max_iters=0))
    got = [x.double().cpu() for x in got]
    ref = [x.double() for x in ref]
    entry_rec = {"ms": t_entry * 1e3,
                 "knots_p_dev_m": float((got[0] - ref[0]).abs().max()),
                 "ld_dev_s": abs(float(got[1] - ref[1])),
                 "cost": float(got[2]), "cost_cpu": float(ref[2]),
                 "cost0": float(st.cost0),
                 "finite": all(bool(torch.isfinite(x).all()) for x in got)}
    frames = stats["frames"]
    rec = {"phase": "bench", "wall_s": time.perf_counter() - t_run0,
           "e2e": {"argv": list(map(str, BENCH_E2E)), "seconds": e2e_s,
                   "result": e2e},
           "image": {"argv": list(map(str, BENCH_IMAGE)), "seconds": image_s,
                     "result": image, "stats": stats},
           "profile_serve_sweep": {"seconds": sweep_s, **sweep},
           "ne_ab": {"seconds": ne_ab_s, **ne_ab},
           "entry": entry_rec, "card": card_name_and_power_limit(),
           "image_graphs": graph_fields(stats["graphs"]),
           "image_factor_kernels": factor_fields(stats["factor_kernels"],
                                                 stats["lm_kernels"])}
    if not (list(e2e) == BENCH_E2E_KEYS and e2e["gt"] == "lissajous"
            and e2e["ate_online_cm"] < 10 and e2e["ate_posthoc_cm"] < 10
            and e2e["ld_err_us"] < 2):
        raise SystemExit(f"bench: the lissajous e2e row's line fails "
                         f"bench.py's keys or gates: {rec}")
    if not (image["metric"] == "image_frames_per_sec_per_chip"
            and image["value"] > 0
            and stats["counts"].get("megastep", 0) >= 1
            and stats["factor_kernels"]["residual_summary"] >= 1):
        raise SystemExit(f"bench: the image run timed no streamed frame "
                         f"(a positive frame rate, a megastep and a K5 "
                         f"launch): {rec}")
    if not (k1_once_a_frame(stats["k1_track_launches"],
                                rec["image_graphs"], frames)
            and stats["k1_track_launches_by_levels"] == {
                "3": stats["k1_track_launches"]}
            and stats["k1_level_launches"] == 0
            and stats["plain_lk_track_calls"] == 0
            and stats["plain_lk_level_calls"] == 0):
        raise SystemExit(f"bench: the image run did not go through one "
                         f"3-level K1 launch a frame: {rec}")
    if [r["B"] for r in sweep["sweep"]] != SWEEP_BATCHES or not all(
            np.isfinite(r["ms_per_step"]) and r["ms_per_step"] > 0
            for r in sweep["sweep"]):
        raise SystemExit(f"bench: profile_serve's sweep is incomplete: {rec}")
    if not (len(ne_ab["results"]) == 4 and all(
            r["graphed"] and np.isfinite(r["ms_per_step"])
            and r["ms_per_step"] > 0 for r in ne_ab["results"])):
        raise SystemExit(f"bench: ne_ab did not time its four variants' "
                         f"programs: {rec}")
    if not (entry_rec["finite"] and entry_rec["knots_p_dev_m"] <= 1e-5
            and entry_rec["ld_dev_s"] <= 1e-9
            and abs(entry_rec["cost"] - entry_rec["cost_cpu"])
            <= 1e-7 * entry_rec["cost0"]):
        raise SystemExit(f"bench: entry() on the card disagrees with the "
                         f"CPU: {rec}")
    return rec


def side_phases(conn, names):
    """Child process: run the named phases in order. Sends ("ok", their
    records) or ("failed", message) through `conn`. SIGTERM from the
    parent becomes SystemExit, so that a phase's subprocesses are
    stopped with it."""
    import signal

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    pin_f32_matmuls()
    try:
        conn.send(("ok", [globals()[n]() for n in names]))
    except SystemExit as e:
        conn.send(("failed", str(e)))
    except Exception:  # the boundary of the child: report, the parent fails
        import traceback

        conn.send(("failed", traceback.format_exc()))
    finally:
        conn.close()


def start_side(*names):
    """Run phases in a spawned process beside the image phases. Every
    phase is the host's dispatch of small kernels with the card idle ~95 %
    of the time, so processes dispatch side by side and the script stays
    inside its time limit; every side's host times are taken under that
    contention. Returns (process, receiving end)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv_end, send_end = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=side_phases, args=(send_end, names),
                       daemon=True)
    proc.start()
    send_end.close()
    return proc, recv_end


def side_result(side):
    """The records of a side process's phases; fails if it failed."""
    proc, recv = side
    try:
        status, result = recv.recv()
    except EOFError:
        proc.join()
        raise SystemExit(f"a side process died (exit code {proc.exitcode})")
    if status != "ok":
        raise SystemExit(result)
    return result


def main():
    phase_device()
    render_proc = start_render()
    sides = []
    try:
        phase_build()
        level = phase_k1_level()
        k1 = phase_k1_track()
        accept = phase_lm_accept()
        while_node = phase_while_node()
        factors = phase_factor_kernels()
        # the kernel checks above have the card to themselves
        sides = [start_side("phase_serve", "phase_batch"),
                 start_side("phase_cli"), start_side("phase_multichip"),
                 start_side("phase_bench"), start_side("phase_graphs")]
        main_rec, seq = phase_main()
        launches = main_rec["k1_track_launches"]
        marg_dev = phase_main_marg_dev(main_rec, seq)
        del seq
        e2e = phase_e2e()
        textured = phase_image_textured(render_proc)
        serve, batched = side_result(sides[0])
        (cli_rec,) = side_result(sides[1])
        (multichip,) = side_result(sides[2])
        (bench,) = side_result(sides[3])
        (graphs_rec,) = side_result(sides[4])
    finally:
        if render_proc.is_alive():
            render_proc.terminate()
        render_proc.join()
        for proc, _ in sides:
            # it has sent its result, or the script is failing: 30 s to end
            proc.join(timeout=30)
            if proc.is_alive():
                proc.terminate()
                proc.join()
    check_serve_device_ops(serve, e2e["eager_megastep_stages"]["device_ops"])
    paths = {"main": main_rec, "main_marg_dev": marg_dev, "e2e": e2e,
             "image_textured": textured, "classic": textured["classic"],
             "serve": serve, "batch": batched, "cli": cli_rec,
             "multichip": multichip, "bench_image": bench[
                 "image_factor_kernels"]}
    check_factor_launches(paths)
    emit(serve)
    emit(batched)
    emit(cli_rec)
    emit(multichip)
    emit(bench)
    emit(graphs_rec)
    kernels = [{
        "name": "K1 lk_track", "route": "cuda",
        "source": "ctrlvio_tpu_torch/csrc/lk.cu",
        "replaces": "ctrlvio_tpu/ops/pallas/lk_kernel.py:118",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "launches_replayed": main_rec["k1_launches_replayed"],
        "launches_warm_up": main_rec["k1_launches_warm_up"],
        "marg_dev_launches": marg_dev["k1_track_launches"],
        "ms": k1["ms"], "device_ms": k1["device_ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None,
        "level_ms": level["ms"], "level_device_ms": level["device_ms"],
        "level_max_abs_err": level["max_abs_err"],
        "four_levels": k1["four_levels"],
        "two_levels": k1["two_levels"],
        "e2e_launches": e2e["k1_launches"],
        "textured_launches": textured["k1_track_launches_by_levels"],
        "classic_launches": textured["classic"][
            "k1_track_launches_by_levels"],
        "serve_launches": serve["k1_launches"],
        "batch_launches": batched["k1_launches"],
        "cli_launches": cli_rec["k1_track_launches_by_levels"],
        "multichip_launches": multichip["k1_launches"],
        "bench_launches": {
            "image": bench["image"]["stats"]["k1_track_launches_by_levels"],
            "image_frames": bench["image"]["stats"]["frames"]}}, {
        "name": "K4 lm_accept", "route": "cuda",
        "source": "ctrlvio_tpu_torch/csrc/lm_accept.cu",
        "replaces": "ctrlvio_tpu/solver/lm.py:232",
        "replaces_note": "not a TPU kernel: XLA's fusion of the JAX "
                         "package's LM body's accept test, selects and "
                         "scalars and its while_loop's cond (lm.py:232-249)",
        "launches": e2e["k4_launches"], "max_abs_err": accept["max_abs_err"],
        **{k: accept[k] for k in (
            "ms", "in_place_accept_ms", "in_place_reject_ms", "vmapped_ms",
            "plain_ms", "plain_in_place_ms", "bound_ms", "bound_by",
            "in_place_reject_bound_ms", "f64", "attributes")},
        "library_ms": None,
        "while_node": {k: while_node[k] for k in (
            "ms_per_iteration", "plain_ms_per_iteration")},
        "launches_by_path": {p: r["k4_launches"] for p, r in paths.items()},
        "e2e_range": "LM accept",
        "e2e_range_launches": e2e["eager_megastep_stages"]["ranges"][
            "LM accept"]["kernel_launches"]}]
    replaced = {
        "k2": ("ctrlvio_tpu/solver/assemble.py:49", "vmapped _image_blocks "
               "and its one-hot expansion into dense rows"),
        "k3": ("ctrlvio_tpu/solver/assemble.py:84", "vmapped _imu_blocks "
               "and its one-hot expansion into dense rows"),
        "k5": ("ctrlvio_tpu/solver/assemble.py:419", "residual_rms and "
               "total_cost (:481): the factors' residuals, the prior's "
               "product and the masked sums")}
    for kname, (name, stage) in FACTOR_KERNELS.items():
        k = factors[kname]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ctrlvio_tpu_torch/csrc/factors.cu",
            "replaces": replaced[kname][0],
            "replaces_note": f"not a TPU kernel: XLA's fusions of the JAX "
                             f"package's {replaced[kname][1]}",
            "launches": e2e[f"{kname}_launches"],
            "max_abs_err": k["max_abs_err"], "max_rel_err": k["max_rel_err"],
            "ms": k["ms"], "call_ms": k["call_ms"], "plain_ms": k["plain_ms"],
            "plain_graph_ms": k["plain_graph_ms"],
            "vmapped_ms": k["vmapped_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "bound_bytes": k["bytes"],
            "bound_operations": k["operations"], "library_ms": None,
            "f64": k["f64"], "batch_window": k["batch_window"],
            "attributes": k["attributes"],
            "launches_by_path": {p: r[f"{kname}_launches"]
                                 for p, r in paths.items()},
            "e2e_range": stage,
            "e2e_range_launches": e2e["eager_megastep_stages"]["ranges"][
                stage]["kernel_launches"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
