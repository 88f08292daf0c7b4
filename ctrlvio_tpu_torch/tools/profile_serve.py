"""Per-op profile and B sweep of the serve path's batched megastep
(counterpart of `tools/profile_serve.py`).

    python -m ctrlvio_tpu_torch.tools.profile_serve [--batch 16] [--reps 5]
        [--logdir DIR] [--top 40] [--sweep] [--device cuda|cpu]

A short streaming replay from the ground-truth bootstrap captures a
realistic steady state: the device window state and one frame's upload
blob. The state is copied, stacked B times and run through
`parallel/stream_batch.py::batched_megastep` as `BatchedStream` runs it
each frame: on the card its captured program (`utils/graphs.py`),
replayed. Untraced, it times the mean ms a step over `--reps` chained
steps after 3 warm ones, with a synchronize at each end. Then
`--reps` steps are traced with `torch.profiler` and the `--top` ops are
listed by time: on the card the kernels' device time (CUDA
activity only), on the CPU the ops' host time. The trace is written
under `--logdir` as a Chrome trace (`chrome://tracing`, Perfetto or
TensorBoard's profiler plugin open it), its path printed to stderr.
`--sweep` times B = 1, 2, 4, 8, 16 untraced instead, and writes no trace.
The table goes to stderr; the last line of stdout is one JSON object of
the results.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ctrlvio_tpu_torch.bench import BENCH_WINDOW, started_vio, sync
from ctrlvio_tpu_torch.estimator.odometry import VIOConfig
from ctrlvio_tpu_torch.parallel.batch import stack
from ctrlvio_tpu_torch.parallel.stream_batch import batched_megastep
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.utils import graphs
from ctrlvio_tpu_torch.utils.device import resolve_device
from ctrlvio_tpu_torch.utils.precision import pin_f32_matmuls

SWEEP = (1, 2, 4, 8, 16)
LOGDIR = os.path.join(tempfile.gettempdir(), "ctrlvio_serve_trace")


def capture_state(duration=6.0, warmup=10, device="cuda"):
    """A short streaming run (noiseless, seed 3, 300 landmarks, f32, the
    bench's window, the ground-truth bootstrap, the line delay started at
    its true value, `warmup` synchronous frames). The estimator's upload
    is wrapped to keep the host blob a streamed frame sends; returns
    (vio, a copy of the final device state, the last dispatched frame's
    blob)."""
    sim = synthetic.generate(synthetic.SimConfig(
        duration=duration, n_landmarks=300, seed=3))
    cfg = VIOConfig(window_config=BENCH_WINDOW, fix_ld=False,
                    ld_init=sim.cfg.line_delay, dtype=torch.float32,
                    stream=True, stream_warmup=warmup)
    vio = started_vio(sim, cfg, resolve_device(device))
    grabbed = {}
    upload = vio._upload

    def keep(blob):
        if vio._stream_frame_no > cfg.stream_warmup:
            grabbed["blob"] = np.array(blob)
        return upload(blob)

    vio._upload = keep
    for i, fr in enumerate(sim.frames):
        vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
        if i % 10 == 0:
            print(f"[capture] frame {i}/{len(sim.frames)}", file=sys.stderr,
                  flush=True)
    vio.flush()
    if "blob" not in grabbed:
        raise RuntimeError("the stream never dispatched: lengthen the "
                           "capture or shorten its warmup")
    return vio, graphs.clone(vio._dev_state), grabbed["blob"]


def batched_inputs(vio, dev_state, blob, B: int):
    """(stacked states, (B, n) blobs on the device, the four shared
    constants) for a batched megastep of B copies of one lane."""
    blobs = torch.as_tensor(np.stack([blob] * B), device=vio.device)
    return (stack([dev_state] * B), blobs,
            (vio._ext, vio._gravity_j, vio._imu_info, vio._sqrt_info_img))


def lane_megastep(vio):
    """The batched megastep `BatchedStream` would run for lanes of `vio`'s
    configuration."""
    return batched_megastep(vio.wc, vio._ba_opts, vio.cfg.marg_caps,
                            vio.cfg.ne_mode, vio.cfg.ne_chunk)


def lane_program(vio, st, blobs, consts):
    """`lane_megastep(vio)` for these arguments as `BatchedStream` runs
    it: on the card the program captured for them, on the CPU the
    function."""
    return graphs.ProgramCache().get(
        lane_megastep(vio), (st, blobs, *consts), vio.device, carry=True,
        label=f"batched_megastep(B={blobs.shape[0]})")


def time_steps(mega, st, blobs, consts, reps: int, device, warm: int = 3):
    """Mean seconds a step over `reps` chained steps after `warm` ones
    (the state fed back on the device); returns (seconds, last state,
    last summaries)."""
    out = None
    for _ in range(warm):
        st, out = mega(st, blobs, *consts)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        st, out = mega(st, blobs, *consts)
    sync(device)
    return (time.perf_counter() - t0) / reps, st, out


def op_table(mega, st, blobs, consts, reps: int, device, trace_path=None):
    """`reps` steps under torch.profiler; returns [(op name, total ms,
    count)] sorted by time, descending: the kernels' device time on the
    card (CUDA activity only), the ops' self host time on the CPU. Read
    from the profiler's raw events: `key_averages()` takes ~30 s for 1e5
    events on the host, and one CPU step makes ~3e5. With `trace_path`
    the trace is also written there as a Chrome trace (JSON)."""
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    kind = (torch.autograd.DeviceType.CUDA if on_card
            else torch.autograd.DeviceType.CPU)
    acts = [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        for _ in range(reps):
            st, _ = mega(st, blobs, *consts)
        sync(device)
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == kind]
    agg = {}
    for name, ns in (((e.name(), e.duration_ns()) for e in events)
                     if on_card else self_times(events)):
        t, c = agg.get(name, (0, 0))
        agg[name] = (t + ns, c + 1)
    return sorted(((k, t * 1e-6, c) for k, (t, c) in agg.items()),
                  key=lambda r: -r[1])


def self_times(events):
    """(name, self ns) of each host event: its duration less its direct
    children's, the events nesting by time on their thread."""
    out = []
    by_thread = {}
    for e in events:
        by_thread.setdefault(e.start_thread_id(), []).append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e.start_ns(), -e.duration_ns()))
        stack = []  # [end_ns, name, duration, children's duration]
        for e in evs:
            t0, d = e.start_ns(), e.duration_ns()
            while stack and stack[-1][0] <= t0:
                _, n, dur, kids = stack.pop()
                out.append((n, dur - kids))
            if stack:
                stack[-1][3] += d
            stack.append([t0 + d, e.name(), d, 0])
        out.extend((n, dur - kids) for _, n, dur, kids in stack)
    return out


def sweep(vio, dev_state, blob, reps: int, batches=SWEEP):
    """Untraced ms a step for each B: [{B, ms_per_step, frames_per_s,
    ms_per_lane}]."""
    out = []
    for B in batches:
        st, blobs, consts = batched_inputs(vio, dev_state, blob, B)
        mega = lane_program(vio, st, blobs, consts)
        dt, _, _ = time_steps(mega, st, blobs, consts, reps, vio.device)
        out.append({"B": B, "ms_per_step": dt * 1e3,
                    "frames_per_s": B / dt, "ms_per_lane": dt / B * 1e3})
        print(f"[sweep] B={B:2d}: {dt * 1e3:7.1f} ms/step "
              f"({B / dt:6.1f} frames/s aggregate, "
              f"{dt / B * 1e3:6.2f} ms/lane)", file=sys.stderr, flush=True)
    return out


def trace_file(logdir: str, B: int) -> str:
    """A new Chrome-trace path under `logdir` (made if missing) for a
    traced run at B lanes."""
    os.makedirs(logdir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return os.path.join(logdir, f"serve_B{B}_{stamp}_{os.getpid()}"
                                ".pt.trace.json")


def profile_batch(vio, dev_state, blob, B: int, reps: int, top: int,
                  logdir: str = LOGDIR):
    """Untraced ms a step at B, then the traced op table, its trace
    written under `logdir`. Returns the result record."""
    st, blobs, consts = batched_inputs(vio, dev_state, blob, B)
    mega = lane_program(vio, st, blobs, consts)
    dt, st, _ = time_steps(mega, st, blobs, consts, reps, vio.device)
    print(f"[profile] B={B}: {dt * 1e3:.1f} ms/step untraced "
          f"({B / dt:.1f} frames/s)", file=sys.stderr)
    path = trace_file(logdir, B)
    rows = op_table(mega, st, blobs, consts, reps, vio.device, path)
    print(f"[profile] trace written to {path}", file=sys.stderr)
    what = "device" if vio.device.type == "cuda" else "host (CPU)"
    tot = sum(r[1] for r in rows)
    print(f"[profile] total {what} op time {tot:.1f} ms over {reps} steps "
          f"({tot / reps:.1f} ms/step), {sum(r[2] for r in rows)} ops",
          file=sys.stderr)
    for name, ms, cnt in rows[:top]:
        print(f"  {ms / reps:9.3f} ms/step  x{cnt:5d}  {name[:110]}",
              file=sys.stderr)
    return {"B": B, "reps": reps, "ms_per_step": dt * 1e3, "trace": path,
            "op_time": what,
            "op_ms_per_step": tot / reps,
            "ops_per_step": sum(r[2] for r in rows) / reps,
            "top": [{"name": n, "ms_per_step": ms / reps,
                     "count_per_step": c / reps} for n, ms, c in rows[:top]]}


def device_record(device: torch.device):
    if device.type == "cuda":
        return {"device": torch.cuda.get_device_name(device)}
    return {"device": "cpu"}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m ctrlvio_tpu_torch.tools.profile_serve")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--logdir", default=LOGDIR,
                    help="directory of the traced run's Chrome trace")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--sweep", action="store_true",
                    help="time (untraced) a sweep of batch sizes, no trace")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a "
                         "card) or cpu")
    args = ap.parse_args(argv)
    pin_f32_matmuls()

    vio, dev_state, blob = capture_state(device=args.device)
    print(f"[profile] captured steady state on {vio.device}",
          file=sys.stderr)
    rec = {"tool": "profile_serve", **device_record(vio.device)}
    if args.sweep:
        rec["sweep"] = sweep(vio, dev_state, blob, args.reps)
    else:
        rec.update(profile_batch(vio, dev_state, blob, args.batch, args.reps,
                                 args.top, args.logdir))
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
