"""One run of one cell: set-up, warm-up, the measured window, the judge.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name `BENCHMARK.json` gives:

    benchmark/configs/<config>.json   the rig, the estimator, its module
    benchmark/traffic/<mix>.json      the generator's parameters
    benchmark/cells/<cell>.json       the sequence's ceiling in calls a
                                      second, the traced calls, the period
                                      of the sampled solves, the limits
    benchmark/drivers/<driver>.py     how a call drives the port
    benchmark/metrics/<metric>.py     `read(ctx)`: the metric, or None

The window is closed-loop: the next call starts when the previous one has
returned. It opens after the warm-up and lasts `seconds`; it closes
with the port's flush and a device synchronize, whose time it counts. A
`--trace 1` run then profiles `trace_calls` more calls before the flush.
The judge (`reference`, `solve_ref`) runs once the window has closed and
the device's memory peak has been read.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import threading
import time
from pathlib import Path

import torch

from benchmark import reference, replay, solve_ref, trace

ROOT = Path(__file__).resolve().parent.parent


class SequenceExhausted(RuntimeError):
    """The generated sequence ended before the window did."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def by_name(entries, name: str, what: str):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


class Cell:
    """A workload of `BENCHMARK.json` with every file it names loaded."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        here = root / "benchmark"
        self.workload = by_name(bench["workloads"], name, "workload")
        entry = by_name(bench["configs"], self.workload["config"], "config")
        self.config = load_json(root / entry["file"])
        self.traffic = load_json(here / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.spec = load_json(here / "cells" / f"{name}.json")
        self.driver = load_module(here / "drivers"
                                  / f"{self.config['driver']}.py").Driver
        self.name = name
        self.metrics = {}
        for m in bench["end_to_end"] + bench["per_layer"]:
            if name in m.get("workloads", [name]):
                self.metrics[m["name"]] = (
                    m, load_module(here / "metrics" / f"{m['name']}.py"))

    def wanted(self, trace_on: bool):
        """The metrics a run reports: the end-to-end ones, or with the
        trace on the per-layer ones."""
        kind = "per_layer" if trace_on else "end_to_end"
        return {k: v for k, v in self.metrics.items()
                if ("layer" in v[0]) == (kind == "per_layer")}


def pin_main_thread():
    """The calling thread alone on the last CPU of the process, every other
    thread (the CUDA runtime's, the caching allocators') on the others."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 3:
        return
    me = threading.get_native_id()
    for t in os.listdir("/proc/self/task"):
        if int(t) != me:
            try:
                os.sched_setaffinity(int(t), cpus[:-1])
            except OSError:
                pass  # a thread that has ended
    os.sched_setaffinity(0, cpus[-1:])


def device_kind(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def run(cell: Cell, seed: int, seconds: float, trace_on: bool, device,
        t_start: float, log=sys.stderr):
    """One run; returns the result line (a dict) and the judge's
    per-lane numbers."""
    trace_calls = cell.spec["trace_calls"] if trace_on else 0
    drv = cell.driver(cell.config, cell.traffic, cell.spec, seed, seconds,
                      trace_calls, device)
    drv.warm_up()
    replay.sync(device)
    pin_main_thread()
    c0, tm0 = drv.counters(), drv.timing()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    lo, lat = drv.k, []
    t_open = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now - t_open >= seconds:
            break
        if drv.remaining() <= trace_calls:
            raise SequenceExhausted(
                f"the sequence ran out after {drv.k - lo} calls "
                f"({now - t_open:.2f} s of {seconds} s): raise the cell's "
                f"ceiling_calls_per_s")
        drv.call()
        lat.append(time.perf_counter() - now)
    hi = drv.k
    reading = c1 = c_tr = tm1 = None
    if trace_on:
        replay.sync(device)
        tm1, c1 = drv.timing(), drv.counters()
        reading = trace.traced(drv, trace_calls)
        c_tr = drv.counters()
    drv.close()
    replay.sync(device)
    t_close = time.perf_counter()
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)

    answers = drv.answers(lo, hi)
    t_ref = time.perf_counter()
    solves = solve_ref.check(drv.records(lo, hi), drv.seq, cell.config,
                             cell.traffic, answers[0]["start_ns"], device)
    print(f"[bench] the float64 solve check: {len(solves)} sampled calls "
          f"in {time.perf_counter() - t_ref:.1f} s", file=log)
    correct, checks, per_lane = reference.judge(
        answers, cell.config["rig"]["line_delay"], cell.spec["limits"],
        solves, drv.overflows())
    bad = sum(int(not (math.isfinite(a["q"][i].sum())
                       and math.isfinite(a["p"][i].sum())))
              for a in answers for i in range(len(a["t_ns"])))
    ctx = dict(driver=cell.config["driver"], lanes=drv.lanes,
               calls=hi - lo, call_s=lat, t_open=t_open, t_close=t_close,
               t_start=t_start, c0=c0, c1=c1, c_tr=c_tr, trace=reading,
               timing=(None if tm1 is None else
                       {k: v - tm0.get(k, 0.0) for k, v in tm1.items()}),
               window=cell.config["estimator"]["window"],
               dtype=cell.config["estimator"]["dtype"],
               kind=device_kind(device))
    metrics = {}
    for name, (entry, mod) in cell.wanted(trace_on).items():
        v = mod.read(ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_kind(device), "count": 1,
           "memory_peak_bytes": int(mem)}
    out = {"correct": bool(correct and bad == 0),
           "attempted": (hi - lo) * drv.lanes, "failed": bad,
           "metrics": metrics, "device": dev}
    if reading is not None:
        dev.update(busy_s=reading.busy_s, window_s=reading.window_s)
        out["breakdown"] = reading.breakdown()
        k4 = reading.kernel("lm_accept_kernel")
        print(f"[bench] traced {reading.calls} calls: K4 launches traced "
              f"{k4[0] if k4 else 0}, settled "
              f"{c_tr['lm']['lm_accept'] - c1['lm']['lm_accept']}; "
              f"{reading.ops} device operations ({reading.outside} outside "
              f"the sub-window)", file=log)
    tenth = max(1, len(lat) // 10)
    print("[bench] mean call ms by tenth of the window: " + " ".join(
        f"{sum(lat[i:i + tenth]) / len(lat[i:i + tenth]) * 1e3:.2f}"
        for i in range(0, len(lat), tenth)), file=log)
    for i, n in enumerate(per_lane):
        print(f"[bench] lane {i}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in n.items()), file=log)
    for s in solves:
        print("[bench] solve: " + ", ".join(
            f"{k} {v:.6g}" for k, v in s.items()), file=log)
    out["checks"] = checks
    return out, per_lane
