"""A cell's window with the port's spans and stamps recorded, read by the
per-layer metrics of `benchmark/metrics/` that read `ctx["spans"]`, and
the same window with recording off, for its cost.

    python3 -m benchmark.spanrun --workload tumrs_single.features \\
        --seeds 11,12,13 [--seconds S] [--record 0,1] [--trace 1]

For each seed, in one process, one run each of `--record` in the order
given (so `0,1` alternates off and on, seed by seed): set-up and warm-up
as the benchmark's own run makes them, recording switched on before the
warm-up (`CtrlVIO.trace(True)`), then a closed-loop window of `--seconds`
(the cell's `run_seconds` by default) and, with `--trace 1`, a profiled
sub-window of the cell's `trace_calls` calls. The judge does not run.
One JSON line a run on standard output: the window's mean and p95 call
ms and its calls a second (the closing flush left out), and where
recording was on the five readings, the trip check (trip stamps in the
window against the settled K4 launches, or plain accept steps on the CPU,
less the megasteps), the clock's error, the card's idle share between the
window's megasteps from the stamps alone, the profiler's clock fitted onto
the stamps' (`spans.align`) and the share of traced megasteps whose K2
launch lies between their start stamp and their first trip, as traced and
moved onto the stamps' clock; the labelled idle gaps and the readings by
tenth of the window on standard error.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time

import torch

from benchmark import harness, replay, spans

READERS = ("device_ms_per_frame.single", "device_idle_share.single",
           "lm_trip_ms.single", "qr_prior_ms.single", "host_frame_ms.single")


def profiled(drv, calls: int):
    """`calls` more calls under the profiler (device activity only), the
    last ending in a synchronize: the sub-window's bounds and its device
    operations (start, end, name)."""
    act = torch.profiler.ProfilerActivity
    on_card = drv.device.type == "cuda"
    with torch.profiler.profile(
            activities=[act.CUDA if on_card else act.CPU]) as prof:
        lo = time.time_ns()
        for _ in range(calls):
            drv.call()
        replay.sync(drv.device)
        hi = time.time_ns()
    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda]
    return (lo, hi), ops


def one(cell, seed: int, seconds: float, record: bool, trace: bool, device,
        readers, pin: bool = True, dump=None, log=sys.stderr) -> dict:
    """One run (see the module notes); `pin` gives the calling thread a CPU
    of its own for the window, as the benchmark's run does; `dump`, a
    directory, gets the recorded window's spans, stamps and traced device
    operations (`spans_<seed>.npz`)."""
    trace_calls = cell.spec["trace_calls"] if trace else 0
    drv = cell.driver(cell.config, cell.traffic, cell.spec, seed, seconds,
                      trace_calls, device)
    if record:
        drv.vio.trace(True)
    t0 = time.perf_counter()
    drv.warm_up()
    replay.sync(device)
    setup_s = time.perf_counter() - t0
    if pin:
        harness.pin_main_thread()
    c0 = drv.counters()
    lat, lo = [], time.time_ns()
    t_open = time.perf_counter()
    while time.perf_counter() - t_open < seconds:
        if drv.remaining() <= trace_calls:
            raise harness.SequenceExhausted("the sequence ran out")
        now = time.perf_counter()
        drv.call()
        lat.append(time.perf_counter() - now)
    hi, t_end = time.time_ns(), time.perf_counter()
    replay.sync(device)
    c1 = drv.counters()
    traced, ops = profiled(drv, trace_calls) if trace else (None, None)
    drv.close()
    replay.sync(device)
    if record:
        drv.vio.trace(False)
    out = {"seed": seed, "record": int(record), "calls": len(lat),
           "setup_s": setup_s, "mean_call_ms": statistics.fmean(lat) * 1e3,
           "calls_per_s": len(lat) / (t_end - t_open),
           "p95_call_ms": sorted(lat)[int(0.95 * (len(lat) - 1))] * 1e3,
           "device": harness.device_kind(device)}
    sp = spans.window(drv.vio, lo, hi, traced, ops) if record else None
    ctx = dict(driver=cell.config["driver"], spans=sp)
    out["metrics"] = {k: mod.read(ctx) for k, mod in readers.items()}
    if sp is not None:
        solves = c1["megasteps"] - c0["megasteps"]
        k4 = sum(c1["lm"][k] - c0["lm"][k]
                 for k in ("lm_accept", "lm_accept_plain"))
        out["span_ms"] = span_ms(sp)
        out["trips_stamped"] = sum(len(m["trips"]) for m in sp["megasteps"])
        out["megasteps_stamped"] = len(sp["megasteps"])
        out["k4_settled_less_megasteps"] = k4 - solves
        out["clock_error_us"] = sp["clock_error_ns"] * 1e-3
        out["window_idle_pct"] = spans.window_idle(sp)
        out["k2_inside_raw"] = spans.k2_inside(sp, raw=True)
        out["k2_inside"] = spans.k2_inside(sp)
        out["align"] = sp["align"]
        if dump is not None:
            save(sp, f"{dump}/spans_{seed}.npz")
        for name, ms in spans.gaps(sp):
            print(f"[spanrun] seed {seed} gap {ms:.3f} ms {name}", file=log)
        print(f"[spanrun] seed {seed} host frame ms / device ms / trips by "
              "tenth: " + " ".join(f"{h:.2f}/{d:.2f}/{t:.2f}"
                                   for h, d, t in spans.tenths(sp)),
              file=log)
    tenth = max(1, len(lat) // 10)
    print(f"[spanrun] seed {seed} record {int(record)} mean call ms by "
          "tenth: " + " ".join(
              f"{statistics.fmean(lat[i:i + tenth]) * 1e3:.2f}"
              for i in range(0, len(lat), tenth)), file=log)
    return out


def span_ms(sp: dict) -> dict:
    """Each span name's mean ms a call of the window, and its self time
    (less its children's)."""
    frames = {f["frame"] for f in sp["frames"]}
    lo = min(f["start"] for f in sp["frames"])
    hi = max(f["end"] for f in sp["frames"])
    total, child = {}, {}
    stack = []  # the open spans' (end, name, depth), innermost last
    for a, b, name, depth in sorted(sp["spans"], key=lambda x: (x[0], x[3])):
        if a < lo or b > hi:
            continue
        while stack and stack[-1][2] >= depth:
            stack.pop()
        total[name] = total.get(name, 0) + (b - a)
        if stack:
            child[stack[-1][1]] = child.get(stack[-1][1], 0) + (b - a)
        stack.append((b, name, depth))
    n = max(len(frames), 1) * 1e6
    return {k: [v / n, (v - child.get(k, 0)) / n]
            for k, v in sorted(total.items(), key=lambda kv: -kv[1])}


def save(sp: dict, path: str):
    """A recorded window as arrays, for reading elsewhere."""
    import numpy as np

    names = sorted({n for _, _, n in sp["ops"] or []})
    code = {n: i for i, n in enumerate(names)}
    span_names = sorted({n for _, _, n, _ in sp["spans"]})
    scode = {n: i for i, n in enumerate(span_names)}
    tags = [k for k in sp["megasteps"][0] if k not in ("trips",)] \
        if sp["megasteps"] else []

    def rows(ms):
        return np.array([[m[k] for k in tags] for m in ms], np.int64)

    np.savez_compressed(
        path, op_names=np.array(names), ops=np.array(
            [(a, b, code[n]) for a, b, n in sp["ops"] or []], np.int64),
        span_names=np.array(span_names), spans=np.array(
            [(a, b, scode[n], d) for a, b, n, d in sp["spans"]], np.int64),
        tags=np.array(tags), megasteps=rows(sp["megasteps"]),
        traced_megasteps=rows(sp["traced_megasteps"]),
        trips=np.array([t for m in sp["traced_megasteps"]
                        for t in [len(m["trips"])] + m["trips"]], np.int64),
        traced=np.array(sp["traced"] or (0, 0), np.int64))


def toggled(cell, seed: int, seconds: float, pairs: int, device,
            flip: bool, log=sys.stderr) -> dict:
    """Recording's cost on one estimator: after the warm-up (recording on,
    so the stamped programs are captured, then off for as many calls again,
    for the unstamped ones), `2 pairs` windows of `seconds / (2 pairs)`,
    recording off and on in turn (on first with `flip`). Each window's mean
    call ms, the captures in it, and each pair's on less off over off."""
    from ctrlvio_tpu_torch.utils import graphs

    drv = cell.driver(cell.config, cell.traffic, cell.spec, seed, seconds,
                      0, device)
    vio = drv.vio
    vio.trace(True)
    drv.warm_up()
    vio.trace(False)
    for _ in range(cell.config["warmup"]["after_handoff"]):
        drv.call()
    replay.sync(device)
    harness.pin_main_thread()
    wins = []
    for i in range(2 * pairs):
        on = bool(i % 2) != flip
        vio.trace(on)
        n0 = len(graphs.stats()["graphs_captured"])
        lat, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < seconds / (2 * pairs):
            now = time.perf_counter()
            drv.call()
            lat.append(time.perf_counter() - now)
        replay.sync(device)
        wins.append({"record": int(on), "calls": len(lat),
                     "mean_call_ms": statistics.fmean(lat) * 1e3,
                     "captures": len(graphs.stats()["graphs_captured"])
                     - n0})
    vio.trace(False)
    drv.close()
    cost = []
    for a, b in zip(wins[::2], wins[1::2]):
        off, on = (a, b) if b["record"] else (b, a)
        if not (a["captures"] or b["captures"]):
            cost.append((on["mean_call_ms"] - off["mean_call_ms"])
                        / off["mean_call_ms"] * 100)
    print(f"[spanrun] seed {seed} on-cost % a pair: "
          + " ".join(f"{c:.2f}" for c in cost), file=log)
    return {"seed": seed, "device": harness.device_kind(device),
            "windows": wins, "on_cost_pct": cost,
            "on_cost_pct_median": statistics.median(cost) if cost else None,
            "on_cost_pct_mean": statistics.fmean(cost) if cost else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.spanrun")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--record", default="1")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--flip", type=int, choices=(0, 1), default=0,
                    help="reverse the order of --record every other seed; "
                    "with --pairs, start the first seed recording (later "
                    "seeds alternate)")
    ap.add_argument("--pairs", type=int, default=0,
                    help="toggle recording off and on in this many pairs "
                    "of windows on one estimator instead (`toggled`)")
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[spanrun] FAIL needs a CUDA device", file=sys.stderr)
        return 2
    from benchmark import run

    run.steady_host()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    seconds = args.seconds or bench["run_seconds"]
    device = torch.device("cuda", 0)
    here = harness.ROOT / "benchmark" / "metrics"
    readers = {k: harness.load_module(here / f"{k}.py") for k in READERS}
    order = [bool(int(r)) for r in args.record.split(",")]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        if args.pairs:
            out = toggled(harness.Cell(bench, args.workload), seed, seconds,
                          args.pairs, device, bool(args.flip) != bool(i % 2))
            print(json.dumps(out), flush=True)
            continue
        for record in (order[::-1] if args.flip and i % 2 else order):
            cell = harness.Cell(bench, args.workload)
            out = one(cell, seed, seconds, record,
                      bool(args.trace) and record, device, readers,
                      dump=args.dump)
            print(json.dumps(out), flush=True)
            del cell
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
