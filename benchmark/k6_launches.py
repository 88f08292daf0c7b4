"""K6's launches over a cell's window beside the window's megasteps that
marginalize the oldest keyframe: where the two are equal, every QR prior
of the timed path ran through the kernel, once a megastep.

    python3 -m benchmark.k6_launches --workload tumrs_single.features \\
        --seeds 11,12 [--seconds S]

For each seed, in one process: set-up and warm-up as the benchmark's run
makes them, with the port's spans and stamps recorded (`CtrlVIO.trace`),
then a closed-loop window of `--seconds` (the cell's `run_seconds` by
default). One JSON line a seed: the calls, the megasteps stamped in the
window and those of them that marginalized, K6's launches counted over the
window (`ops/qr_prior.py::counts`, settled: a launch in a replayed
program counts on each replay) and the window's `qr_prior_ms.single`
reading. A run on a tree without K6 (no `ops/qr_prior.py`) exits 2. The
card only; `benchmark/spanrun.py` reads the other span metrics.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import harness, replay, spans


def one(cell, seed: int, seconds: float, device, reader) -> dict:
    from ctrlvio_tpu_torch.ops import qr_prior

    drv = cell.driver(cell.config, cell.traffic, cell.spec, seed, seconds, 0,
                      device)
    drv.vio.trace(True)
    drv.warm_up()
    replay.sync(device)
    harness.pin_main_thread()
    n0 = qr_prior.counts()["qr_prior_r"]
    calls, lo = 0, time.time_ns()
    t_open = time.perf_counter()
    while time.perf_counter() - t_open < seconds:
        if drv.remaining() <= 0:
            raise harness.SequenceExhausted("the sequence ran out")
        drv.call()
        calls += 1
    hi = time.time_ns()
    replay.sync(device)
    launches = qr_prior.counts()["qr_prior_r"] - n0
    drv.close()
    replay.sync(device)
    drv.vio.trace(False)
    sp = spans.window(drv.vio, lo, hi)
    megasteps = sp["megasteps"] if sp is not None else []
    return {"seed": seed, "calls": calls, "megasteps": len(megasteps),
            "marg_old_megasteps": sum(m["marg_old"] for m in megasteps),
            "k6_launches": launches,
            "qr_prior_ms.single": reader.read(dict(driver=cell.config[
                "driver"], spans=sp)),
            "device": harness.device_kind(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.k6_launches")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[k6_launches] FAIL needs a CUDA device", file=sys.stderr)
        return 2
    try:
        from ctrlvio_tpu_torch.ops import qr_prior  # noqa: F401
    except ImportError:
        print("[k6_launches] FAIL this tree has no K6", file=sys.stderr)
        return 2
    from benchmark import run

    run.steady_host()
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    seconds = args.seconds or bench["run_seconds"]
    device = torch.device("cuda", 0)
    reader = harness.load_module(harness.ROOT / "benchmark" / "metrics"
                                 / "qr_prior_ms.single.py")
    for seed in (int(s) for s in args.seeds.split(",")):
        out = one(harness.Cell(bench, args.workload), seed, seconds, device,
                  reader)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
