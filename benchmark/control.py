"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs): the judge's numbers for a cell over many seeds in
one process, as configured or with the control switched on.

    python3 -m benchmark.control --workload <cell> --variant <v>
        --seeds 1,2,3 [--seconds S]

Variants: `sound` (the configuration as it states itself); `tf32` (the
control: the streamed solve in TF32 matrix products, the nearest precision
below the full float32 that the configuration states, by the port's pin of
full-float32 products replaced with one that turns TF32 on). One JSON line
a seed on standard output; the sampled calls' gaps on standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

VARIANTS = ("sound", "tf32")


def tf32_on():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")


def apply(variant: str, patch=setattr):
    """Switch `variant` on (`patch(obj, name, value)` replaces the port's
    pin of full-float32 matrix products for `tf32`)."""
    if variant == "tf32":
        from ctrlvio_tpu_torch.estimator import odometry, stream

        for mod in (odometry, stream):
            patch(mod, "pin_f32_matmuls", tf32_on)
    elif variant != "sound":
        raise ValueError(f"unknown variant {variant!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", choices=VARIANTS, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)

    from benchmark import harness

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    seconds = args.seconds or bench["run_seconds"]
    device = torch.device("cuda", 0)
    apply(args.variant)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.Cell(bench, args.workload)
        t0 = time.perf_counter()
        try:
            out, per_lane = harness.run(cell, seed, seconds, False, device,
                                        t0)
            rec = {"correct": out["correct"],
                   "numbers": {k: c["value"] for k, c in
                               out["checks"].items()},
                   "metrics": {k: m["value"] for k, m in
                               out["metrics"].items()},
                   "per_lane": per_lane}
        except Exception as e:  # a control that crashes has failed
            rec = {"error": f"{type(e).__name__}: {e}"}
        print(json.dumps({"workload": args.workload, "variant": args.variant,
                          "seed": seed, **rec}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
