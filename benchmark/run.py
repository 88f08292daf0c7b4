"""The benchmark of `ctrlvio_tpu_torch` on one NVIDIA card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

One process is one run of one cell of `BENCHMARK.json`: set-up (the
sequence made on the card from the seed, the estimator started, every
program captured), a closed-loop window of `--seconds`, then the judge
against the plain reference. The last line on standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device`, with the trace
`breakdown`, and last `checks`, each number the judge compared beside its
limit. The same numbers are the last lines on standard error. Without a
card, or with fewer than the cell asks for, it exits 2 and prints no
result; it exits 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import time

T_IMPORT = time.perf_counter()


def process_start() -> float:
    """The perf_counter reading at which this process started (from the
    kernel's record of its start; the import of this module otherwise)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return T_IMPORT


T_START = process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache of a build or a compile at a fixed path inside the checkout
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "CUDA_CACHE_PATH": "build/cuda_cache"}
FORBIDDEN = ("jax", "jaxlib", "flax", "ctrlvio_tpu")
# one host thread for BLAS and OpenMP, and the process off the first CPU,
# which takes the machine's interrupts (`harness.pin_main_thread` then
# gives the estimator's thread a CPU of its own)
THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def steady_host():
    for k in THREADS:
        os.environ[k] = "1"
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) > 2:
        os.sched_setaffinity(0, cpus[1:])


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(ROOT / v)
    steady_host()

    import torch

    from benchmark import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] FAIL the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out, _ = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_START)
    found = loaded_forbidden()
    if found:
        print(f"[bench] FAIL modules loaded in the run's process: {found}",
              file=sys.stderr)
        return 3
    for c in out["checks"].values():
        if not math.isfinite(c["value"]):
            c["value"] = None  # JSON has no NaN
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
