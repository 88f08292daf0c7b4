"""Where K5's time goes on the card: builds of `csrc/factors.cu` with one
of K5's steps cut out, each timed by graph replay beside the whole kernel.

    python -m ctrlvio_tpu_torch.tools.summary_split [--cuts full,...]
        [--reference PATH] [--reps 20]

A cut makes the named step return at once, so the build does everything
else the kernel does (the same blocks, barriers and launch):
  full        nothing cut;
  no_finish   the lane's last block neither stages nor adds the
              partials, nor writes the outputs;
  no_arrival  no block arrives (no fences, no atomic, no finish);
  no_trees    the shares' and the block's trees (the barriers stay);
  no_image, no_imu, no_prior, no_bias   that role's work;
  only_image, only_imu, only_prior, only_bias   every other role's work;
  empty       every step: the launch, the phases' barriers and the store
              of the partials.
A cut build's outputs are not the summary: only its time means anything.
`--reference` adds a build of another `factors.cu` with the same C entry
points (an older revision) as its own `reference` case. Cases: the e2e
window (`sim/windows.py::summary_window`), f32 and f64, one lane and 8
(each lane its own perturbation of the window). One stderr line a case;
the last line of stdout is one JSON object: the card, each build's µs a
launch by case. Builds into
`build/kernels/summary_split/`; needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import torch

from ctrlvio_tpu_torch.ops import factor_kernels as fk
from ctrlvio_tpu_torch.sim.windows import FACTOR_WINDOWS, summary_window
from ctrlvio_tpu_torch.solver.layout import SolveOptions
from ctrlvio_tpu_torch.utils import cuda_build

LANES = 8
STEPS = {
    "no_finish": ("summary_finish_load", "summary_finish_add",
                  "summary_finish_store"),
    "no_arrival": ("summary_arrive",),
    "no_trees": ("summary_fold", "summary_prior_fold"),
    "no_image": ("summary_image_observation", "summary_image_terms"),
    "no_imu": ("summary_imu_residual", "summary_imu_terms"),
    "no_prior": ("summary_prior_dx", "summary_prior_rows",
                 "summary_prior_terms"),
    "no_bias": ("summary_bias_terms",)}
ROLES = ("no_image", "no_imu", "no_prior", "no_bias")
for role in ROLES:
    STEPS["only_" + role[3:]] = tuple(f for r in ROLES if r != role
                                      for f in STEPS[r])
STEPS["empty"] = tuple(f for r in (*ROLES, "no_trees", "no_arrival")
                       for f in STEPS[r])
DEFAULT_CUTS = "full," + ",".join(STEPS)


def cut_source(src, cut):
    """`src` with the functions of `cut` (a key of STEPS, or "full")
    returning at once (a bool one false: no block is the lane's last)."""
    for fn in STEPS.get(cut, ()):
        src, n = re.subn(rf"HD (void|bool) {fn}\([^{{]*\{{",
                         lambda m: m.group(0) + (" return;" if m.group(1)
                                                 == "void"
                                                 else " return false;"),
                         src)
        if n != 1:
            raise ValueError(f"{fn} is not defined once in the source")
    return src


def build(sources):
    """Each {name: source text} built with the port's nvcc flags, all at
    once; {name: library}."""
    out = cuda_build.BUILD_DIR / "summary_split"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, (name, src) in enumerate(sources.items()):
        cu, so = out / f"factors_{k}.cu", out / f"libfactors_{k}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = fk.declare(ctypes.CDLL(str(so)))
    return libs


def launch_us(lib, ts, cfg, reps):
    """µs a launch of `lib`'s K5 on the inputs `ts`, by the replay of one
    CUDA graph of `reps` launches."""
    c = SolveOptions().cauchy_c

    def call():
        fk.call_summary(lib, ts, cfg.KW, cfg.NB, cfg.dt, c,
                        stream=torch.cuda.current_stream().cuda_stream)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            call()
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cuts", default=DEFAULT_CUTS)
    ap.add_argument("--reference", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("summary_split needs a CUDA device")
    src = (cuda_build.CSRC / "factors.cu").read_text()
    sources = {cut: cut_source(src, cut) for cut in args.cuts.split(",")}
    if args.reference:
        with open(args.reference) as f:
            sources["reference"] = f.read()
    libs = build(sources)
    dev = torch.device("cuda")
    cfg = FACTOR_WINDOWS["e2e"]
    out = {}
    for dtype in (torch.float32, torch.float64):
        per_lane = [fk.summary_inputs(*summary_window(cfg, dtype, dev,
                                                      seed=7 + k))
                    for k in range(LANES)]
        one = per_lane[0]
        many = [torch.cat([ins[i] for ins in per_lane])
                for i in range(fk.N_SUMMARY_IN)]
        for L, ts in ((1, one), (LANES, many)):
            case = f"{str(dtype).split('.')[1]} lanes={L}"
            out[case] = {name: launch_us(lib, ts, cfg, args.reps)
                         for name, lib in libs.items()}
            print(f"[summary_split] {case}: " + ", ".join(
                f"{k} {v:.2f}" for k, v in out[case].items()),
                file=sys.stderr, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip(), "window": cfg._asdict(),
                      "reps": args.reps, "us_per_launch": out}))


if __name__ == "__main__":
    main()
