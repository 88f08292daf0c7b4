"""K2's and K3's launch geometry on the card: builds of `csrc/factors.cu`
with other geometry constants, each held bit for bit to the first and
timed by graph replay at the windows of `chip_smoke.py`'s
`factor_kernels` phase.

    python -m ctrlvio_tpu_torch.tools.factor_geometry
        [--variants 16x8/4x16,16x8/4x16:rolled,...] [--reference PATH]

A variant `IxS/GxT` builds the source with K3's IMU_GROUP = I threads a
slot and IMU_SLOTS = S slots a block, and K2's IMAGE_GROUP = G and
IMAGE_SLOTS = T; `:rolled` also drops the source's `#pragma unroll` lines.
`--reference` adds a build of another `factors.cu` with the same C entry
points (an older revision: `git show REV:ctrlvio_tpu_torch/csrc/factors.cu
> build/factors_ref.cu`), first, so that the bits are compared with it.
Cases: e2e's and batch's windows (`sim/windows.py::factor_window`), f32
and f64, one lane and 8 (each lane its own perturbation of the window,
the constants shared at lane stride 0). One stderr line a
case; the last line of stdout is one JSON object: the card, each build's
ptxas lines, and for each case the µs a launch of every build and whether
its outputs equal the first build's bit for bit. Builds into
`build/kernels/geometry/`; needs the card and nvcc.
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
from ctrlvio_tpu_torch.sim.windows import FACTOR_WINDOWS, factor_window
from ctrlvio_tpu_torch.solver.layout import SolveOptions
from ctrlvio_tpu_torch.utils import cuda_build

LANES = 8    # the lanes of the vmapped cases (serve's)
REPS = 20    # launches a timed graph
DEFAULT_VARIANTS = ("16x8/4x16,16x8/4x16:rolled,16x8/2x16:rolled,"
                    "16x8/8x16,32x4/4x16")
GEOMETRY = ("IMU_GROUP", "IMU_SLOTS", "IMAGE_GROUP", "IMAGE_SLOTS")


def variant_source(src, name):
    """`src` with the geometry `IxS/GxT[:rolled]` of `name`."""
    geo, _, opt = name.partition(":")
    k3, k2 = geo.split("/")
    for const, val in zip(GEOMETRY, [*k3.split("x"), *k2.split("x")]):
        src, n = re.subn(rf"constexpr int {const} = \d+;",
                         f"constexpr int {const} = {int(val)};", src)
        if n != 1:
            raise ValueError(f"{const} is not defined once in the source")
    if opt == "rolled":
        src = re.sub(r"(?m)^#pragma unroll\n", "", src)
    elif opt:
        raise ValueError(f"unknown variant option {opt!r}")
    return src


def build(sources):
    """Each {name: source text} built with the port's nvcc flags, all at
    once. Returns ({name: library}, {name: ptxas lines})."""
    out = cuda_build.BUILD_DIR / "geometry"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, (name, src) in enumerate(sources.items()):
        cu, so = out / f"factors_{k}.cu", out / f"libfactors_{k}.so"
        cu.write_text(src)
        procs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = fk.declare(ctypes.CDLL(str(so)))
        logs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]
    return libs, logs


def graph_us(fn, reps):
    """µs a call of fn, replayed from one CUDA graph of `reps` calls."""
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
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) * 1e3 / reps


def lane_inputs(windows):
    """The image and IMU ops' inputs for the lanes `windows` (each
    lane's tensors stacked; the first window's constants at lane stride
    0)."""
    ext, grav, info, w = windows[0][3:]
    per = [(fk.image_inputs(p, img, img.valid, ext, w),
            fk.imu_inputs(p, imu, imu.valid, grav, info))
           for p, img, imu, *_ in windows]
    L = len(windows)
    out = []
    for k, shared in ((0, (14, 15, 16)), (1, (10, 11))):
        ts = [torch.cat([x[k][i] for x in per])
              for i in range(len(per[0][k]))]
        for i in shared:
            ts[i] = per[0][k][i].expand(L, *per[0][k][i].shape[1:])
        out.append(ts)
    return out


def cases():
    """(window name, cfg, dtype, lanes, kind, inputs) of every case."""
    dev = torch.device("cuda")
    for name, cfg in FACTOR_WINDOWS.items():
        for dtype in (torch.float32, torch.float64):
            wins = [factor_window(cfg, dtype, dev, seed=7 + k)
                    for k in range(LANES)]
            for n in (1, LANES):
                for kind, ts in zip(("image", "imu"), lane_inputs(wins[:n])):
                    yield name, cfg, dtype, n, kind, ts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=DEFAULT_VARIANTS,
                    help="comma-separated IxS/GxT[:rolled] geometries")
    ap.add_argument("--reference", default=None,
                    help="another factors.cu built beside the variants, "
                         "first, the bits compared with it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("factor_geometry: needs a CUDA device")
    src = (cuda_build.CSRC / "factors.cu").read_text()
    sources = {}
    if args.reference:
        with open(args.reference) as f:
            sources["reference"] = f.read()
    for v in args.variants.split(","):
        sources[v] = variant_source(src, v)
    libs, logs = build(sources)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    result = {"card": smi.stdout.strip(), "ptxas": logs, "cases": []}
    c = SolveOptions().cauchy_c
    for name, cfg, dtype, n, kind, ts in cases():
        image = kind == "image"

        def call(lib):
            return fk.call_rows(lib, image, ts, cfg.KW, cfg.NB, cfg.dt, c,
                                torch.cuda.current_stream().cuda_stream)

        as_int = torch.int32 if dtype == torch.float32 else torch.int64
        # every build's outputs held at once: none reuses another's memory
        got = {v: [o.view(as_int) for o in call(lib)]
               for v, lib in libs.items()}
        first = next(iter(got.values()))
        rec = {"window": name, "dtype": str(dtype).split(".")[1],
               "lanes": n, "kernel": "K2" if image else "K3",
               "bit_equal": {v: all(torch.equal(a, b)
                                    for a, b in zip(outs, first))
                             for v, outs in got.items()},
               "us": {}}
        del got, first
        for order in (list(libs), list(reversed(libs))):
            for v in order:
                us = graph_us(lambda lib=libs[v]: call(lib), REPS)
                rec["us"][v] = min(us, rec["us"].get(v, us))
        print(json.dumps(rec), file=sys.stderr, flush=True)
        result["cases"].append(rec)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
