"""A/B of the normal-equation assemblies and Schur solvers in the serve
path's batched megastep (counterpart of `tools/ne_ab.py`).

    python -m ctrlvio_tpu_torch.tools.ne_ab [--batches 1,16]
        [--modes dense,chunked] [--chunks 128] [--solvers chol,cg16,cg48]
        [--reps 10] [--device cuda|cpu]

Captures one steady state (`profile_serve.capture_state`), then times the
batched megastep at each B for every variant: mode x chunk size (chunked
mode only; 0 = every factor in one chunk) x Schur solver (`chol`, or
`cgN`: N iterations of PCG). A variant is chosen as the estimator chooses
it: `VIOConfig.ne_mode`, `ne_chunk`, `solver` and `cg_iters`, the last
two through the megastep's `SolveOptions`. One stderr line per variant
and B; the last line of stdout is one JSON object of the results.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from ctrlvio_tpu_torch.parallel.stream_batch import batched_megastep
from ctrlvio_tpu_torch.tools.profile_serve import (batched_inputs,
                                                   capture_state,
                                                   device_record, time_steps)
from ctrlvio_tpu_torch.utils.precision import pin_f32_matmuls


def variants(modes, chunks, solvers):
    """[(mode, chunk, solver)]: chunk sizes apply to the chunked mode
    only (0 for dense)."""
    out = []
    for m in modes:
        for c in (chunks if m == "chunked" else [0]):
            for sv in solvers:
                out.append((m, c, sv))
    return out


def variant_megastep(vio, mode: str, chunk: int, solver: str):
    """The batched megastep of `vio`'s configuration with the variant's
    normal equations and Schur solver."""
    cg = solver.startswith("cg")
    cfg = dataclasses.replace(
        vio.cfg, ne_mode=mode, ne_chunk=chunk or None,
        solver="cg" if cg else "chol",
        cg_iters=int(solver[2:] or 48) if cg else vio.cfg.cg_iters)
    opts = vio._ba_opts._replace(solver=cfg.solver, cg_iters=cfg.cg_iters)
    return batched_megastep(vio.wc, opts, cfg.marg_caps, cfg.ne_mode,
                            cfg.ne_chunk)


def tag_of(mode: str, chunk: int, solver: str) -> str:
    return f"{mode}{f'/{chunk}' if chunk else ''}/{solver}"


def run(vio, dev_state, blob, batches, modes, chunks, solvers, reps: int,
        warm: int = 3):
    """Time every variant at every B (`reps` steps after `warm`). Returns
    ([{variant, B, ms_per_step, frames_per_s}], {(tag, B): the first
    step's (states, summaries)})."""
    results, outputs = [], {}
    for mode, chunk, sv in variants(modes, chunks, solvers):
        tag = tag_of(mode, chunk, sv)
        mega = variant_megastep(vio, mode, chunk, sv)
        for B in batches:
            st, blobs, consts = batched_inputs(vio, dev_state, blob, B)
            outputs[(tag, B)] = mega(st, blobs, *consts)
            dt, _, _ = time_steps(mega, st, blobs, consts, reps, vio.device,
                                  warm)
            results.append({"variant": tag, "B": B, "ms_per_step": dt * 1e3,
                            "frames_per_s": B / dt})
            print(f"[ne_ab] {tag:14s} B={B:2d}: {dt * 1e3:7.1f} ms/step "
                  f"({B / dt:7.1f} frames/s aggregate)", file=sys.stderr,
                  flush=True)
    return results, outputs


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ctrlvio_tpu_torch.tools.ne_ab")
    ap.add_argument("--batches", default="1,16")
    ap.add_argument("--modes", default="dense,chunked")
    ap.add_argument("--chunks", default="128",
                    help="chunk sizes to try for the chunked mode")
    ap.add_argument("--solvers", default="chol",
                    help="schur solver variants, e.g. chol,cg16,cg48")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a "
                         "card) or cpu")
    args = ap.parse_args(argv)
    pin_f32_matmuls()

    vio, dev_state, blob = capture_state(device=args.device)
    print(f"[ne_ab] captured on {vio.device}", file=sys.stderr, flush=True)
    results, _ = run(vio, dev_state, blob,
                     [int(b) for b in args.batches.split(",")],
                     args.modes.split(","),
                     [int(c) for c in args.chunks.split(",")],
                     args.solvers.split(","), args.reps)
    print(json.dumps({"tool": "ne_ab", **device_record(vio.device),
                      "results": results}), flush=True)


if __name__ == "__main__":
    main()
