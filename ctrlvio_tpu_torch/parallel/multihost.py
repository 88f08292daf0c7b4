"""Multi-process launcher, weak-scaling harness and multi-device dry run
(PyTorch port of `ctrlvio_tpu/parallel/multihost.py` and of
`__graft_entry__.dryrun_multichip`).

Each rank is one python process in the default `torch.distributed` group
(`parallel/mesh.py::init_distributed`: a `file://` store in a temporary
directory, NCCL for CUDA ranks, gloo for CPU ranks or when asked). Torch
runs one rank a process, so the JAX harness's virtual devices per process
(`--local-devices`) become windows per rank here: a rank solves
`local_devices` windows of the globally `seq`-sharded batch, and the
scaling matrix's `x2dev` curve is two windows a rank. On the CPU every
rank runs one intra-op thread.

    python -m ctrlvio_tpu_torch.parallel.multihost --processes 2 --device cpu
    python -m ctrlvio_tpu_torch.parallel.multihost --dryrun --processes 2
    python -m ctrlvio_tpu_torch.parallel.multihost --scaling --device cpu

The default device is `cuda`: without a card every entry point raises,
and NCCL asked for more ranks than cards raises; two ranks can share one
card only with `--backend gloo`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ctrlvio_tpu_torch.estimator import stream
from ctrlvio_tpu_torch.sim import tiny
from ctrlvio_tpu_torch.solver import lm
from ctrlvio_tpu_torch.solver.layout import (SolveOptions, WindowConfig,
                                             empty_prior)
from ctrlvio_tpu_torch.utils.device import resolve_device
from ctrlvio_tpu_torch.utils.precision import pin_f32_matmuls

from . import batch, sharded_lm
from .mesh import init_distributed, make_mesh, resolve_backend, tree_map

ROOT = Path(__file__).resolve().parents[2]
MODULE = "ctrlvio_tpu_torch.parallel.multihost"  # what each rank runs


# ---------------------------------------------------------------------------
# process handling
# ---------------------------------------------------------------------------


def rank_env(device: torch.device) -> dict:
    """The ranks' environment: this one, the repo on PYTHONPATH, and one
    OpenMP thread for CPU ranks."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    if device.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    return env


class Ranks:
    """n processes, one a rank, started at once, each writing its output to
    a log file in `log_dir`. `wait` returns the outputs, or stops every
    rank and raises once one fails or the time is up."""

    def __init__(self, argv_of_rank, n: int, log_dir, env: dict):
        self.logs = [Path(log_dir) / f"rank{r}.log" for r in range(n)]
        self.procs = []
        try:
            for r in range(n):
                with open(self.logs[r], "wb") as f:
                    self.procs.append(subprocess.Popen(
                        argv_of_rank(r), stdout=f, stderr=subprocess.STDOUT,
                        env=env, cwd=ROOT))
        except BaseException:
            self.stop()
            raise

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def outputs(self):
        return [log.read_text(errors="replace") for log in self.logs]

    def wait(self, timeout: float):
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                if any(c for c in codes) or all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"ranks still running after {timeout:.0f} s\n"
                        + "\n".join(o[-2000:] for o in self.outputs()))
                time.sleep(0.05)
        finally:
            self.stop()
        outs = self.outputs()
        if any(codes):
            raise RuntimeError(f"ranks failed with exit codes {codes}:\n"
                               + "\n".join(f"--- rank {r}\n{o[-3000:]}"
                                           for r, o in enumerate(outs)))
        return outs


def _run_ranks(n: int, args, device, backend, timeout: float,
               core_map=None):
    """`python -m ctrlvio_tpu_torch.parallel.multihost --worker r ...` for
    r < n (pinned to `core_map[r]` by taskset if given); returns rank 0's
    output."""
    dev = resolve_device(device)
    backend = resolve_backend(dev, backend, n)
    with tempfile.TemporaryDirectory(prefix="ctrlvio_ranks_") as d:
        def argv(r):
            cmd = [sys.executable, "-m", MODULE, "--worker", str(r),
                   "--processes", str(n),
                   "--store", os.path.join(d, "store"),
                   "--device", str(device), "--backend", backend, *args]
            if core_map is not None:
                cmd = ["taskset", "-c", str(core_map[r])] + cmd
            return cmd

        return Ranks(argv, n, d, rank_env(dev)).wait(timeout)[0]


# ---------------------------------------------------------------------------
# the work of a rank
# ---------------------------------------------------------------------------


def stacked(prob: tiny.TinyProblem, B: int):
    """The first six solve arguments of `prob`, B copies each."""
    return [batch.stack([x] * B) for x in (
        prob.params, prob.img, prob.imu, prob.bias, prob.prior, prob.fixed)]


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def megastep_chain(prob: tiny.TinyProblem, opts: SolveOptions):
    """Two chained streaming megasteps (`estimator/stream.py::megastep`) on
    the window of `prob`, its knots seeded from the upload, no slide
    (the JAX dry run's stage 3). Returns both summaries (dicts)."""
    cfg, dev = prob.cfg, prob.params.knots_p.device
    dtype = prob.params.knots_p.dtype
    npdt = np.float64 if dtype == torch.float64 else np.float32
    img, imu, bias, params, fixed = tree_map(
        lambda x: x.cpu().numpy(),
        (prob.img, prob.imu, prob.bias, prob.params, prob.fixed))
    n_active = int(np.sum(~fixed))
    seed_mask = np.zeros(cfg.KW, bool)
    seed_mask[: n_active + 4] = True
    blob = stream.pack_stream_blob(
        img, imu, bias, fixed, params.knots_q, params.knots_p, seed_mask,
        np.full(cfg.LM, -1, np.int32), params.dinv, np.zeros(cfg.KW, bool),
        False, 0, (0, 0.0), (1, 0.0), old_hi=4, new_hi=n_active + 4,
        host_seeds=True, dtype=npdt)
    blob = torch.as_tensor(blob, device=dev)
    st = stream.DevState(params=prob.params,
                         prior=empty_prior(cfg, dtype, dev))
    out = []
    for _ in range(2):
        st, summ = stream.megastep(st, blob, *prob.aux, cfg, opts,
                                   marg_old=False, knot_shift=0,
                                   host_seeds=True)
        out.append(stream.unpack_summary(
            summ.double().cpu().numpy(), cfg))
    return out


def worker(rank: int, world: int, local_devices: int, store: str,
           device="cuda", backend: Optional[str] = None,
           bench_iters: int = 0) -> None:
    """One rank of the multi-process batch solve: `local_devices` windows
    of `sim/tiny.py`'s problem a rank (f32), `seq`-sharded over every rank,
    2 LM iterations; rank 0 reads the gathered stats and checks that the
    cost fell. With bench_iters, then times that many 12-iteration batch
    solves between two barriers (rank 0 prints windows/s)."""
    dev = init_distributed(rank, world, store, device, backend)
    pin_f32_matmuls()
    try:
        prob = tiny.tiny_problem(torch.float32, device=dev)
        mesh = make_mesh(n_seq=world, n_fac=1)
        B = world * local_devices
        args = stacked(prob, B)
        solve_b = batch.make_batched_solver(
            prob.cfg, SolveOptions(max_iters=2), mesh=mesh)
        _, stats = solve_b(*args, *prob.aux)
        if rank == 0:
            c0, c1 = float(stats.cost0[0]), float(stats.cost[0])
            if not c1 < c0:
                raise RuntimeError(f"batched solve did not lower the cost: "
                                   f"{c0} -> {c1}")
            print(f"[multihost] {world} processes x {local_devices} "
                  f"windows: mesh {mesh.shape}, B={B} on {dev}, cost "
                  f"{c0:.3e} -> {c1:.3e} OK", flush=True)
        if bench_iters:
            # weak scaling: the work of a rank is constant (local_devices
            # windows), at the production solve depth (cfg.ba_iters = 12)
            solve_t = batch.make_batched_solver(
                prob.cfg, SolveOptions(max_iters=12), mesh=mesh)
            solve_t(*args, *prob.aux)
            _sync(dev)
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(bench_iters):
                solve_t(*args, *prob.aux)
            _sync(dev)
            dist.barrier()
            dt = time.perf_counter() - t0
            if rank == 0:
                wps = B * bench_iters / dt
                print(f"[multihost-bench] procs={world} B={B} "
                      f"iters={bench_iters} wall={dt:.2f}s wps={wps:.2f} "
                      f"wps_per_proc={wps / world:.2f}", flush=True)
    finally:
        dist.destroy_process_group()


def launch(num_processes: int = 2, local_devices: int = 1,
           timeout: float = 600.0, bench_iters: int = 0,
           pin_cores: bool = False, core_map=None, device="cuda",
           backend: Optional[str] = None) -> str:
    """Spawn `num_processes` workers (`worker`) as subprocesses and wait for
    them. Returns rank 0's output (with the [multihost-bench] line when
    bench_iters > 0). pin_cores: one core a rank (taskset, rank r on core
    r mod cores), so that the scaling curve measures coordination and not
    core contention; core_map: an explicit core a rank."""
    if core_map is None and pin_cores:
        n_cores = os.cpu_count() or 1
        core_map = [r % n_cores for r in range(num_processes)]
    out = _run_ranks(num_processes,
                     ["--local-devices", str(local_devices),
                      "--bench-iters", str(bench_iters)],
                     device, backend, timeout, core_map)
    print(out, flush=True)
    if "[multihost]" not in out:
        raise RuntimeError(f"no success line from rank 0:\n{out}")
    return out


def scaling(process_counts=(1, 2, 4), local_devices: int = 1,
            bench_iters: int = 40, repeats: int = 2, core_maps=None,
            device="cuda", backend: Optional[str] = None) -> dict:
    """Weak-scaling efficiency over process counts: `local_devices`
    windows a rank, so ideal scaling keeps windows/s a process constant.
    Each point is the best of `repeats` launches, one pinned core a rank
    (`core_maps`: {processes: core list} overrides). Returns {processes:
    (windows/s, efficiency against one process)}."""
    results, base = {}, None
    for n in process_counts:
        wps = 0.0
        for _ in range(repeats):
            out = launch(n, local_devices, bench_iters=bench_iters,
                         pin_cores=True, core_map=(core_maps or {}).get(n),
                         device=device, backend=backend)
            wps = max(wps, float(re.search(r"wps=([0-9.]+)", out).group(1)))
        per = wps / n
        base = base or per
        results[n] = (wps, per / base)
        print(f"[scaling] procs={n} x {local_devices} windows: {wps:.2f} "
              f"windows/s, efficiency {per / base:.2f}", flush=True)
    return results


def scaling_artifact(path=None, bench_iters: int = 20, device="cuda",
                     backend: Optional[str] = None) -> dict:
    """Run the weak-scaling matrix and write it as JSON
    (`build/scaling_torch.json` by default):

    - 1..4 processes x 1 window a rank, each pinned to its own core, core
      0 left free below full occupancy;
    - 1, 2, 4 processes x 2 windows a rank (the work of a rank doubled on
      the same core: a fixed coordination cost a step shows as recovering
      efficiency);
    - a contention control: 2 processes pinned to the same core."""
    n_cores = os.cpu_count() or 1
    counts = tuple(n for n in (1, 2, 3, 4) if n <= n_cores)
    maps = {n: [n_cores - 1 - i for i in range(n)] for n in counts
            if n < n_cores}
    kw = dict(bench_iters=bench_iters, device=device, backend=backend)
    curve_1 = scaling(counts, 1, core_maps=maps, **kw)
    curve_2 = scaling(tuple(n for n in (1, 2, 4) if n <= n_cores), 2,
                      core_maps=maps, **kw)
    wps_ctl = 0.0
    for _ in range(2):
        out = launch(2, 1, core_map=[n_cores - 1] * 2, **kw)
        wps_ctl = max(wps_ctl,
                      float(re.search(r"wps=([0-9.]+)", out).group(1)))
    eff_ctl = (wps_ctl / 2) / curve_1[1][0]
    print(f"[scaling] contention control (2 procs, one core): "
          f"{wps_ctl:.2f} windows/s, efficiency {eff_ctl:.2f}", flush=True)

    def curve(c):
        return {str(n): {"windows_per_s": w, "efficiency": e}
                for n, (w, e) in c.items()}

    art = {
        "what": "weak-scaling efficiency of the seq-sharded batch solve, "
                "torch.distributed ranks as processes, one pinned core a "
                "rank, sim/tiny.py windows (f32, 12 LM iterations)",
        "device": str(device),
        "backend": resolve_backend(resolve_device(device), backend, 1),
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "host_cores": n_cores,
        "x1dev": curve(curve_1),
        "x2dev": curve(curve_2),
        "contention_control_2procs_1core": {
            "windows_per_s": wps_ctl, "efficiency": eff_ctl},
    }
    path = Path(path) if path else ROOT / "build" / "scaling_torch.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(art, indent=1))
    print(f"[scaling] artifact -> {path}", flush=True)
    return art


# ---------------------------------------------------------------------------
# the multi-device dry run
# ---------------------------------------------------------------------------

# the dry run's gates on the factor-sharded solve against the unsharded one
# in f32 (`__graft_entry__.py:186-188`)
DRYRUN_TOL = 1e-4


def _time_min(fn, dev, reps: int = 3):
    """(ms a call, min of `reps` after a warm call; the warm call's
    result). Every rank calls it: a barrier starts each call together."""
    out = fn()
    _sync(dev)
    ts = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return min(ts) * 1e3, out


def dryrun_worker(rank: int, world: int, store: str, device="cuda",
                  backend: Optional[str] = None,
                  cfg: Optional[WindowConfig] = None,
                  solve_iters: int = 6) -> None:
    """One rank of `dryrun_multichip`. Rank 0 prints the stages and, last,
    `[dryrun] {json}`."""
    dev = init_distributed(rank, world, store, device, backend)
    pin_f32_matmuls()
    try:
        prob = tiny.tiny_problem(torch.float32, cfg, device=dev)
        cfg = prob.cfg
        n_fac = 2 if world % 2 == 0 else 1
        n_seq = world // n_fac
        mesh = make_mesh(n_seq=n_seq, n_fac=n_fac)
        say = print if rank == 0 else (lambda *a, **k: None)
        say(f"[dryrun] mesh {mesh.shape} on {world} ranks "
            f"({dist.get_backend()}, {dev})", flush=True)
        rec = {"ranks": world, "mesh": mesh.shape,
               "backend": str(dist.get_backend()), "device": str(dev)}

        # [1] seq-parallel batched window solve, two windows a seq rank
        B = n_seq * 2
        solve_b = batch.make_batched_solver(cfg, SolveOptions(max_iters=2),
                                            mesh=mesh)
        _, st_b = solve_b(*stacked(prob, B), *prob.aux)
        c0, c1 = st_b.cost0.double().cpu(), st_b.cost.double().cpu()
        if not bool((c1 < c0).all()):
            raise RuntimeError(f"seq-parallel batch: a cost did not fall "
                               f"{c0.tolist()} -> {c1.tolist()}")
        say(f"[dryrun] seq-parallel batch B={B}: cost {float(c0[0]):.3e} "
            f"-> {float(c1[0]):.3e}", flush=True)
        rec["batch"] = {"B": B, "cost0": c0.tolist(), "cost": c1.tolist()}

        # [2] fac-parallel full LM solve over every rank against the
        # unsharded solve
        if n_fac > 1:
            fac_mesh = make_mesh(n_seq=1, n_fac=world)
            opts = SolveOptions(max_iters=solve_iters)
            solve_sh = sharded_lm.make_sharded_solve(fac_mesh, cfg, opts)
            args = (prob.params, prob.img, prob.imu, prob.bias, prob.prior,
                    prob.fixed, *prob.aux)
            ms, (p_sh, st_sh) = _time_min(lambda: solve_sh(*args), dev)
            p_ref, st_ref = lm.solve_window(*args, cfg, opts)
            dp = float((p_sh.knots_p - p_ref.knots_p).abs().max())
            dq = float((p_sh.knots_q - p_ref.knots_q).abs().max())
            # relative to the initial cost: near the minimum an f32
            # accept/reject can flip under reduction-order rounding, so
            # the tiny final costs differ relatively while the solves
            # agree absolutely
            dc = abs(float(st_sh.cost) - float(st_ref.cost)) / max(
                float(st_ref.cost0), 1e-30)
            rec["solve"] = {
                "fac": world, "max_iters": solve_iters, "ms": ms,
                "cost0": float(st_sh.cost0), "cost": float(st_sh.cost),
                "accepted": int(st_sh.accepted),
                "accepted_unsharded": int(st_ref.accepted),
                "max_dp": dp, "max_dq": dq, "dcost_over_cost0": dc,
                "allreduce_bytes_per_iter":
                    sharded_lm.reduced_bytes_per_iteration(
                        cfg, prob.params.knots_p.dtype)}
            say(f"[dryrun] fac-parallel full solve over {world} shards: "
                f"cost {float(st_sh.cost0):.3e} -> {float(st_sh.cost):.3e} "
                f"({int(st_sh.accepted)} accepted), {ms:.1f} ms a call; vs "
                f"unsharded: max|dp|={dp:.2e} max|dq|={dq:.2e} "
                f"dcost={dc:.2e}", flush=True)
            if not float(st_sh.cost) < float(st_sh.cost0):
                raise RuntimeError("sharded LM did not lower the cost")
            if not (dp < DRYRUN_TOL and dq < DRYRUN_TOL
                    and dc < DRYRUN_TOL):
                raise RuntimeError(f"sharded solve disagrees with the "
                                   f"unsharded one: {rec['solve']}")

        # [3] two chained streaming megasteps (the single-device path)
        s1, s2 = megastep_chain(prob, SolveOptions(max_iters=3))
        if not (np.isfinite(s2["cost"]) and s1["cost"] < s1["cost0"]):
            raise RuntimeError(f"megastep chain: cost {s1['cost0']} -> "
                               f"{s1['cost']} -> {s2['cost']}")
        say(f"[dryrun] megastep chain: cost {s1['cost0']:.3e} -> "
            f"{s1['cost']:.3e} -> {s2['cost']:.3e}", flush=True)
        rec["megastep"] = [s1["cost0"], s1["cost"], s2["cost"]]
        say("[dryrun] " + json.dumps(rec), flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device="cuda", backend: Optional[str] = None,
                     cfg: Optional[WindowConfig] = None,
                     solve_iters: int = 6) -> dict:
    """The multi-device dry run on n ranks (port of
    `__graft_entry__.dryrun_multichip`): mesh (seq = n / 2, fac = 2) when n
    is even, else (n, 1); [1] the seq-parallel batch (two windows a seq
    rank), [2] the fac-parallel full solve over all n ranks against the
    unsharded `lm.solve_window` (max|dp|, max|dq| and |dcost|/cost0 under
    1e-4, f32; ms a call, min of 3 after a warm one), [3] two chained
    megasteps. `cfg`: the window (default `sim/tiny.py`'s). Returns rank
    0's record; raises if a rank fails."""
    args = ["--dryrun", "--solve-iters", str(solve_iters)]
    if cfg is not None:
        args += ["--window", ",".join(str(v) for v in cfg)]
    out = _run_ranks(n, args, device, backend, timeout=900.0)
    print(out, flush=True)
    line = [ln for ln in out.splitlines() if ln.startswith("[dryrun] {")]
    if not line:
        raise RuntimeError(f"no record from rank 0:\n{out}")
    return json.loads(line[-1][len("[dryrun] "):])


def _window(text: str) -> WindowConfig:
    f = text.split(",")
    return WindowConfig(*(int(v) for v in f[:5]), *(float(v) for v in f[5:]))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="multi-process batch solve, weak-scaling matrix and "
                    "multi-device dry run of the port")
    ap.add_argument("--worker", type=int, default=None,
                    help="run as this rank (the launcher's children)")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=1,
                    help="windows a rank")
    ap.add_argument("--store", default=None,
                    help="rendezvous directory (workers)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--bench-iters", type=int, default=0)
    ap.add_argument("--dryrun", action="store_true",
                    help="the multi-device dry run on --processes ranks")
    ap.add_argument("--window", type=_window, default=None,
                    help="dry run's window: KW,NB,LM,OBS,MIMU[,dt]")
    ap.add_argument("--solve-iters", type=int, default=6)
    ap.add_argument("--scaling", action="store_true",
                    help="the weak-scaling matrix, written to "
                         "build/scaling_torch.json")
    args = ap.parse_args(argv)
    if args.worker is not None:
        if args.device == "cpu":
            torch.set_num_threads(1)
        if args.dryrun:
            dryrun_worker(args.worker, args.processes, args.store,
                          args.device, args.backend, args.window,
                          args.solve_iters)
        else:
            worker(args.worker, args.processes, args.local_devices,
                   args.store, args.device, args.backend, args.bench_iters)
    elif args.scaling:
        scaling_artifact(device=args.device, backend=args.backend)
    elif args.dryrun:
        dryrun_multichip(args.processes, args.device, args.backend,
                         args.window, args.solve_iters)
    else:
        launch(args.processes, args.local_devices,
               bench_iters=args.bench_iters, device=args.device,
               backend=args.backend)


if __name__ == "__main__":
    main()
