"""The port's benchmark (`python -m ctrlvio_tpu_torch.bench`) against the
repository's `bench.py`: the same flags and choices (`gpu` in place of
`tpu`), the same e2e sequence and estimator settings, the same JSON keys,
exit 1 with no result on a missed gate, the batch mode's lanes equal to
the single solve, and (slow) the CPU smoke run's accuracy equal to the
JAX bench's within `test_torch_e2e.py`'s bounds."""

import argparse
import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from ctrlvio_tpu.estimator import odometry as jodometry
from ctrlvio_tpu.sim import synthetic as jsynthetic
from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu_torch import bench
from ctrlvio_tpu_torch.sim import tiny
from ctrlvio_tpu_torch.solver import lm
from ctrlvio_tpu_torch.solver.layout import SolveOptions, WindowConfig
from tests.test_torch_e2e import JAX_GAP_M
from tests.test_torch_gt_families import same_sim
from tests.torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
BENCH_PY = ROOT / "bench.py"


class _Parsed(Exception):
    pass


def jax_parser() -> argparse.ArgumentParser:
    """`bench.py`'s own parser: its main() up to parse_args."""
    spec = importlib.util.spec_from_file_location("jax_bench", BENCH_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = {}

    def grab(self, *a, **k):
        got["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Parsed):
            mod.main()
    return got["parser"]


def options(ap: argparse.ArgumentParser):
    """{option string: (dest, choices, default, type, nargs, const)}, the
    JAX preset's `tpu` read as `gpu`."""
    def gpu(x):
        if isinstance(x, (list, tuple)):
            return tuple(gpu(v) for v in x)
        return "gpu" if x == "tpu" else x

    return {a.option_strings[-1]: (a.dest, gpu(a.choices), gpu(a.default),
                                   a.type, a.nargs, a.const)
            for a in ap._actions if a.dest != "help"}


def test_flags_match_bench_py():
    """Every flag of `bench.py`, with its choices, default, type and
    arity, and no other."""
    assert options(bench.build_parser()) == options(jax_parser())


def help_flags(cmd):
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ,
                                               JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    text = out.stdout.replace("tpu", "gpu")
    return (set(re.findall(r"--[a-z][a-z-]*", text)),
            set(re.findall(r"\{[a-z0-9,-]+\}", text)))


def test_help_lists_bench_py_options():
    """`--help` of both, as a user reads it: the same options and choice
    sets (`gpu` for `tpu`); the port's prints without a card."""
    ref = help_flags([sys.executable, str(BENCH_PY), "--help"])
    got = help_flags([sys.executable, "-m", "ctrlvio_tpu_torch.bench",
                      "--help"])
    assert got == ref and "--preset" in got[0]


def jax_e2e_sim(args, duration):
    """`bench.py:222-230` through the JAX package's generator."""
    sim_kw = dict(duration=duration, n_landmarks=300, seed=args.seed,
                  speed=args.speed)
    if args.gt == "fine":
        sim_kw["gt_knot_dt"] = 0.01
    elif args.gt == "lissajous":
        sim_kw["gt_family"] = "lissajous"
    sim_cfg = (jsynthetic.SimConfig(**sim_kw) if args.noiseless
               else jsynthetic.reference_noise(**sim_kw))
    return jsynthetic.generate(sim_cfg)


@pytest.mark.parametrize("noiseless", [False, True])
@pytest.mark.parametrize("gt", ["spline", "fine", "lissajous"])
def test_e2e_sequence_matches_bench_py(gt, noiseless):
    """Each `--gt` family, with and without `--noiseless` (seed 5, 1.4x
    speed): frames and IMU equal the JAX generator's bit for bit."""
    argv = ["--gt", gt, "--seed", "5", "--speed", "1.4"]
    args = bench.build_parser().parse_args(
        argv + (["--noiseless"] if noiseless else []))
    same_sim(bench.e2e_sim(args, 2.0), jax_e2e_sim(args, 2.0))


def bench_py_call(func: str, callee: str):
    """The `callee(...)` call inside `bench.py::func`, as an AST node."""
    tree = ast.parse(BENCH_PY.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    return next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", getattr(n.func, "attr", None))
                == callee)


@pytest.mark.parametrize("preset", ["gpu", "cpu-smoke"])
@pytest.mark.parametrize("boot", ["visual", "gt"])
def test_e2e_config_matches_bench_py(preset, boot):
    """The e2e estimator sets every field `bench.py:231-240` sets, to the
    JAX bench's value for the same preset (f32 and the stream on the
    card, f64 and synchronous on the CPU)."""
    names = [k.arg for k in bench_py_call("main", "VIOConfig").keywords]
    assert names == ["window_config", "fix_ld", "ld_init", "dtype",
                     "bootstrap", "stream"]
    on_card = preset == "gpu"
    ref = jodometry.VIOConfig(
        window_config=jlayout.WindowConfig(KW=32, NB=11, LM=256, OBS=768,
                                           MIMU=256),
        fix_ld=False, ld_init=0.0,
        dtype=np.float32 if on_card else np.float64,
        bootstrap="visual" if boot == "visual" else "external",
        stream=on_card)
    args = bench.build_parser().parse_args(["--preset", preset,
                                            "--bootstrap", boot])
    got = bench.e2e_config(args, on_card)
    for k in names:
        a, b = getattr(ref, k), getattr(got, k)
        if k == "dtype":
            a = torch.float32 if a == np.float32 else torch.float64
        elif k == "window_config":
            a, b = tuple(a), tuple(b)
        assert a == b, k
    # every other field keeps the JAX default
    for k in ("knot_dt", "ba_iters", "ba_tol", "stream_warmup", "stream_lag",
              "image_weight", "init_max_rms"):
        assert getattr(got, k) == getattr(ref, k), k


def json_keys_of_bench_py():
    """The keys of the JSON line `bench.py::main` prints (`:365-374`)."""
    call = bench_py_call("main", "dumps")
    return [k.value for k in call.args[0].keys]


def result_lines(out: str):
    return [ln for ln in out.splitlines() if ln.startswith("{")]


def test_e2e_json_line(capsys):
    """A short CPU smoke run from the ground-truth bootstrap prints one
    JSON line, last on stdout, with exactly `bench.py`'s keys, inside
    the CPU gates."""
    bench.main(["--preset", "cpu-smoke", "--bootstrap", "gt",
                "--duration", "2.6"])
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert len(result_lines(out)) == 1 and lines[-1].startswith("{")
    rec = json.loads(lines[-1])
    assert list(rec) == json_keys_of_bench_py()
    assert rec["metric"] == "frames_per_sec_per_chip"
    assert (rec["gt"], rec["seed"], rec["speed"]) == ("spline", 3, 1.0)
    assert 0 <= rec["ate_online_cm"] < 6 and 0 <= rec["ate_posthoc_cm"] < 6
    assert 0 <= rec["ld_err_us"] < 2 and rec["value"] > 0


def test_e2e_gate_miss_exits_1(capsys, monkeypatch):
    """An ATE over the gate (stubbed) exits 1 and prints no result."""
    monkeypatch.setattr(bench, "ate_rmse", lambda *a, **k: 1.0)
    with pytest.raises(SystemExit) as e:
        bench.main(["--preset", "cpu-smoke", "--bootstrap", "gt",
                    "--duration", "1.6"])
    assert e.value.code == 1
    out, err = capsys.readouterr()
    assert not result_lines(out)
    assert "FAIL accuracy gates" in err


def test_gpu_preset_raises_without_a_card(monkeypatch):
    """No card: the default preset raises; nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("e2e", "image", "serve", "batch"):
        with pytest.raises(RuntimeError, match="is_available"):
            bench.main(["--mode", mode])


def test_batch_lanes_equal_single_solve(capsys):
    """`bench_batch` on the CPU at a shrunk sweep (B = 1, 2; the tiny
    window, 3 LM iterations): every lane equals the single
    `solve_window_fixed` up to f32 rounding of the batched products
    (seen: 6e-8 on the knots, 7e-9 on bg, 3e-10 of cost0 on the cost):
    knots and biases within 1e-6 absolute, inverse depths within 1e-6 of
    the largest, the line delay within 1e-10 s, the cost within 1e-8 of
    cost0. The JSON line is `bench.py`'s."""
    cfg = WindowConfig(KW=32, NB=11, LM=64, OBS=256, MIMU=256, dt=0.05)
    args = bench.build_parser().parse_args(["--preset", "cpu-smoke",
                                            "--mode", "batch"])
    res = bench.bench_batch(args, sweep=(1, 2), cfg=cfg, max_iters=3)
    rec = json.loads(result_lines(capsys.readouterr().out)[-1])
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == "batched_window_solves_per_sec"
    prob = tiny.tiny_problem(torch.float32, cfg, device="cpu")
    p1, s1 = lm.solve_window_fixed(
        prob.params, prob.img, prob.imu, prob.bias, prob.prior, prob.fixed,
        *prob.aux, cfg, SolveOptions(max_iters=3))
    assert float(s1.cost) < 1e-3 * float(s1.cost0)
    assert sorted(res) == [1, 2]
    atol = dict(knots_q=1e-6, knots_p=1e-6, bg=1e-6, ba=1e-6,
                dinv=1e-6 * float(p1.dinv.abs().max()), ld=1e-10)
    for B, (seconds, (pb, sb)) in res.items():
        assert seconds > 0 and sb.cost.shape == (B,)
        for i in range(B):
            assert abs(float(sb.cost[i]) - float(s1.cost)) <= \
                1e-8 * float(s1.cost0)
            for k, x, y in zip(p1._fields, p1, pb):
                assert float((x - y[i]).abs().max()) <= atol[k], (B, i, k)


@pytest.mark.slow
def test_cpu_smoke_matches_bench_py():
    """`python bench.py --preset cpu-smoke` and the port's, side by side
    at the same (default) duration: both exit 0; online and post-hoc ATE
    within 1 mm, line-delay error within 0.01 us (the JSON line's
    rounding is 1e-5 m and 1e-3 us)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for cmd in ([sys.executable, str(BENCH_PY), "--preset",
                          "cpu-smoke"],
                         [sys.executable, "-m", "ctrlvio_tpu_torch.bench",
                          "--preset", "cpu-smoke"])]
    recs = []
    for p in procs:
        out, err = p.communicate(timeout=1500)
        assert p.returncode == 0, err[-2000:]
        recs.append(json.loads(out.strip().splitlines()[-1]))
    ref, got = recs
    assert list(got) == list(ref)
    assert abs(got["ate_online_cm"] - ref["ate_online_cm"]) <= JAX_GAP_M * 100
    assert abs(got["ate_posthoc_cm"] - ref["ate_posthoc_cm"]) <= \
        JAX_GAP_M * 100
    assert abs(got["ld_err_us"] - ref["ld_err_us"]) <= 0.01
