"""The window's residual summary through `ops/factor_kernels.py::
residual_summary` (on the card kernel K5, one launch) on the CPU, where the
wrapper takes its plain version, `residual_summary_plain`.

`solver/assemble.py::residual_rms` and `total_cost` against the JAX
package's, on `sim/tiny.py`'s window and on a window of the e2e phase's
size (`WindowConfig(KW=32, NB=11, LM=256, OBS=768, MIMU=256)`), float64
within `torch_parity.RTOL` of the largest entry and float32 within 1e-5
(the two packages round float32 differently: other operation orders in
the spline, the rotations and the sums). The windows' knots, depths,
biases and line delay are perturbed and a prior is drawn, from a numpy
seed. Also: the wrapper under `torch.func.vmap` over 3 lanes equals a
loop, the custom op's vmap rule one call over the lanes; the op's fake
shape; one plain call on the CPU and no launch; the modules import neither
JAX nor the JAX package. The kernel itself is held to the plain version by
`tests/test_torch_factors_host.py` (on the host) and
`tests/test_torch_kernels.py` (gpu-marked)."""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ctrlvio_tpu.ops import factors as JF
from ctrlvio_tpu.solver import assemble as jasm
from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu_torch.ops import factor_kernels as fk
from ctrlvio_tpu_torch.ops import so3
from ctrlvio_tpu_torch.sim.tiny import tiny_problem
from ctrlvio_tpu_torch.solver import assemble as tasm
from ctrlvio_tpu_torch.solver import layout as tlayout
from tests.torch_parity import RTOL, close, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
WINDOWS = {"tiny": None,
           "e2e": tlayout.WindowConfig(KW=32, NB=11, LM=256, OBS=768,
                                       MIMU=256)}
TOL = {torch.float64: RTOL, torch.float32: 1e-5}
OPTS = tlayout.SolveOptions()


def window(name, dtype, seed=3):
    """`sim/tiny.py`'s problem at the window `name`, on the CPU in
    `dtype`, with its active knots, depths, biases and line delay
    perturbed and a prior over its first 60 coordinates drawn from
    `seed`: (cfg, the summary's arguments from `params` to
    `sqrt_info_img`)."""
    pb = tiny_problem(dtype, WINDOWS[name], device="cpu")
    cfg, p = pb.cfg, pb.params
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype)

    free = ~pb.fixed
    dq = rng.normal(size=(cfg.KW, 3)) * 0.02 * free.numpy()[:, None]
    dp = rng.normal(size=(cfg.KW, 3)) * 0.02 * free.numpy()[:, None]
    params = p._replace(
        knots_q=so3.boxplus(p.knots_q, t(dq)), knots_p=p.knots_p + t(dp),
        bg=t(rng.normal(size=(cfg.NB, 3)) * 1e-3),
        ba=t(rng.normal(size=(cfg.NB, 3)) * 1e-2),
        dinv=p.dinv * t(1.0 + 0.2 * rng.normal(size=cfg.LM)),
        ld=t(2e-5))
    J = np.zeros((cfg.C, cfg.C))
    J[:60] = rng.normal(size=(60, cfg.C)) * 0.1
    prior = pb.prior._replace(
        J=t(J), r0=t(np.r_[rng.normal(size=60) * 0.1,
                           np.zeros(cfg.C - 60)]),
        knots_q0=p.knots_q, knots_p0=p.knots_p, bg0=params.bg * 0.5,
        ba0=params.ba * 0.5, ld0=t(0.0))
    return cfg, (params, pb.img, pb.imu, pb.bias, prior, *pb.aux)


def as_jax(x):
    """A port tensor, or a named tuple of them, as the JAX package's type
    of the same name with numpy fields."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    fields = [as_jax(f) for f in x]
    cls = getattr(jlayout, type(x).__name__, None) or getattr(
        JF, type(x).__name__)
    return cls(*fields)


@pytest.fixture(scope="module")
def jax_summary():
    """The JAX package's residual RMS and total cost, compiled once a
    window (the op-by-op compile of the two took ~20 s a dtype)."""
    fns = {}

    def run(cfg, args):
        key = tuple(cfg)
        if key not in fns:
            jcfg = jlayout.WindowConfig(*cfg)
            jopts = jlayout.SolveOptions(*OPTS)
            fns[key] = jax.jit(lambda *a: (
                jasm.residual_rms(*a, jcfg, jopts),
                jasm.total_cost(*a, jcfg, jopts)))
        return [np.asarray(x) for x in fns[key](*(as_jax(a) for a in args))]

    return run


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["tiny", "e2e"])
def test_summary_matches_the_jax_package(jax_summary, name, dtype):
    """`residual_rms` (all four RMS) and `total_cost` through the
    wrappers' plain route against the JAX package's."""
    cfg, args = window(name, dtype)
    img, imu = args[1], args[2]
    assert (~img.valid).sum() > 0 and img.valid.sum() > 50
    assert imu.valid.sum() > 50
    rms_j, cost_j = jax_summary(cfg, args)
    fk.reset_counts()
    rms = tasm.residual_rms(*args, cfg, OPTS)
    cost = tasm.total_cost(*args, cfg, OPTS)
    assert fk.counts()["image_factor_residuals_plain"] == 2
    assert fk.counts()["imu_factor_residuals_plain"] == 2
    assert rms.dtype == cost.dtype == dtype
    assert bool((rms > 0).all())
    for a, b in zip(rms_j, rms):
        close(a[None], b[None], TOL[dtype])
    close(cost_j[None], cost[None], TOL[dtype])


def lanes(n=3, dtype=torch.float64):
    """The tiny window's arguments and n perturbed copies of its
    parameters, stacked."""
    cfg, args = window("tiny", dtype)
    params = args[0]
    rng = np.random.default_rng(12)
    out = []
    for _ in range(n):
        out.append(params._replace(
            knots_q=so3.boxplus(params.knots_q, torch.tensor(
                rng.normal(size=(cfg.KW, 3)) * 0.01, dtype=dtype)),
            knots_p=params.knots_p + torch.tensor(
                rng.normal(size=(cfg.KW, 3)) * 0.01, dtype=dtype),
            ld=params.ld * (1.0 + 0.1 * rng.normal())))
    return cfg, args, out, type(params)(*(torch.stack(f) for f in zip(*out)))


def op_calls(fn):
    """fn() and the summary op's calls it made (the innermost event of
    each: the profiler records a call under vmap once a layer)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.name() == fk.SUMMARY_OP]
    inner = [e for e in evs if not any(
        o is not e and e[0] <= o[0] and o[1] <= e[1] for o in evs)]
    return out, [n for _, _, n in sorted(inner)]


@pytest.mark.parametrize("via_op", [False, True])
def test_vmap_over_lanes_equals_a_loop(via_op):
    """vmap over 3 lanes of parameters (factors, prior and constants
    shared) equals a loop over them: through the wrapper (the plain
    version batched) and through the custom op, whose vmap rule makes one
    call over the 3 lanes; and `residual_rms` and `total_cost` vmapped as
    the serve path vmaps the summary."""
    cfg, args, each, stacked = lanes()
    summary = fk.residual_summary_op if via_op else fk.residual_summary

    def one(p):
        return summary(p, *args[1:], OPTS.cauchy_c, cfg)

    got, calls = op_calls(lambda: torch.func.vmap(one)(stacked))
    ref = torch.stack([one(p) for p in each])
    assert got.shape == (3, 5)
    if via_op:
        assert torch.equal(ref, got)
    else:
        close(ref, got, 1e-12)
    assert calls == ([fk.SUMMARY_OP] if via_op else [])

    def rms(p):
        return tasm.residual_rms(p, *args[1:], cfg, OPTS)

    def cost(p):
        return tasm.total_cost(p, *args[1:], cfg, OPTS)

    close(torch.stack([rms(p) for p in each]),
          torch.func.vmap(rms)(stacked), 1e-12)
    close(torch.stack([cost(p) for p in each]),
          torch.func.vmap(cost)(stacked), 1e-12)


def test_fake_shapes_match_the_ops():
    """The summary op's fake implementation gives the shape and dtype of
    its real output, (lanes, 5)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, args = window("tiny", torch.float64)
    ts = fk.summary_inputs(*args)
    static = (cfg.KW, cfg.NB, cfg.dt, OPTS.cauchy_c)
    real = fk.summary_op(*ts, *static)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = fk.summary_op(*(mode.from_tensor(t) for t in ts), *static)
    assert (tuple(fake.shape), fake.dtype) == (tuple(real.shape), real.dtype)
    assert tuple(real.shape) == (1, 5)


def test_wrappers_take_the_plain_version_on_the_cpu():
    """On the CPU the summary runs its plain version once and launches
    nothing; its image and IMU terms are the rows' residuals and costs
    before the mask and the robust weight, and `residual_rms` and
    `total_cost` read its first four entries and its fifth."""
    cfg, args = window("tiny", torch.float64)
    params, img, imu, bias, prior, ext, grav, info, w = args
    fk.reset_counts()
    out = fk.residual_summary(*args, OPTS.cauchy_c, cfg)
    c = fk.counts()
    assert (c["residual_summary_plain"], c["image_factor_residuals_plain"],
            c["imu_factor_residuals_plain"]) == (1, 1, 1)
    assert c["residual_summary"] == 0
    assert torch.equal(out[:4], tasm.residual_rms(*args, cfg, OPTS))
    assert torch.equal(out[4], tasm.total_cost(*args, cfg, OPTS))
    ir = fk.image_factor_residuals_plain(params, img, ext, w, OPTS.cauchy_c,
                                         cfg)
    mr = fk.imu_factor_residuals_plain(params, imu, grav, info, cfg)
    rows_i = fk.image_factor_rows(params, img, img.valid, ext, w,
                                  OPTS.cauchy_c, cfg)
    rows_m = fk.imu_factor_rows(params, imu, imu.valid, grav, info, cfg)
    m = img.valid
    wt = 1.0 / torch.sqrt(1.0 + (ir.r * ir.r).sum(-1) / OPTS.cauchy_c ** 2)
    close(rows_i.rw[m], ir.r[m] * wt[m, None], 1e-10)
    close(rows_i.cost[m], ir.cost[m], 1e-10)
    close(rows_m.r[imu.valid], mr.r[imu.valid], 1e-10)
    close(rows_m.cost[imu.valid], mr.sq[imu.valid], 1e-10)


@pytest.mark.parametrize("module", ["ops/factor_kernels.py",
                                    "solver/assemble.py",
                                    "estimator/stream.py"])
def test_modules_import_neither_jax_nor_the_jax_package(module):
    tree = ast.parse((REPO / "ctrlvio_tpu_torch" / module).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert names and not [m for m in names
                          if m.split(".")[0] in ("jax", "ctrlvio_tpu")]
