"""The factor linearization's wrappers (`ctrlvio_tpu_torch/ops/
factor_kernels.py`, kernels K2 and K3 on the card) on the CPU, where they
take their plain versions: held to the JAX package's `assemble.linearize`
sliced to the image rows, IMU rows, residuals, landmark column and cost
(float64 within `torch_parity.RTOL` of the largest entry, float32 within
1e-4), with `marg_mode` both ways and invalid and marg_drop slots present;
under `torch.func.vmap` over 3 lanes equal to a loop, the custom ops' vmap
rule one call over the lanes; the custom ops' fake shapes. The kernels
themselves are held to the plain versions on the card by
`tests/test_torch_kernels.py` (gpu-marked) and `chip_smoke.py`."""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ctrlvio_tpu.solver import assemble as jasm
from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu_torch.ops import factor_kernels as fk
from ctrlvio_tpu_torch.ops import so3
from ctrlvio_tpu_torch.solver import layout as tlayout
from ctrlvio_tpu_torch.utils.convert import from_numpy, tensor
from tests.test_torch_solver import CFG, TCFG, build_problem, jx
from tests.torch_parity import RTOL, close, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TOL = {np.float64: RTOL, np.float32: 1e-4}
# compiled: the eager op-by-op compile of each dtype took ~36 s
LINEARIZE = jax.jit(jasm.linearize, static_argnums=(9, 10),
                    static_argnames=("marg_mode",))


@pytest.fixture(scope="module")
def prob():
    pb = build_problem()
    img = pb["img"]
    assert (~img.valid).sum() > 10 and (img.valid & img.marg_drop).sum() > 10
    assert (img.valid & ~img.marg_drop).sum() > 10
    assert (~pb["imu"].valid).sum() > 0 and (pb["imu"].valid
                                             & pb["imu"].marg_drop).sum() > 0
    return pb


def cast(nt, npdt):
    """Floating fields of a numpy named tuple in `npdt`."""
    return type(nt)(*(np.asarray(x, npdt) if np.asarray(x).dtype.kind == "f"
                      else np.asarray(x) for x in nt))


def inputs(pb, npdt):
    """The problem in `npdt` with a zero prior and no bias factor, so that
    the JAX package's cost is its image and IMU factors' alone."""
    params, img, imu = (cast(pb[k], npdt) for k in ("params", "img", "imu"))
    bias = cast(pb["bias"], npdt)._replace(
        valid=np.zeros_like(pb["bias"].valid))
    prior = jlayout.PriorFactor(*(np.asarray(x, npdt) for x in
                                  jlayout.empty_prior(CFG, npdt)))
    ext = cast(pb["ext"], npdt)
    return (params, img, imu, bias, prior, ext,
            np.asarray(pb["gravity"], npdt), np.asarray(pb["info"], npdt),
            np.asarray(pb["w"], npdt))


def torch_args(args):
    params, img, imu, bias, prior, ext, grav, info, w = args
    return (from_numpy(params, "cpu"), from_numpy(img, "cpu"),
            from_numpy(imu, "cpu"), from_numpy(ext, "cpu"), tensor(grav),
            tensor(info), tensor(w))


@pytest.mark.parametrize("npdt", [np.float64, np.float32])
@pytest.mark.parametrize("marg_mode", [False, True])
def test_wrappers_match_jax_linearize(prob, npdt, marg_mode):
    """The CPU wrappers' image and IMU rows, weighted residuals, landmark
    column and costs against the JAX package's linearization."""
    args = inputs(prob, npdt)
    lin = LINEARIZE(*(jx(a) for a in args), CFG, jlayout.SolveOptions(),
                    marg_mode=marg_mode)
    params, img, imu, ext, grav, info, w = torch_args(args)
    img_act = (img.valid & img.marg_drop) if marg_mode else img.valid
    imu_act = (imu.valid & imu.marg_drop) if marg_mode else imu.valid
    c = 1.0 if marg_mode else tlayout.SolveOptions().cauchy_c
    ir = fk.image_factor_rows(params, img, img_act, ext, w, c, TCFG)
    mr = fk.imu_factor_rows(params, imu, imu_act, grav, info, TCFG)
    Q, M, C = CFG.OBS, CFG.MIMU, CFG.C
    J, r = np.asarray(lin.J), np.asarray(lin.r)
    tol = TOL[npdt]
    close(J[: 2 * Q].reshape(Q, 2, C), ir.rows, tol)
    close(r[: 2 * Q].reshape(Q, 2), ir.rw, tol)
    close(np.asarray(lin.J_lm), ir.J_lm, tol)
    close(J[2 * Q : 2 * Q + 6 * M].reshape(M, 6, C), mr.rows, tol)
    close(r[2 * Q : 2 * Q + 6 * M].reshape(M, 6), mr.r, tol)
    cost = 0.5 * (torch.sum(ir.cost) + torch.sum(mr.cost))
    close(np.asarray(lin.cost)[None], cost[None], tol)
    for out in (*ir, *mr):
        assert out.dtype == params.knots_p.dtype


def lanes(pb, n=3):
    """n perturbed copies of the problem's parameters, stacked."""
    params = from_numpy(pb["params"], "cpu")
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        dq = torch.tensor(rng.normal(size=(CFG.KW, 3)) * 0.01)
        out.append(params._replace(
            knots_q=so3.boxplus(params.knots_q, dq),
            knots_p=params.knots_p + torch.tensor(
                rng.normal(size=(CFG.KW, 3)) * 0.01),
            ld=params.ld * (1.0 + 0.1 * rng.normal())))
    return out, type(params)(*(torch.stack(f) for f in zip(*out)))


def op_calls(fn):
    """fn() and the calls of the factor ops it made, in order: the
    profiler records a call under vmap once a dispatch layer, nested, so
    a call is an event that holds no other of its name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(fk.NAMESPACE + "::")]
    inner = [e for e in evs if not any(
        o is not e and o[2] == e[2] and e[0] <= o[0] and o[1] <= e[1]
        for o in evs)]
    return out, [n for _, _, n in sorted(inner)]


@pytest.mark.parametrize("via_op", [False, True])
def test_vmap_over_lanes_equals_a_loop(prob, via_op):
    """vmap over 3 lanes of parameters (factors and constants shared)
    equals a loop over them: through the wrappers (the plain versions
    batched), and through the custom ops, whose vmap rule makes one call
    over the 3 lanes."""
    each, stacked = lanes(prob)
    img = from_numpy(prob["img"], "cpu")
    imu = from_numpy(prob["imu"], "cpu")
    ext = from_numpy(prob["ext"], "cpu")
    grav, info, w = (tensor(prob[k]) for k in ("gravity", "info", "w"))
    image = fk.image_factor_rows_op if via_op else fk.image_factor_rows
    imu_fn = fk.imu_factor_rows_op if via_op else fk.imu_factor_rows

    def both(p):
        return (*image(p, img, img.valid, ext, w, 2.0, TCFG),
                *imu_fn(p, imu, imu.valid, grav, info, TCFG))

    got, calls = op_calls(lambda: torch.func.vmap(both)(stacked))
    ref = [torch.stack(x) for x in zip(*(both(p) for p in each))]
    for a, b in zip(ref, got):
        if via_op:
            assert torch.equal(a, b)
        else:
            close(a, b, 1e-12)
    assert calls == ([fk.IMAGE_OP, fk.IMU_OP] if via_op else [])


def test_fake_shapes_match_the_ops(prob):
    """The ops' fake implementations give the shapes and dtypes of their
    real outputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    params, img, imu, ext, grav, info, w = torch_args(
        inputs(prob, np.float64))
    a_img = fk.image_inputs(params, img, img.valid, ext, w)
    a_imu = fk.imu_inputs(params, imu, imu.valid, grav, info)
    static = (CFG.KW, CFG.NB, CFG.dt)
    real = (fk.image_op(*a_img, *static, 2.0), fk.imu_op(*a_imu, *static))
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = (fk.image_op(*(mode.from_tensor(t) for t in a_img), *static,
                            2.0),
                fk.imu_op(*(mode.from_tensor(t) for t in a_imu), *static))
    for outs_r, outs_f in zip(real, fake):
        assert len(outs_r) == len(outs_f)
        for r, f in zip(outs_r, outs_f):
            assert (tuple(f.shape), f.dtype) == (tuple(r.shape), r.dtype)
    Q, M, C = CFG.OBS, CFG.MIMU, CFG.C
    assert [tuple(t.shape) for t in real[0]] == [(1, Q, 2, C), (1, Q, 2),
                                                 (1, Q, 2), (1, Q)]
    assert [tuple(t.shape) for t in real[1]] == [(1, M, 6, C), (1, M, 6),
                                                 (1, M)]


def test_wrappers_take_the_plain_version_on_the_cpu(prob):
    """On the CPU each wrapper runs its plain version once and launches
    nothing."""
    params, img, imu, ext, grav, info, w = torch_args(
        inputs(prob, np.float64))
    fk.reset_counts()
    fk.image_factor_rows(params, img, img.valid, ext, w, 2.0, TCFG)
    fk.imu_factor_rows(params, imu, imu.valid, grav, info, TCFG)
    assert (fk.image_factor_rows_plain.calls,
            fk.imu_factor_rows_plain.calls) == (1, 1)
    assert (fk.image_factor_rows.launches,
            fk.imu_factor_rows.launches) == (0, 0)


def test_module_imports_neither_jax_nor_the_jax_package():
    tree = ast.parse((REPO / "ctrlvio_tpu_torch" / "ops"
                      / "factor_kernels.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert names and not [m for m in names
                          if m.split(".")[0] in ("jax", "ctrlvio_tpu")]
