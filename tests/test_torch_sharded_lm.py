"""Parity of the port's factor-sharded LM (`parallel/sharded_lm.py`) with
the JAX package's, float64 on the CPU (the port of
`tests/test_parallel.py::test_factor_sharded_step_matches_unsharded` and
`test_full_sharded_solve_matches_unsharded`): the port on 4 gloo ranks
(fac = 4, `tests/torch_dist_case.py`, the launch of
`test_torch_parallel.py`) against JAX's unsharded step and JAX's
`make_factor_sharded_step` / `make_sharded_solve` on the conftest's
8-device CPU mesh (fac = 8), with `test_torch_solver.py`'s non-empty
marginalization prior."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ctrlvio_tpu.parallel import mesh as jmesh
from ctrlvio_tpu.parallel import sharded_lm as jsharded
from ctrlvio_tpu.solver import assemble as jasm
from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu.solver import lm as jlm
from tests.test_torch_parallel import (  # noqa: F401
    MAX_ITERS, _jargs, launched, params_of, port, same_solve)
from tests.test_torch_solver import CFG, prob  # noqa: F401
from tests.torch_parity import one_torch_thread  # noqa: F401

LAM = 1e-4  # the step's damping, as the ranks use it


def _unsharded_step(opts):
    """JAX's single-device step (`tests/test_parallel.py`'s reference)."""
    def step(params, img, imu, bias, prior, fixed, ext, gravity, info, w,
             lam):
        cmask = jlayout.column_mask(CFG, opts, fixed).astype(jnp.float64)
        lin = jasm.linearize(params, img, imu, bias, prior, ext, gravity,
                             info, w, CFG, opts)
        H, g, h_ll, g_l, H_cl = jlm.build_normal_equations(lin, CFG, cmask)
        dx, dx_lm = jlm.schur_solve(H, g, h_ll, g_l, H_cl, lam, cmask)
        p = jlayout.retract(params, dx, CFG, opts)
        return p._replace(dinv=params.dinv + dx_lm), lin.cost
    return jax.jit(step)


@pytest.fixture(scope="module")
def jax_side(prob, launched):  # noqa: F811
    """JAX's unsharded step, and its sharded step and solve at fac = 8."""
    jo1 = jlayout.SolveOptions(max_iters=1)
    a0 = _jargs(prob, prob["params"])
    lam = jnp.asarray(LAM, jnp.float64)
    mesh8 = jmesh.make_mesh(n_seq=1, n_fac=8)
    return {
        "step": _unsharded_step(jo1)(*a0, lam),
        "step_sharded": jsharded.make_factor_sharded_step(
            mesh8, CFG, jo1)(*a0, lam),
        "solve_sharded": jsharded.make_sharded_solve(
            mesh8, CFG, jlayout.SolveOptions(max_iters=MAX_ITERS))(*a0),
    }


@pytest.mark.parametrize("ref", ["step", "step_sharded"])
def test_factor_sharded_step_matches_jax(jax_side, port, ref):
    """fac = 4, on every rank: the port's step equals JAX's unsharded step
    and JAX's factor-sharded step at fac = 8 (cost rtol 1e-10, knots and
    inverse depths within 1e-7)."""
    ref_p, ref_c = jax_side[ref]
    for z in port:
        got = params_of(z, "step")
        np.testing.assert_allclose(z["step.cost"], float(ref_c), rtol=1e-10)
        for name in ("knots_q", "knots_p", "dinv"):
            np.testing.assert_allclose(got[name],
                                       np.asarray(getattr(ref_p, name)),
                                       rtol=0, atol=1e-7)


def test_full_sharded_solve_matches_jax_sharded(jax_side, port):
    """fac = 4, 6 iterations, on every rank: JAX's `make_sharded_solve`
    at fac = 8 (`same_solve`)."""
    for z in port:
        same_solve(z, *jax_side["solve_sharded"])


def test_replicated_rows_counted_once(prob, jax_side, port):  # noqa: F811
    """The prior and the bias pairs are whole on every rank; counted on
    each of the 4 they would add 3 more times their cost, far above the
    1e-10 to which the sharded step's cost matches JAX's unsharded cost."""
    a0 = _jargs(prob, prob["params"])
    cost = jax.jit(lambda *a: jasm.total_cost(*a, cfg=CFG,
                                              opts=jlayout.SolveOptions()))
    total = float(cost(*a0[:5], *a0[6:]))
    no_prior = float(cost(*a0[:4], jlayout.empty_prior(CFG, jnp.float64),
                          *a0[6:]))
    bias = a0[3]
    no_bias = float(cost(*a0[:3],
                         bias._replace(valid=jnp.zeros_like(bias.valid)),
                         a0[4], *a0[6:]))
    assert total - no_prior > 1e-6 * total
    assert total - no_bias > 1e-6 * total
    np.testing.assert_allclose(total, float(jax_side["step"][1]), rtol=1e-10)
    for z in port:
        np.testing.assert_allclose(z["step.cost"], total, rtol=1e-10)
