"""Parity of the port's conjugate-gradient Schur path with the JAX package,
float64 on the CPU: `schur_solve(solver="cg")` on the same normal equations
(1e-8 relative), the CG step against the Cholesky step (equal when heavily
damped; a descent step reaching most of the model decrease otherwise), and
`solve_window_fixed` with CG against JAX's `solve_window(solver="cg")`,
its final cost within the LM tolerance of chol's. The window problem is
`test_torch_solver.py`'s."""

import jax.numpy as jnp
import pytest
import torch

from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu.solver import lm as jlm
from ctrlvio_tpu_torch.solver import layout as tlayout
from ctrlvio_tpu_torch.solver import lm as tlm
from ctrlvio_tpu_torch.utils.convert import tensor
from tests.test_torch_solver import CFG, TCFG, _ne, args, prob  # noqa: F401
from tests.torch_parity import close, one_torch_thread  # noqa: F401

CG_ITERS = 48


@pytest.mark.parametrize("lam", [1e-4, 10.0])
@pytest.mark.parametrize("iters", [8, CG_ITERS])
def test_cg_schur_solve_matches_jax(prob, lam, iters):
    """The same fixed-count PCG iterates as the JAX package's CG path."""
    ja, cm = _ne(prob, "jax")
    tb, _ = _ne(prob, "torch")
    dx_j = jlm.schur_solve(*ja, jnp.asarray(lam), jnp.asarray(cm),
                           solver="cg", cg_iters=iters)
    dx_t = tlm.schur_solve(*tb, torch.tensor(lam, dtype=torch.float64),
                           tensor(cm), solver="cg", cg_iters=iters)
    for x, y in zip(dx_j, dx_t):
        close(x, y, rtol=1e-8)


def test_cg_step_against_cholesky_step(prob):
    """Heavily damped, CG's step is chol's; lightly damped it is a descent
    step that reaches at least 90 % of the exact step's decrease of the
    damped quadratic model."""
    tb, cm = _ne(prob, "torch")
    H, g, h_ll, g_l, H_cl = tb
    cm = tensor(cm)
    for lam, rtol in ((10.0, 1e-9), (1e-4, None)):
        lam_t = torch.tensor(lam, dtype=torch.float64)
        dx_c, dl_c = tlm.schur_solve(*tb, lam_t, cm)
        dx_g, dl_g = tlm.schur_solve(*tb, lam_t, cm, solver="cg",
                                     cg_iters=CG_ITERS)
        if rtol is not None:
            close(dx_c, dx_g, rtol=rtol)
            close(dl_c, dl_g, rtol=rtol)
            continue
        # the reduced (Schur) model m(dx) = g_sc.dx + dx.H_sc.dx / 2
        diag = torch.clamp(torch.diagonal(H), 1e-6, 1e32)
        H_d = H + lam * torch.diag(diag) + torch.diag(1.0 - cm)
        inv = 1.0 / (h_ll * (1.0 + lam) + 1e-8)
        H_sc = H_d - H_cl.T @ (H_cl * inv[:, None])
        g_sc = g - H_cl.T @ (g_l * inv)

        def model(dx):
            return float(g_sc @ dx + 0.5 * dx @ H_sc @ dx)

        assert float(g_sc @ dx_g) < 0.0
        assert model(dx_g) <= 0.9 * model(dx_c) < 0.0


def test_cg_solve_window_matches_jax_and_chol(prob):
    """`solve_window_fixed` with CG takes JAX's `solve_window(solver="cg")`
    iterates (the same accepted steps, params to 1e-7), and its final cost
    lies within the LM tolerance (1e-5 of the initial cost) of chol's."""
    ja, ta = args(prob, "jax"), args(prob, "torch")
    fixed_j, fixed_t = jnp.asarray(prob["fixed"]), tensor(prob["fixed"])
    costs = {}
    for solver in ("chol", "cg"):
        jo = jlayout.SolveOptions(max_iters=12, tol=1e-5, solver=solver,
                                  cg_iters=CG_ITERS)
        pj, sj = jlm.solve_window(*ja[:5], fixed_j, *ja[5:], CFG, jo)
        pt, st = tlm.solve_window_fixed(*ta[:5], fixed_t, *ta[5:], TCFG,
                                        tlayout.SolveOptions(*jo))
        assert int(sj.accepted) == int(st.accepted) >= 1
        close(sj.cost, st.cost, rtol=1e-8)
        for x, y in zip(pj, pt):
            close(x, y, rtol=1e-7)
        costs[solver] = (float(st.cost0), float(st.cost))
    cost0 = costs["chol"][0]
    assert abs(costs["cg"][1] - costs["chol"][1]) < 1e-5 * cost0
