"""Parity of the PyTorch port's Levenberg-Marquardt window solve with the JAX
package, float64 on the CPU: the same iterates, costs, damping and
accepted-step count, the exit rule (`max_iters`, or the first accepted step
whose relative decrease is below `tol`), and the dense normal equations
against the chunked accumulation. The window problem is
`test_torch_solver.py`'s."""

import jax.numpy as jnp
import pytest

from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu.solver import lm as jlm
from ctrlvio_tpu_torch.solver import layout as tlayout
from ctrlvio_tpu_torch.solver import lm as tlm
from ctrlvio_tpu_torch.utils.convert import tensor
from tests.test_torch_solver import CFG, TCFG, args, prob  # noqa: F401
from tests.torch_parity import close, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("max_iters,tol", [(3, 0.0), (12, 1e-3)])
def test_solve_window(prob, max_iters, tol):
    """Same iterates, costs and accepted-step count; with tol > 0 the loop
    stops at the first accepted step with relative decrease below tol."""
    jo = jlayout.SolveOptions(max_iters=max_iters, tol=tol)
    ja = args(prob, "jax")
    ta = args(prob, "torch")
    pj, sj = jlm.solve_window(ja[0], ja[1], ja[2], ja[3], ja[4],
                              jnp.asarray(prob["fixed"]), *ja[5:], CFG, jo)
    pt, st = tlm.solve_window(ta[0], ta[1], ta[2], ta[3], ta[4],
                              tensor(prob["fixed"]), *ta[5:], TCFG,
                              tlayout.SolveOptions(*jo))
    assert int(sj.accepted) == int(st.accepted)
    if tol > 0:
        assert int(st.accepted) < max_iters
    close(sj.cost0, st.cost0)
    close(sj.cost, st.cost, rtol=1e-8)
    close(sj.lm_lambda, st.lm_lambda)
    for x, y in zip(pj, pt):
        close(x, y, rtol=1e-7)


def test_solve_window_dense_equals_chunked(prob):
    ta = args(prob, "torch")
    o = tlayout.SolveOptions(max_iters=2)
    a, sa = tlm.solve_window(*ta[:5], tensor(prob["fixed"]), *ta[5:], TCFG, o)
    b, sb = tlm.solve_window(*ta[:5], tensor(prob["fixed"]), *ta[5:], TCFG, o,
                             ne_mode="dense")
    close(sa.cost.numpy(), sb.cost, rtol=1e-8)
    for x, y in zip(a, b):
        close(x.numpy(), y, rtol=1e-7)
