"""Parity of the PyTorch port's square-root marginalization (the bootstrap's
QR prior) with the JAX package, float64 on the CPU, including the overflow
flags of its compacted factor subset. The window problem is
`test_torch_solver.py`'s. The prior is compared through J^T J and J^T r0,
not J entry by entry: QR may flip row signs (`marginalize.py:287`)."""

import jax.numpy as jnp
import numpy as np
import pytest

from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu.solver import marginalize as jmarg
from ctrlvio_tpu_torch.solver import layout as tlayout
from ctrlvio_tpu_torch.solver import marginalize as tmarg
from ctrlvio_tpu_torch.utils.convert import tensor
from tests.test_torch_marginalize import compare_priors
from tests.test_torch_solver import CFG, TCFG, args, prob  # noqa: F401
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("shift", [None, "slide"])
def test_build_prior_sqrt(prob, shift):
    opts = jlayout.SolveOptions(cauchy_c=1.0)
    kw = {} if shift is None else dict(knot_shift=prob["k1"], bias_shift=1)
    ja = args(prob, "jax")
    pj, ovf_j = jmarg.build_prior_sqrt(
        *ja[:5], jnp.asarray(prob["drop"]), *ja[5:], CFG, opts,
        return_overflow=True,
        **{k: jnp.asarray(v, jnp.int32) for k, v in kw.items()})
    ta = args(prob, "torch")
    pt, ovf_t = tmarg.build_prior_sqrt(
        *ta[:5], tensor(prob["drop"]), *ta[5:], TCFG,
        tlayout.SolveOptions(*opts), return_overflow=True, **kw)
    np.testing.assert_array_equal(np.asarray(ovf_j), ovf_t.numpy())
    compare_priors(pj, pt, 1e-8)
