"""Parity of the PyTorch port's marginalization with the JAX package, float64
on the CPU: the Schur-complement prior of the per-frame path, and the
roll, drop mask and caps. The window problem is `test_torch_solver.py`'s.
A prior is compared through J^T J and J^T r0, not J entry by entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu.solver import marginalize as jmarg
from ctrlvio_tpu_torch.solver import layout as tlayout
from ctrlvio_tpu_torch.solver import marginalize as tmarg
from ctrlvio_tpu_torch.utils.convert import tensor
from tests.test_torch_solver import CFG, TCFG, args, prob, tt  # noqa: F401
from tests.torch_parity import close, one_torch_thread  # noqa: F401


def info_pair(prior):
    J = np.asarray(prior.J.numpy() if torch.is_tensor(prior.J) else prior.J)
    r = np.asarray(prior.r0.numpy() if torch.is_tensor(prior.r0) else prior.r0)
    return J.T @ J, J.T @ r


def compare_priors(pj, pt, rtol):
    HJ, gJ = info_pair(pj)
    HT, gT = info_pair(pt)
    close(HJ, HT, rtol)
    close(gJ, gT, rtol)
    for x, y in zip(pj[2:], pt[2:]):
        close(x, y)


@pytest.mark.parametrize("shift", [None, "slide"])
def test_build_prior(prob, shift):
    opts = jlayout.SolveOptions(cauchy_c=1.0)
    kw = {} if shift is None else dict(knot_shift=prob["k1"], bias_shift=1)
    pj = jmarg.build_prior(
        *args(prob, "jax")[:4], args(prob, "jax")[4], jnp.asarray(prob["drop"]),
        *args(prob, "jax")[5:], CFG, opts,
        **{k: jnp.asarray(v, jnp.int32) for k, v in kw.items()})
    ta = args(prob, "torch")
    pt = tmarg.build_prior(*ta[:5], tensor(prob["drop"]), *ta[5:], TCFG,
                           tlayout.SolveOptions(*opts), **kw)
    compare_priors(pj, pt, 1e-8)


def test_roll_drop_mask_and_caps(prob):
    pr = prob["prior"]
    a = jmarg.roll_prior(pr, 3, 1, CFG)
    b = tmarg.roll_prior(tt(pr), 3, 1, TCFG)
    for x, y in zip(a, b):
        close(x, y)
    np.testing.assert_array_equal(
        np.asarray(jmarg.drop_mask(CFG, jnp.asarray(prob["drop"]), True)),
        tmarg.drop_mask(TCFG, tensor(prob["drop"]), True).numpy())
    assert tmarg.marg_caps(TCFG) == jmarg.marg_caps(CFG)
    big = tlayout.WindowConfig(KW=32, NB=11, LM=256, OBS=768, MIMU=256)
    assert tmarg.marg_caps(big) == (384, 128, 128)
    assert tmarg.marg_caps(big, obs=200, lm=64) == (200, 128, 64)
