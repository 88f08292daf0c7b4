"""Parity of the PyTorch port's marginalization with the JAX package on the
CPU: the Schur-complement prior of the per-frame path in float64 and, as
`VIOConfig(marg_on_host=False)` builds it, in float32; and the roll, drop
mask and caps. The window problem is `test_torch_solver.py`'s. A prior is
compared through J^T J and J^T r0, not J entry by entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu.solver import marginalize as jmarg
from ctrlvio_tpu_torch.solver import layout as tlayout
from ctrlvio_tpu_torch.solver import marginalize as tmarg
from ctrlvio_tpu_torch.utils.convert import from_numpy, tensor
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


# f32 against f32: the two packages sum the Schur complements in another
# order, and the landmark block's eigenvalue threshold (1e-6 of the largest
# in f32) and the eps = 1e-7 Jacobi-scaled Cholesky carry that rounding
# into J and r0; relative to the largest entry of J^T J and J^T r0 the
# packages differ by <= 2.5e-5 here, and each lies <= 5e-5 from the f64
# prior
F32_RTOL = 2e-4
# an old prior of this square-root weight on every coordinate, at the
# linearization point: it pins the 4-DoF gauge (yaw, position) that the
# window's factors leave free, so the kept block is well conditioned
ANCHOR = 100.0


def f32(nt):
    """A NamedTuple of numpy arrays with the floating ones in float32."""
    return type(nt)(*(np.asarray(x, np.float32)
                      if np.issubdtype(np.asarray(x).dtype, np.floating)
                      else np.asarray(x) for x in nt))


def anchored_prior(pb):
    p = pb["params"]
    return jlayout.PriorFactor(
        J=ANCHOR * np.eye(CFG.C), r0=np.zeros(CFG.C), knots_q0=p.knots_q,
        knots_p0=p.knots_p, bg0=p.bg, ba0=p.ba, ld0=p.ld)


def priors_f32(pb, prior, dtype, **kw):
    """The JAX package's and the port's `build_prior` on the window in
    `dtype` with the old prior `prior` (numpy)."""
    cast = f32 if dtype == np.float32 else (lambda nt: nt)
    nts = [cast(pb[k]) for k in ("params", "img", "imu", "bias")]
    nts += [cast(prior), cast(pb["ext"])]
    vec = [np.asarray(pb[k], dtype) for k in ("gravity", "info", "w")]
    opts = jlayout.SolveOptions(cauchy_c=1.0)
    to_j = lambda nt: type(nt)(*(jnp.asarray(x) for x in nt))  # noqa: E731
    pj = jmarg.build_prior(
        *(to_j(x) for x in nts[:5]), jnp.asarray(pb["drop"]), to_j(nts[5]),
        *(jnp.asarray(v) for v in vec), CFG, opts,
        **{k: jnp.asarray(v, jnp.int32) for k, v in kw.items()})
    pt = tmarg.build_prior(
        *(from_numpy(x, "cpu") for x in nts[:5]), tensor(pb["drop"]),
        from_numpy(nts[5], "cpu"), *(torch.from_numpy(v) for v in vec),
        TCFG, tlayout.SolveOptions(*opts), **kw)
    return pj, pt


@pytest.mark.parametrize("shift", [None, "slide"])
def test_build_prior_f32(prob, shift):
    """`build_prior` in float32 through both packages, as the synchronous
    path builds it with `VIOConfig(marg_on_host=False)`, on the float32
    cast of the window under an anchoring old prior: equal within
    F32_RTOL, and each as close to the float64 prior."""
    kw = {} if shift is None else dict(knot_shift=prob["k1"], bias_shift=1)
    prior = anchored_prior(prob)
    pj, pt = priors_f32(prob, prior, np.float32, **kw)
    assert pj.J.dtype == jnp.float32 and pt.J.dtype == torch.float32
    assert np.isfinite(pt.J.numpy()).all() and np.isfinite(pt.r0.numpy()).all()
    compare_priors(pj, pt, F32_RTOL)
    _, p64 = priors_f32(prob, prior, np.float64, **kw)
    for x in (pj, pt):
        H, g = info_pair(x)
        H64, g64 = info_pair(p64)
        close(H64, H, F32_RTOL)
        close(g64, g, F32_RTOL)


def test_build_prior_f32_gauge_free_fails_in_both(prob):
    """Without the anchor (the problem's own f64 prior, gauge-free like
    every prior the estimator builds) the kept block's gauge directions
    hold only eps = 1e-7 after Jacobi scaling: a condition number past
    float32's, and the float32 Cholesky fails in both packages alike, so
    that J and r0 come out NaN (the reference's failure, which the port
    keeps); in float64 the same build is finite."""
    pj, pt = priors_f32(prob, prob["prior"], np.float32)
    assert not np.isfinite(np.asarray(pj.J)).all()
    assert not np.isfinite(pt.J.numpy()).all()
    assert not np.isfinite(pt.r0.numpy()).all()
    _, p64 = priors_f32(prob, prob["prior"], np.float64)
    assert np.isfinite(p64.J.numpy()).all()


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
