"""The bootstrap prior counts the factors it drops: the port's visual
bootstrap on a window whose square-root marginalization subset overflows
the caps `VIOConfig.marg_caps` adds one to `counts["marg_overflow"]` and
warns as a streamed frame's overflow does, and the prior it builds equals
the JAX package's `build_prior_sqrt` on the same inputs under the same caps
(float64 on the CPU; compared through J^T J and J^T r0 to 1e-8 relative,
as `test_torch_marginalize_sqrt.py` compares them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlvio_tpu.ops import factors as jfactors
from ctrlvio_tpu.solver import layout as jlayout
from ctrlvio_tpu.solver import marginalize as jmarg
from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.sim import synthetic
from ctrlvio_tpu_torch.solver import marginalize as tmarg
from ctrlvio_tpu_torch.solver.layout import WindowConfig
from tests.test_torch_marginalize import compare_priors
from tests.torch_parity import one_torch_thread  # noqa: F401

WINDOW = dict(KW=24, NB=6, LM=96, OBS=384, MIMU=192)
CAPS = (64, 16, 24)  # obs rows, IMU rows, landmark columns


def to_jax(x):
    """A port NamedTuple of tensors -> the JAX package's tuple of the same
    name; a tensor -> a jnp array; anything else as it is."""
    if torch.is_tensor(x):
        return jnp.asarray(x.numpy())
    if hasattr(x, "_fields"):
        cls = getattr(jlayout, type(x).__name__, None) or getattr(
            jfactors, type(x).__name__)
        return cls(*(to_jax(f) for f in x))
    return x


def bootstrap(caps, monkeypatch):
    """Drive a visual bootstrap in f64 on the CPU with `caps`; returns the
    estimator and the (args, kwargs, result) of its build_prior_sqrt call."""
    sim = synthetic.generate(synthetic.reference_noise(
        duration=3.0, n_landmarks=200, seed=11))
    cfg = VIOConfig(window_config=WindowConfig(**WINDOW), dtype=torch.float64,
                    bootstrap="visual", fix_ld=False, marg_caps=caps)
    vio = CtrlVIO(cfg, so3np.quat_exp(np.array(sim.cfg.ext_rot, np.float64)),
                  np.array(sim.cfg.ext_pos), device="cpu")
    calls = []
    build = tmarg.build_prior_sqrt

    def record(*a, **kw):
        out = build(*a, **kw)
        calls.append((a, kw, out))
        return out

    monkeypatch.setattr(tmarg, "build_prior_sqrt", record)
    imu_idx = 0
    for fr in sim.frames:
        while imu_idx < len(sim.imu_t_ns) and \
                sim.imu_t_ns[imu_idx] <= fr.t_ns + int(0.25e9):
            vio.process_imu(sim.imu_t_ns[imu_idx], sim.gyro[imu_idx],
                            sim.accel[imu_idx])
            imu_idx += 1
        vio.process_frame(fr.t_ns, fr.ids, fr.pts, fr.rows)
        if vio.initialized:
            break
    assert vio.initialized and len(calls) == 1
    return vio, calls[0]


def test_bootstrap_prior_overflow_is_counted_and_prior_matches_jax(
        monkeypatch):
    with pytest.warns(RuntimeWarning, match="overflowed its caps"):
        vio, (a, kw, (prior, ovf)) = bootstrap(CAPS, monkeypatch)
    assert kw["return_overflow"] and kw["caps"] == CAPS
    assert vio.counts["marg_overflow"] == 1
    assert ovf.numpy().sum() > 0

    # the JAX package reads its caps from the environment
    for name, cap in zip(("OBS", "IMU", "LM"), CAPS):
        monkeypatch.setenv(f"CTRLVIO_MARG_{name}", str(cap))
    ja = [to_jax(x) for x in a]
    pj, ovf_j = jmarg.build_prior_sqrt(
        *ja, return_overflow=True,
        knot_shift=jnp.asarray(kw["knot_shift"], jnp.int32),
        bias_shift=jnp.asarray(kw["bias_shift"], jnp.int32))
    np.testing.assert_array_equal(np.asarray(ovf_j), ovf.numpy())
    compare_priors(pj, prior, 1e-8)
    # the prior the estimator keeps is the one built
    compare_priors(pj, vio._prior64, 1e-8)
