"""Parity of the PyTorch port's math ops with the JAX package: SO(3),
splines, factor residuals and the closed-form reprojection Jacobians, in
float64 on the CPU at <= 1e-9 relative (same inputs from a seeded numpy
generator through both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlvio_tpu.ops import factors as JF
from ctrlvio_tpu.ops import reproj_analytic as JRA
from ctrlvio_tpu.ops import so3 as jso3
from ctrlvio_tpu.ops import so3np as jso3np
from ctrlvio_tpu.ops import spline as jspline
from ctrlvio_tpu_torch.ops import factors as TF
from ctrlvio_tpu_torch.ops import reproj_analytic as TRA
from ctrlvio_tpu_torch.ops import so3 as tso3
from ctrlvio_tpu_torch.ops import so3np as tso3np
from ctrlvio_tpu_torch.ops import spline as tspline
from tests.torch_parity import close, one_torch_thread  # noqa: F401

N = 64


def T(x):
    return torch.as_tensor(np.array(x, np.float64))


def J(x):
    return jnp.asarray(np.asarray(x, np.float64))


def rand_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def rand_phis(rng, n):
    phi = rng.normal(size=(n, 3)) * 0.7
    phi[:4] *= 1e-12  # the small-angle branch
    phi[4] = 0.0
    return phi


SO3_UNARY = ["quat_exp", "quat_log", "quat_normalize", "quat_conj",
             "quat_to_matrix", "hat", "left_jacobian", "right_jacobian",
             "left_jacobian_inv", "right_jacobian_inv"]


@pytest.mark.parametrize("name", SO3_UNARY)
def test_so3_unary(name):
    rng = np.random.default_rng(1)
    x = rand_phis(rng, N) if name in ("quat_exp", "hat", "left_jacobian",
                                      "right_jacobian", "left_jacobian_inv",
                                      "right_jacobian_inv") \
        else rand_quats(rng, N)
    close(getattr(jso3, name)(J(x)), getattr(tso3, name)(T(x)))


@pytest.mark.parametrize("name", ["quat_mul", "boxminus"])
def test_so3_binary_quat(name):
    rng = np.random.default_rng(2)
    a, b = rand_quats(rng, N), rand_quats(rng, N)
    close(getattr(jso3, name)(J(a), J(b)), getattr(tso3, name)(T(a), T(b)))


@pytest.mark.parametrize("name", ["quat_rotate", "quat_rotate_inv", "boxplus"])
def test_so3_quat_vec(name):
    rng = np.random.default_rng(3)
    q, v = rand_quats(rng, N), rng.normal(size=(N, 3))
    close(getattr(jso3, name)(J(q), J(v)), getattr(tso3, name)(T(q), T(v)))


def test_so3_matrix_roundtrip_and_vee():
    rng = np.random.default_rng(4)
    R = np.asarray(jso3.quat_to_matrix(J(rand_quats(rng, N))))
    close(jso3.matrix_to_quat(J(R)), tso3.matrix_to_quat(T(R)))
    close(jso3.vee(J(R)), tso3.vee(T(R)))


@pytest.mark.parametrize("name", ["quat_exp", "quat_log", "quat_to_matrix"])
def test_so3np_copy(name):
    rng = np.random.default_rng(5)
    x = rand_phis(rng, N) if name == "quat_exp" else rand_quats(rng, N)
    np.testing.assert_array_equal(getattr(jso3np, name)(x),
                                  getattr(tso3np, name)(x))


def spline_inputs(seed=6, n=N):
    rng = np.random.default_rng(seed)
    q4 = np.stack([jso3np.boxplus(rand_quats(rng, 1).repeat(4, 0),
                                  rng.normal(size=(4, 3)) * 0.2)
                   for _ in range(n)])
    p4 = rng.normal(size=(n, 4, 3))
    u = rng.uniform(0, 1, size=n)
    return q4, p4, u


@pytest.mark.parametrize("deriv", [0, 1, 2])
def test_spline_rd_eval(deriv):
    _, p4, u = spline_inputs()
    close(jspline.rd_eval(J(p4), J(u), 20.0, deriv),
          tspline.rd_eval(T(p4), T(u), 20.0, deriv))


@pytest.mark.parametrize("name", ["so3_eval", "so3_vel_body", "so3_accel_body"])
def test_spline_so3(name):
    q4, _, u = spline_inputs()
    args_j = (J(q4), J(u)) + (() if name == "so3_eval" else (20.0,))
    args_t = (T(q4), T(u)) + (() if name == "so3_eval" else (20.0,))
    a, b = getattr(jspline, name)(*args_j), getattr(tspline, name)(*args_t)
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        close(x, y)


def test_spline_gather_local_clips():
    knots = np.arange(40.0).reshape(10, 4)
    i0 = np.array([-2, 0, 5, 8, 9])
    close(jspline.gather_local(J(knots), jnp.asarray(i0, jnp.int32)),
          tspline.gather_local(T(knots), torch.as_tensor(i0)))


def test_imu_residual():
    rng = np.random.default_rng(7)
    q4, p4, u = spline_inputs(7)
    bg, ba = rng.normal(size=(N, 3)) * 0.01, rng.normal(size=(N, 3)) * 0.1
    gy, ac = rng.normal(size=(N, 3)), rng.normal(size=(N, 3)) * 9
    grav, info = np.array([0, 0, 9.8]), np.array([250.0] * 3 + [12.5] * 3)
    ref = jax.vmap(lambda a, b, c, d, e, f, g: JF.imu_residual(
        a, b, c, 20.0, d, e, f, g, J(grav), J(info)))(
        J(q4), J(p4), J(u), J(bg), J(ba), J(gy), J(ac))
    close(ref, TF.imu_residual(T(q4), T(p4), T(u), 20.0, T(bg), T(ba), T(gy),
                               T(ac), T(grav), T(info)))


def reproj_inputs(seed=8, n=N):
    rng = np.random.default_rng(seed)
    q4i, p4i, _ = spline_inputs(seed, n)
    q4j, p4j, _ = spline_inputs(seed + 100, n)
    p4j = p4i + rng.normal(size=p4i.shape) * 0.1
    d = dict(
        q4i=q4i, p4i=p4i, q4j=q4j, p4j=p4j,
        dinv=rng.uniform(0.1, 1.0, n), ld=np.float64(2.5e-5),
        fi=rng.uniform(0, 1, n), fj=rng.uniform(0, 1, n),
        shift_i=np.zeros(n), shift_j=np.zeros(n),
        row_i=rng.uniform(0, 1000, n), row_j=rng.uniform(0, 1000, n),
        pt_i=np.concatenate([rng.normal(size=(n, 2)) * 0.3, np.ones((n, 1))], 1),
        pt_j=np.concatenate([rng.normal(size=(n, 2)) * 0.3, np.ones((n, 1))], 1))
    d["dinv"][0] = 1e-7  # the inverse-depth floor
    ext = (jso3np.quat_exp(np.array([0.02, -0.01, 0.015])),
           np.array([0.007, -0.057, -0.042]))
    return d, ext


def test_reproj_residual_ld():
    d, ext = reproj_inputs()
    keys = ["q4i", "p4i", "q4j", "p4j", "dinv", "ld", "fi", "fj", "shift_i",
            "shift_j", "row_i", "row_j"]
    jext = JF.CamExtrinsics(J(ext[0]), J(ext[1]))
    text = TF.CamExtrinsics(T(ext[0]), T(ext[1]))
    ref = jax.vmap(
        lambda q4i, p4i, q4j, p4j, dinv, fi, fj, si, sj, ri, rj, pi, pj:
        JF.reproj_residual_ld(q4i, p4i, q4j, p4j, dinv, J(d["ld"]), fi, fj,
                              si, sj, ri, rj, 20.0, pi, pj, jext, 800.0))(
        *[J(d[k]) for k in keys if k != "ld"], J(d["pt_i"]), J(d["pt_j"]))
    out = TF.reproj_residual_ld(*[T(d[k]) for k in keys], 20.0, T(d["pt_i"]),
                                T(d["pt_j"]), text, 800.0)
    close(ref, out)


def test_reproj_analytic_blocks():
    d, ext = reproj_inputs(9)
    keys = ["q4i", "p4i", "q4j", "p4j", "dinv"]
    rest = ["fi", "fj", "shift_i", "shift_j", "row_i", "row_j"]
    jext = JF.CamExtrinsics(J(ext[0]), J(ext[1]))
    text = TF.CamExtrinsics(T(ext[0]), T(ext[1]))
    ref = jax.vmap(
        lambda q4i, p4i, q4j, p4j, dinv, fi, fj, si, sj, ri, rj, pi, pj:
        JRA.reproj_analytic(q4i, p4i, q4j, p4j, dinv, J(d["ld"]), fi, fj, si,
                            sj, ri, rj, 20.0, pi, pj, jext, 800.0))(
        *[J(d[k]) for k in keys + rest], J(d["pt_i"]), J(d["pt_j"]))
    out = TRA.reproj_analytic(*[T(d[k]) for k in keys], T(d["ld"]),
                              *[T(d[k]) for k in rest], 20.0, T(d["pt_i"]),
                              T(d["pt_j"]), text, 800.0)
    assert len(ref) == len(out) == 7
    for a, b in zip(ref, out):
        close(a, b)


def test_bias_residual():
    rng = np.random.default_rng(10)
    x = [rng.normal(size=(N, 3)) for _ in range(4)] + [rng.uniform(1, 2, (N, 6))]
    close(jax.vmap(JF.bias_residual)(*map(J, x)),
          TF.bias_residual(*map(T, x)))
