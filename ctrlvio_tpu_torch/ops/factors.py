"""Residuals of the continuous-time VIO window problem (PyTorch port of
`ctrlvio_tpu/ops/factors.py`).

- IMU factor (6-dim: spline gyro/accel vs measurement minus bias);
- rolling-shutter reprojection factor with per-row line-delay time shift
  (2-dim), including the d/d(line delay) dependence through `t + row * ld`;
- bias random-walk factor (6-dim).

Every function is batched over leading axes. The IMU Jacobians come from
`torch.func.jacfwd` over right-tangent perturbations (`solver/assemble.py`);
the reprojection Jacobians are closed forms (`ops/reproj_analytic.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3, spline


def imu_residual(q4, p4, u, inv_dt, bg, ba, gyro_meas, accel_meas, gravity,
                 info6):
    """6-dim weighted IMU residual:
    r[:3] = w_body(t) - (gyro_meas - bg)
    r[3:] = R(t)^T (a_world(t) + g) - (accel_meas - ba), times info6."""
    w = spline.so3_vel_body(q4, u, inv_dt)
    q = spline.so3_eval(q4, u)
    a_world = spline.rd_eval(p4, u, inv_dt, 2)
    a_body = so3.quat_rotate_inv(q, a_world + gravity)
    r = torch.cat([w - (gyro_meas - bg), a_body - (accel_meas - ba)], dim=-1)
    return info6 * r


def imu_residual_tangent(xi_r, xi_p, d_bg, d_ba, q4, p4, u, inv_dt, bg, ba,
                         gyro_meas, accel_meas, gravity, info6):
    """Residual under right-tangent perturbation; jacfwd at zeros gives the
    blocks w.r.t. (4 SO3 knots, 4 pos knots, bg, ba)."""
    return imu_residual(
        so3.boxplus(q4, xi_r), p4 + xi_p, u, inv_dt, bg + d_bg, ba + d_ba,
        gyro_meas, accel_meas, gravity, info6,
    )


class CamExtrinsics(NamedTuple):
    """Camera-to-IMU extrinsics."""

    q_CtoI: torch.Tensor  # (4,)
    p_CinI: torch.Tensor  # (3,)


def reproj_residual(q4i, p4i, ui, q4j, p4j, uj, inv_dt, pt_i, pt_j, dinv, ext,
                    sqrt_info):
    """2-dim weighted rolling-shutter reprojection residual: pt_i at
    inverse depth dinv (frame i, spline time ui) transferred through the
    world into frame j (time uj) and compared against pt_j."""
    q_i = spline.so3_eval(q4i, ui)
    p_i = spline.rd_eval(p4i, ui, inv_dt, 0)
    q_j = spline.so3_eval(q4j, uj)
    p_j = spline.rd_eval(p4j, uj, inv_dt, 0)

    # |dinv| floored: a landmark crossing zero inverse depth gives a
    # huge-but-finite point the Cauchy loss squashes
    dinv = torch.where(torch.abs(dinv) < 1e-5,
                       torch.where(dinv < 0, torch.full_like(dinv, -1e-5),
                                   torch.full_like(dinv, 1e-5)), dinv)
    x_ci = pt_i / dinv[..., None]
    p_Ii = so3.quat_rotate(ext.q_CtoI, x_ci) + ext.p_CinI
    p_G = so3.quat_rotate(q_i, p_Ii) + p_i
    p_Ij = so3.quat_rotate_inv(q_j, p_G - p_j)
    x_j = so3.quat_rotate_inv(ext.q_CtoI, p_Ij - ext.p_CinI)

    z = x_j[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6,
                         torch.sign(z) * 1e-6 + (z == 0).to(z.dtype) * 1e-6, z)
    r = x_j[..., :2] / z_safe[..., None] - pt_j[..., :2]
    return sqrt_info * r


def reproj_residual_ld(q4i, p4i, q4j, p4j, dinv, ld, fi, fj, shift_i, shift_j,
                       row_i, row_j, inv_dt, pt_i, pt_j, ext, sqrt_info):
    """Reprojection residual as an explicit function of the line delay:
    u_k(ld) = f_k + row_k * ld / dt - shift_k (integer shift frozen)."""
    ui = fi + row_i * ld * inv_dt - shift_i
    uj = fj + row_j * ld * inv_dt - shift_j
    return reproj_residual(q4i, p4i, ui, q4j, p4j, uj, inv_dt, pt_i, pt_j,
                           dinv, ext, sqrt_info)


def reproj_residual_tangent(xi_ri, xi_pi, xi_rj, xi_pj, d_dinv, d_ld,
                            q4i, p4i, q4j, p4j, dinv, ld, fi, fj,
                            shift_i, shift_j, row_i, row_j, inv_dt,
                            pt_i, pt_j, ext, sqrt_info):
    """Tangent-perturbed residual; jacfwd at zeros -> blocks w.r.t.
    (SO3 knots i, pos knots i, SO3 knots j, pos knots j, dinv, ld)."""
    return reproj_residual_ld(
        so3.boxplus(q4i, xi_ri), p4i + xi_pi,
        so3.boxplus(q4j, xi_rj), p4j + xi_pj,
        dinv + d_dinv, ld + d_ld,
        fi, fj, shift_i, shift_j, row_i, row_j, inv_dt, pt_i, pt_j, ext,
        sqrt_info,
    )


def bias_residual(bg_i, bg_j, ba_i, ba_j, sqrt_info6):
    """6-dim random-walk residual between consecutive keyframe biases."""
    r = torch.cat([bg_j - bg_i, ba_j - ba_i], dim=-1)
    return sqrt_info6 * r
