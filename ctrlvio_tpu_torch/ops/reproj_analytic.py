"""Closed-form Jacobians of the rolling-shutter reprojection factor (PyTorch
port of `ctrlvio_tpu/ops/reproj_analytic.py`).

Right-tangent perturbations q ⊞ φ = q exp(φ), wxyz quaternions; batched
over leading axes. Matches the forward-mode derivative of
`factors.reproj_residual_tangent` to machine precision.
"""

from __future__ import annotations

import torch

from . import so3, spline


def _t(M):
    return M.transpose(-1, -2)


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def so3_value_knot_jac(q4, u):
    """R(u) (quat) and per-knot right-tangent Jacobians J (..., 4, 3, 3)."""
    lam = spline.blend_coeffs(u, 0, cumulative=True)
    d = spline.so3_deltas(q4)  # (..., 3, 3)

    A = [so3.quat_exp(lam[..., i + 1, None] * d[..., i, :]) for i in range(3)]
    R3 = so3.quat_to_matrix(A[2])
    P3 = torch.eye(3, dtype=q4.dtype, device=q4.device).expand(R3.shape)
    P2 = R3
    P1 = so3.quat_to_matrix(A[1]) @ R3
    P0 = so3.quat_to_matrix(A[0]) @ P1

    q = q4[..., 0, :]
    for Ai in A:
        q = so3.quat_mul(q, Ai)
    q = so3.quat_normalize(q)

    Jr = [so3.right_jacobian(lam[..., i + 1, None] * d[..., i, :]) for i in range(3)]
    Jr_inv_d = [so3.right_jacobian_inv(d[..., i, :]) for i in range(3)]
    Jl_inv_d = [so3.left_jacobian_inv(d[..., i, :]) for i in range(3)]

    P = [P0, P1, P2, P3]
    Jk = []
    for k in range(4):
        Jv = torch.zeros_like(P3)
        if k == 0:
            Jv = _t(P[0])
        if k >= 1:
            i = k - 1
            Jv = Jv + lam[..., i + 1, None, None] * _t(P[i + 1]) @ Jr[i] @ Jr_inv_d[i]
        if k <= 2:
            i = k
            Jv = Jv - lam[..., i + 1, None, None] * _t(P[i + 1]) @ Jr[i] @ Jl_inv_d[i]
        Jk.append(Jv)
    return q, torch.stack(Jk, dim=-3)


def reproj_analytic(q4i, p4i, q4j, p4j, dinv, ld, fi, fj, shift_i, shift_j,
                    row_i, row_j, inv_dt, pt_i, pt_j, ext, sqrt_info):
    """Residual (..., 2) + closed-form Jacobian blocks.

    Returns (r, J_ri (..,2,4,3), J_pi, J_rj, J_pj, J_dinv (..,2), J_ld (..,2))."""
    ui = fi + row_i * ld * inv_dt - shift_i
    uj = fj + row_j * ld * inv_dt - shift_j

    q_i, Jk_i = so3_value_knot_jac(q4i, ui)
    q_j, Jk_j = so3_value_knot_jac(q4j, uj)
    p_i = spline.rd_eval(p4i, ui, inv_dt, 0)
    p_j = spline.rd_eval(p4j, uj, inv_dt, 0)
    lam_pi = spline.blend_coeffs(ui, 0, cumulative=False)  # (..., 4)
    lam_pj = spline.blend_coeffs(uj, 0, cumulative=False)

    R_CtoI = so3.quat_to_matrix(ext.q_CtoI)
    R_i = so3.quat_to_matrix(q_i)
    R_j = so3.quat_to_matrix(q_j)

    dinv = torch.where(torch.abs(dinv) < 1e-5,
                       torch.where(dinv < 0, torch.full_like(dinv, -1e-5),
                                   torch.full_like(dinv, 1e-5)), dinv)
    x_ci = pt_i / dinv[..., None]
    p_Ii = _mv(R_CtoI, x_ci) + ext.p_CinI
    p_G = _mv(R_i, p_Ii) + p_i
    y = p_G - p_j
    Rjt_y = _mv(_t(R_j), y)
    x_j = _mv(_t(R_CtoI), Rjt_y - ext.p_CinI)

    z = x_j[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-6,
                         torch.sign(z) * 1e-6 + (z == 0).to(z.dtype) * 1e-6, z)
    r = sqrt_info * (x_j[..., :2] / z_safe[..., None] - pt_j[..., :2])

    zero = torch.zeros_like(z)
    J_v = sqrt_info * torch.stack([
        torch.stack([1.0 / z_safe, zero, -x_j[..., 0] / z_safe ** 2], dim=-1),
        torch.stack([zero, 1.0 / z_safe, -x_j[..., 1] / z_safe ** 2], dim=-1),
    ], dim=-2)  # (..., 2, 3)

    M = _t(R_CtoI) @ _t(R_j)  # world -> camera j rotation

    A_i = -(M @ R_i) @ so3.hat(p_Ii)
    J_ri = torch.einsum("...ab,...bc,...kcd->...akd", J_v, A_i, Jk_i)
    A_j = _t(R_CtoI) @ so3.hat(Rjt_y)
    J_rj = torch.einsum("...ab,...bc,...kcd->...akd", J_v, A_j, Jk_j)
    JvM = J_v @ M  # (..., 2, 3)
    J_pi = JvM[..., :, None, :] * lam_pi[..., None, :, None]
    J_pj = -JvM[..., :, None, :] * lam_pj[..., None, :, None]
    J_dinv = _mv(J_v, _mv(-(M @ R_i @ R_CtoI), x_ci) / dinv[..., None])
    w_i = spline.so3_vel_body(q4i, ui, inv_dt)
    w_j = spline.so3_vel_body(q4j, uj, inv_dt)
    v_i = spline.rd_eval(p4i, ui, inv_dt, 1)
    v_j = spline.rd_eval(p4j, uj, inv_dt, 1)
    dxdti = _mv(M, _mv(R_i, _mv(so3.hat(w_i), p_Ii)) + v_i)
    dxdtj = -_mv(_t(R_CtoI), _mv(so3.hat(w_j), Rjt_y)) - _mv(M, v_j)
    J_ld = _mv(J_v, row_i[..., None] * dxdti + row_j[..., None] * dxdtj)
    return r, J_ri, J_pi, J_rj, J_pj, J_dinv, J_ld
