"""Uniform cubic B-spline evaluation on SO(3) x R^3 (PyTorch port of
`ctrlvio_tpu/ops/spline.py`).

Evaluators take a local window of N=4 knots: `(..., 4, 4)` quaternions and
`(..., 4, 3)` positions, batched over leading axes; callers gather the
windows with `gather_local`. Time on the device is knot-grid coordinates
`(i0, u)` with `t = t0 + (i0 + u) * dt`.
"""

from __future__ import annotations

from math import comb, factorial

import numpy as np
import torch

from . import so3

N = 4  # spline order
DEG = N - 1


def _blending_matrix(order: int, cumulative: bool) -> np.ndarray:
    """De Boor–Cox uniform B-spline blending matrix (order x order), f64."""
    m = np.zeros((order, order), dtype=np.float64)
    for i in range(order):
        for j in range(order):
            s = sum(
                (-1.0) ** (k - j) * comb(order, k - j)
                * (order - k - 1.0) ** (order - 1.0 - i)
                for k in range(j, order)
            )
            m[j, i] = comb(order - 1, order - 1 - i) * s
    if cumulative:
        for i in range(order):
            for j in range(i + 1, order):
                m[i] += m[j]
    return m / factorial(order - 1)


_M_CUM = _blending_matrix(N, cumulative=True)   # SO(3) cumulative blending
_M_STD = _blending_matrix(N, cumulative=False)  # R^3 blending

# _BASE[d, j] = coefficient of u^{j-d} in the d-th derivative of u^j
_BASE = np.zeros((N, N), dtype=np.float64)
_BASE[0] = 1.0
for _d in range(1, N):
    for _j in range(_d, N):
        _BASE[_d, _j] = (_j - _d + 1) * _BASE[_d - 1, _j]


def _u_powers(u, deriv: int):
    """p[..., j] = d^deriv/du^deriv u^j (length N)."""
    cols = []
    for j in range(N):
        if j < deriv:
            cols.append(torch.zeros_like(u))
        else:
            p = torch.ones_like(u)
            for _ in range(j - deriv):
                p = p * u
            cols.append(float(_BASE[deriv, j]) * p)
    return torch.stack(cols, dim=-1)


# the blending matrices as tensors, by (cumulative, dtype, device): each is
# copied to a device once, not at every call (a host-to-device copy of
# pageable memory synchronizes the host with the card)
_M_TENSORS = {}


def _blend_matrix(cumulative: bool, dtype, device):
    key = (cumulative, dtype, str(device))
    M = _M_TENSORS.get(key)
    if M is None:
        M = torch.as_tensor(_M_CUM if cumulative else _M_STD, dtype=dtype,
                            device=device)
        _M_TENSORS[key] = M
    return M


def blend_coeffs(u, deriv: int, cumulative: bool):
    """Blending coefficients lambda(u) (..., N), without 1/dt^deriv."""
    Mj = _blend_matrix(cumulative, u.dtype, u.device)
    return _u_powers(u, deriv) @ Mj.T


def rd_eval(p4, u, inv_dt, deriv: int = 0):
    """R^d spline value / velocity / acceleration from 4 local knots.
    p4: (..., 4, D), u: (...,)."""
    lam = blend_coeffs(u, deriv, cumulative=False) * (inv_dt ** deriv)
    return torch.einsum("...k,...kd->...d", lam, p4)


def so3_deltas(q4):
    """d_i = log(q_i^{-1} q_{i+1}), i = 0..2 -> (..., 3, 3)."""
    q0, q1 = q4[..., :-1, :], q4[..., 1:, :]
    return so3.quat_log(so3.quat_mul(so3.quat_conj(q0), q1))


def so3_eval(q4, u):
    """R(u) as quaternion: q0 * prod_i exp(lam_{i+1} d_i)."""
    lam = blend_coeffs(u, 0, cumulative=True)
    d = so3_deltas(q4)
    q = q4[..., 0, :]
    for i in range(DEG):
        q = so3.quat_mul(q, so3.quat_exp(lam[..., i + 1 : i + 2] * d[..., i, :]))
    return so3.quat_normalize(q)


def so3_vel_body(q4, u, inv_dt):
    """Body-frame angular velocity (..., 3)."""
    lam = blend_coeffs(u, 0, cumulative=True)
    dlam = blend_coeffs(u, 1, cumulative=True) * inv_dt
    d = so3_deltas(q4)
    w = torch.zeros_like(q4[..., 0, 1:])
    for i in range(DEG):
        kd = lam[..., i + 1 : i + 2] * d[..., i, :]
        w = so3.quat_rotate(so3.quat_exp(-kd), w) + dlam[..., i + 1 : i + 2] * d[..., i, :]
    return w


def so3_accel_body(q4, u, inv_dt):
    """Body-frame angular acceleration and velocity."""
    lam = blend_coeffs(u, 0, cumulative=True)
    dlam = blend_coeffs(u, 1, cumulative=True) * inv_dt
    ddlam = blend_coeffs(u, 2, cumulative=True) * (inv_dt ** 2)
    d = so3_deltas(q4)
    w = torch.zeros_like(q4[..., 0, 1:])
    a = torch.zeros_like(w)
    for i in range(DEG):
        kd = lam[..., i + 1 : i + 2] * d[..., i, :]
        rot = so3.quat_exp(-kd)
        w = so3.quat_rotate(rot, w)
        v_cur = dlam[..., i + 1 : i + 2] * d[..., i, :]
        w = w + v_cur
        a = so3.quat_rotate(rot, a)
        a = a + ddlam[..., i + 1 : i + 2] * d[..., i, :] + so3.cross(w, v_cur)
    return a, w


def se3_eval(q4, p4, u, inv_dt):
    return so3_eval(q4, u), rd_eval(p4, u, inv_dt, 0)


def gather_local(knots, i0):
    """N=4 consecutive knots from i0, index-clipped: (K, D), (...) -> (..., 4, D)."""
    idx = i0[..., None] + torch.arange(N, dtype=i0.dtype, device=i0.device)
    idx = idx.clamp(0, knots.shape[0] - 1)
    return knots[idx]


def refloor(i0, u):
    """Re-normalize grid coordinates so u in [0, 1)."""
    shift = torch.floor(u)
    return i0 + shift.to(i0.dtype), u - shift
