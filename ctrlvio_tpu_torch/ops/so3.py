"""SO(3) primitives on quaternions and rotation vectors (PyTorch port of
`ctrlvio_tpu/ops/so3.py`).

Batched over arbitrary leading axes, dtype-polymorphic (f32 on the card,
f64 for the oracle tests), and safe at the phi -> 0 singularity via the
double-`where` trick, so forward-mode derivatives (`torch.func.jacfwd`)
through the small-angle branch stay finite.

Quaternion convention: (w, x, y, z), unit norm, Hamilton product.
Tangent convention: right perturbation, `q ⊞ phi = q * exp(phi)`.
"""

from __future__ import annotations

import math

import torch

_EPS = {torch.float32: 1e-6, torch.float64: 1e-10}


def _eps(dtype):
    return _EPS.get(dtype, 1e-6)


def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_mul(q1, q2):
    """Hamilton product, broadcasting over leading axes."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q):
    # built on the device: a constant tensor from the host would be a
    # synchronizing copy on every call
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_exp(phi):
    """Rotation vector (..., 3) -> unit quaternion (..., 4)."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    eps = _eps(theta2.dtype)
    small = theta2 < eps * eps
    safe_theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = 0.5 * safe_theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / safe_theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w, k * phi], dim=-1)


def quat_log(q):
    """Unit quaternion (..., 4) -> rotation vector (..., 3)."""
    w = q[..., :1]
    v = q[..., 1:]
    sign = torch.where(w < 0, -torch.ones_like(w), torch.ones_like(w))
    w = w * sign
    v = v * sign
    v2 = torch.sum(v * v, dim=-1, keepdim=True)
    eps = _eps(v2.dtype)
    small = v2 < eps * eps
    safe_vnorm = torch.sqrt(torch.where(small, torch.ones_like(v2), v2))
    angle = 2.0 * torch.atan2(safe_vnorm, w)
    w_safe = torch.clamp(w, min=1e-3)
    k = torch.where(
        small,
        2.0 / w_safe * (1.0 - v2 / (3.0 * w_safe * w_safe)),
        angle / safe_vnorm,
    )
    return k * v


def cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_rotate_inv(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_to_matrix(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), w >= 0.
    Branch-free Shepperd-style recovery (best-conditioned candidate)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    norms2 = torch.sum(cand * cand, dim=-1)
    best = torch.argmax(norms2, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    sign = torch.where(q[..., :1] < 0, -torch.ones_like(q[..., :1]),
                       torch.ones_like(q[..., :1]))
    return q * sign


def hat(v):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def vee(M):
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _eye(phi):
    return torch.eye(3, dtype=phi.dtype, device=phi.device)


def _jac_coeffs(phi):
    """(theta2, A, B): J_l(phi) = I + A hat(phi) + B hat(phi)^2 with
    A = (1-cos t)/t^2, B = (t - sin t)/t^3."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    eps = _eps(theta2.dtype)
    small = theta2 < eps * eps
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t = torch.sqrt(safe_t2)
    A = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe_t)) / safe_t2)
    B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (safe_t - torch.sin(safe_t)) / (safe_t2 * safe_t))
    return theta2, A, B


def left_jacobian(phi):
    _, A, B = _jac_coeffs(phi)
    P = hat(phi)
    return _eye(phi) + A * P + B * (P @ P)


def right_jacobian(phi):
    """J_r(phi) = J_l(-phi) = J_l(phi)^T."""
    _, A, B = _jac_coeffs(phi)
    P = hat(phi)
    return _eye(phi) - A * P + B * (P @ P)


def _inv_jac_coeff(phi):
    """C = 1/t^2 - (1+cos t)/(2 t sin t), with Taylor 1/12 + t^2/720."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = theta2 < 1e-6
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t = torch.sqrt(safe_t2)
    return torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / safe_t2 - (1.0 + torch.cos(safe_t)) / (2.0 * safe_t * torch.sin(safe_t)),
    )


def left_jacobian_inv(phi):
    C = _inv_jac_coeff(phi)
    P = hat(phi)
    return _eye(phi) - 0.5 * P + C * (P @ P)


def right_jacobian_inv(phi):
    C = _inv_jac_coeff(phi)
    P = hat(phi)
    return _eye(phi) + 0.5 * P + C * (P @ P)


def boxplus(q, phi):
    """Right-tangent update q * exp(phi)."""
    return quat_normalize(quat_mul(q, quat_exp(phi)))


def boxminus(q, q0):
    """Right-tangent difference log(q0^{-1} q)."""
    return quat_log(quat_mul(quat_conj(q0), q))


DEG2RAD = math.pi / 180.0
