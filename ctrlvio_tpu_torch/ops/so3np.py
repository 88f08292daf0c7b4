"""Pure-numpy SO(3) mini-ops for the host/bookkeeping layer (the port's own
copy of `ctrlvio_tpu/ops/so3np.py`).

The estimator's host side (pose queries, window slides, dead-reckoning,
triangulation) runs per-frame Python code on small arrays; these are the
formulas of `ops/so3.py` in plain numpy. Device code uses `ops/so3.py`.
"""

from __future__ import annotations

import numpy as np


def quat_mul(q1, q2):
    # sliced indexing + preallocated output: ~5x faster than the
    # moveaxis/stack formulation on the small per-frame host arrays
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    out = np.empty(np.broadcast_shapes(q1.shape, q2.shape))
    out[..., 0] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    out[..., 1] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    out[..., 2] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    out[..., 3] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    return out


def _cross(a, b):
    """Explicit cross product (np.cross's moveaxis machinery costs ~10x on
    the small host arrays in the per-frame loop)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    out = np.empty(np.broadcast_shapes(a.shape, b.shape))
    out[..., 0] = a1 * b2 - a2 * b1
    out[..., 1] = a2 * b0 - a0 * b2
    out[..., 2] = a0 * b1 - a1 * b0
    return out


def quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_normalize(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def quat_exp(phi):
    phi = np.asarray(phi, dtype=np.float64)
    t2 = np.sum(phi * phi, axis=-1, keepdims=True)
    t = np.sqrt(t2)
    small = t < 1e-10
    ts = np.where(small, 1.0, t)
    k = np.where(small, 0.5 - t2 / 48.0, np.sin(0.5 * ts) / ts)
    w = np.where(small, 1.0 - t2 / 8.0, np.cos(0.5 * ts))
    return np.concatenate([w, k * phi], axis=-1)


def quat_log(q):
    w = q[..., :1]
    v = q[..., 1:]
    sign = np.where(w < 0, -1.0, 1.0)
    w, v = w * sign, v * sign
    vn = np.linalg.norm(v, axis=-1, keepdims=True)
    small = vn < 1e-10
    vns = np.where(small, 1.0, vn)
    angle = 2.0 * np.arctan2(vn, w)
    k = np.where(small, 2.0 / np.maximum(w, 1e-3), angle / vns)
    return k * v


def quat_rotate(q, v):
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def quat_rotate_inv(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.empty(q.shape[:-1] + (3, 3))
    m[..., 0, 0] = 1 - 2 * (y * y + z * z)
    m[..., 0, 1] = 2 * (x * y - w * z)
    m[..., 0, 2] = 2 * (x * z + w * y)
    m[..., 1, 0] = 2 * (x * y + w * z)
    m[..., 1, 1] = 1 - 2 * (x * x + z * z)
    m[..., 1, 2] = 2 * (y * z - w * x)
    m[..., 2, 0] = 2 * (x * z - w * y)
    m[..., 2, 1] = 2 * (y * z + w * x)
    m[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def boxplus(q, phi):
    return quat_normalize(quat_mul(q, quat_exp(phi)))


def boxminus(q, q0):
    return quat_log(quat_mul(quat_conj(q0), q))


# --- spline evaluation (order 4, host) -------------------------------------

_M_CUM = None
_M_STD = None


def _mats():
    global _M_CUM, _M_STD
    if _M_CUM is None:
        from ctrlvio_tpu_torch.ops.spline import _M_CUM as MC, _M_STD as MS

        _M_CUM, _M_STD = np.asarray(MC), np.asarray(MS)
    return _M_CUM, _M_STD


def _u_pow(u, deriv):
    from ctrlvio_tpu_torch.ops.spline import _BASE

    u = np.asarray(u, dtype=np.float64)
    cols = []
    for j in range(4):
        cols.append(np.zeros_like(u) if j < deriv
                    else _BASE[deriv, j] * u ** (j - deriv))
    return np.stack(cols, axis=-1)


def so3_eval(q4, u):
    """Batched cumulative SO(3) spline value. q4: (..., 4, 4), u: (...)."""
    MC, _ = _mats()
    lam = _u_pow(u, 0) @ MC.T
    d = quat_log(quat_mul(quat_conj(q4[..., :-1, :]), q4[..., 1:, :]))
    q = q4[..., 0, :]
    for i in range(3):
        q = quat_mul(q, quat_exp(lam[..., i + 1 : i + 2] * d[..., i, :]))
    return quat_normalize(q)


def rd_eval(p4, u, inv_dt, deriv=0):
    _, MS = _mats()
    lam = _u_pow(u, deriv) @ MS.T * (inv_dt**deriv)
    return np.einsum("...k,...kd->...d", lam, p4)


def so3_vel_body(q4, u, inv_dt):
    """Body angular velocity of the cumulative SO(3) spline (numpy)."""
    MC, _ = _mats()
    lam = _u_pow(u, 0) @ MC.T
    dlam = _u_pow(u, 1) @ MC.T * inv_dt
    d = quat_log(quat_mul(quat_conj(q4[..., :-1, :]), q4[..., 1:, :]))
    w = np.zeros(q4.shape[:-2] + (3,))
    for i in range(3):
        kd = lam[..., i + 1 : i + 2] * d[..., i, :]
        w = quat_rotate(quat_exp(-kd), w) + dlam[..., i + 1 : i + 2] * d[..., i, :]
    return w
