"""4-DoF gauge restoration after each sliding-window solve (PyTorch port of
`ctrlvio_tpu/solver/gauge.py`, ≙ `trajectory_manager.cpp:485-516`).

VIO leaves yaw and global translation unobservable; all optimized knots are
rigidly transformed so the anchor knot recovers the yaw and position it had
before the solve (full rotation difference near the pitch singularity).
"""

from __future__ import annotations

import math

import torch

from ctrlvio_tpu_torch.ops import so3


def r2ypr(R):
    """Rotation matrix -> (yaw, pitch, roll), ≙ Utility::R2ypr."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(
        a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
        -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y),
    )
    return torch.stack([y, p, r], dim=-1)


def yaw_quat(yaw):
    half = 0.5 * yaw
    z = torch.zeros_like(half)
    return torch.stack([torch.cos(half), z, z, torch.sin(half)], dim=-1)


def restore_gauge(knots_q, knots_p, q_ref, p_ref, anchor_idx: int,
                  start_idx: int):
    """Rigidly transform knots[i >= start_idx] so that knot[anchor_idx]
    recovers the yaw and position (q_ref, p_ref) it had before the solve."""
    q00 = knots_q[anchor_idx]
    t00 = knots_p[anchor_idx]
    ypr0 = r2ypr(so3.quat_to_matrix(q_ref))
    ypr00 = r2ypr(so3.quat_to_matrix(q00))
    y_diff = ypr0[0] - ypr00[0]

    q_yaw = yaw_quat(y_diff)
    tol = math.radians(1.0)
    singular = ((torch.abs(torch.abs(ypr0[1]) - math.pi / 2) < tol)
                | (torch.abs(torch.abs(ypr00[1]) - math.pi / 2) < tol))
    q_full = so3.quat_mul(q_ref, so3.quat_conj(q00))
    q_diff = torch.where(singular, q_full, q_yaw)
    t_diff = p_ref - so3.quat_rotate(q_diff, t00)

    idx = torch.arange(knots_q.shape[0], device=knots_q.device)
    sel = (idx >= start_idx)[:, None]
    q_new = so3.quat_normalize(so3.quat_mul(q_diff[None, :], knots_q))
    p_new = so3.quat_rotate(q_diff[None, :], knots_p) + t_diff[None, :]
    return torch.where(sel, q_new, knots_q), torch.where(sel, p_new, knots_p)
