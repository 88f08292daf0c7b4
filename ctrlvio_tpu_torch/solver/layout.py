"""Window problem layout: parameter tuple, packed factor arrays, tangent map
(PyTorch port of `ctrlvio_tpu/solver/layout.py`).

Local-coordinate layout of the camera system:

    [ 0        , 3*KW      )   SO(3) knot tangents (right perturbation)
    [ 3*KW     , 6*KW      )   position knots
    [ 6*KW     , 6*KW+3*NB )   gyro biases (NB keyframes)
    [ ...      , 6*KW+6*NB )   accel biases
    [ C-1      , C         )   line delay
    C = 6*KW + 6*NB + 1

Landmark inverse depths live outside this layout (Schur-eliminated). The
marginalization prior's Jacobian columns are expressed in this layout, so a
window slide is a column roll.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ctrlvio_tpu_torch.ops import so3


class WindowConfig(NamedTuple):
    """Static configuration (shapes / constants)."""

    KW: int = 40          # window knot capacity
    NB: int = 11          # keyframes in window (WINDOW_SIZE+1)
    LM: int = 256         # landmark slots
    OBS: int = 2048       # image pair-factor slots
    MIMU: int = 512       # IMU factor slots
    dt: float = 0.05      # knot spacing seconds

    @property
    def C(self) -> int:
        return 6 * self.KW + 6 * self.NB + 1

    @property
    def n_rows(self) -> int:
        return 2 * self.OBS + 6 * self.MIMU + 6 * (self.NB - 1) + self.C

    def col_so3(self, k):
        return 3 * k

    def col_pos(self, k):
        return 3 * self.KW + 3 * k

    def col_bg(self, b):
        return 6 * self.KW + 3 * b

    def col_ba(self, b):
        return 6 * self.KW + 3 * self.NB + 3 * b

    @property
    def col_ld(self):
        return self.C - 1


class WindowParams(NamedTuple):
    """Optimization variables (the device-side window state)."""

    knots_q: torch.Tensor  # (KW, 4) wxyz, IMU-to-world
    knots_p: torch.Tensor  # (KW, 3)
    bg: torch.Tensor       # (NB, 3)
    ba: torch.Tensor       # (NB, 3)
    dinv: torch.Tensor     # (LM,) inverse depths
    ld: torch.Tensor       # () line delay, seconds/row


class ImageFactors(NamedTuple):
    """Packed rolling-shutter reprojection pair factors."""

    i0_i: torch.Tensor    # (OBS,) int base segment, window-relative
    f_i: torch.Tensor     # (OBS,) fractional part of t_i/dt
    row_i: torch.Tensor   # (OBS,)
    pt_i: torch.Tensor    # (OBS, 3) normalized, z=1
    i0_j: torch.Tensor
    f_j: torch.Tensor
    row_j: torch.Tensor
    pt_j: torch.Tensor
    lm_idx: torch.Tensor  # (OBS,) int landmark slot
    valid: torch.Tensor   # (OBS,) bool
    marg_drop: torch.Tensor  # (OBS,) bool: enters marginalization


class ImuFactors(NamedTuple):
    i0: torch.Tensor      # (MIMU,) int window-relative segment
    u: torch.Tensor       # (MIMU,)
    gyro: torch.Tensor    # (MIMU, 3)
    accel: torch.Tensor   # (MIMU, 3)
    bias_idx: torch.Tensor  # (MIMU,) int keyframe interval
    valid: torch.Tensor
    marg_drop: torch.Tensor  # t < ts[1] factors enter marginalization


class BiasFactors(NamedTuple):
    sqrt_info: torch.Tensor  # (NB-1, 6) per-pair diag sqrt info
    valid: torch.Tensor      # (NB-1,)


class PriorFactor(NamedTuple):
    """Linearized marginalization prior r = r0 + J (x ⊟ x0)."""

    J: torch.Tensor        # (C, C)
    r0: torch.Tensor       # (C,)
    knots_q0: torch.Tensor  # (KW, 4) linearization point
    knots_p0: torch.Tensor
    bg0: torch.Tensor
    ba0: torch.Tensor
    ld0: torch.Tensor


class SolveOptions(NamedTuple):
    """≙ TrajectoryEstimatorOptions + per-call solve settings."""

    max_iters: int = 15
    lock_bias: bool = False
    fix_ld: bool = False
    ld_lower: float = 0.0
    ld_upper: float = 3.5e-5
    cauchy_c: float = 2.0        # Cauchy loss scale for image factors
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 4.0
    lm_lambda_down: float = 0.5
    # early termination: stop once an accepted step improves the cost by
    # less than tol (relative); 0 = always run max_iters
    tol: float = 0.0
    # Schur solver: "chol" (exact Cholesky) or "cg" (`cg_iters` iterations
    # of block-Jacobi PCG) (≙ CTRLVIO_SOLVE / CTRLVIO_CG_ITERS)
    solver: str = "chol"
    cg_iters: int = 48


def empty_params(cfg: WindowConfig, dtype=torch.float32,
                 device="cpu") -> WindowParams:
    q = torch.zeros((cfg.KW, 4), dtype=dtype, device=device)
    q[:, 0] = 1.0
    return WindowParams(
        knots_q=q,
        knots_p=torch.zeros((cfg.KW, 3), dtype=dtype, device=device),
        bg=torch.zeros((cfg.NB, 3), dtype=dtype, device=device),
        ba=torch.zeros((cfg.NB, 3), dtype=dtype, device=device),
        dinv=torch.full((cfg.LM,), 0.2, dtype=dtype, device=device),
        ld=torch.zeros((), dtype=dtype, device=device),
    )


def empty_prior(cfg: WindowConfig, dtype=torch.float32,
                device="cpu") -> PriorFactor:
    p = empty_params(cfg, dtype, device)
    return PriorFactor(
        J=torch.zeros((cfg.C, cfg.C), dtype=dtype, device=device),
        r0=torch.zeros((cfg.C,), dtype=dtype, device=device),
        knots_q0=p.knots_q, knots_p0=p.knots_p, bg0=p.bg, ba0=p.ba,
        ld0=p.ld,
    )


def retract(params: WindowParams, delta, cfg: WindowConfig,
            opts: SolveOptions) -> WindowParams:
    """Apply a local step delta (C,): SO(3) knots by right perturbation,
    ld projected into its box."""
    KW, NB = cfg.KW, cfg.NB
    d_so3 = delta[: 3 * KW].reshape(KW, 3)
    d_pos = delta[3 * KW : 6 * KW].reshape(KW, 3)
    d_bg = delta[6 * KW : 6 * KW + 3 * NB].reshape(NB, 3)
    d_ba = delta[6 * KW + 3 * NB : 6 * KW + 6 * NB].reshape(NB, 3)
    d_ld = delta[cfg.col_ld]
    ld_new = torch.clamp(params.ld + d_ld, opts.ld_lower, opts.ld_upper)
    return params._replace(
        knots_q=so3.boxplus(params.knots_q, d_so3),
        knots_p=params.knots_p + d_pos,
        bg=params.bg + d_bg,
        ba=params.ba + d_ba,
        ld=params.ld if opts.fix_ld else ld_new,
    )


def boxminus_full(params: WindowParams, q0, p0, bg0, ba0, ld0,
                  cfg: WindowConfig):
    """x ⊟ x0 in the window layout (C,)."""
    d_so3 = so3.boxminus(params.knots_q, q0).reshape(-1)
    d_pos = (params.knots_p - p0).reshape(-1)
    d_bg = (params.bg - bg0).reshape(-1)
    d_ba = (params.ba - ba0).reshape(-1)
    d_ld = (params.ld - ld0).reshape(1)
    return torch.cat([d_so3, d_pos, d_bg, d_ba, d_ld])


def column_mask(cfg: WindowConfig, opts: SolveOptions, fixed_knots,
                dtype=torch.float32):
    """(C,) 0/1 mask: 0 for frozen coordinates (fixed knots, locked biases,
    fixed line delay)."""
    NB = cfg.NB
    dev = fixed_knots.device
    knot_m = (1.0 - fixed_knots.to(dtype))[:, None].expand(-1, 3).reshape(-1)
    bias_m = torch.full((6 * NB,), 0.0 if opts.lock_bias else 1.0, dtype=dtype,
                        device=dev)
    ld_m = torch.full((1,), 0.0 if opts.fix_ld else 1.0, dtype=dtype,
                      device=dev)
    return torch.cat([knot_m, knot_m, bias_m, ld_m])
