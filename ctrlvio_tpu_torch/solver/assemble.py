"""Linearization: packed factors -> dense Jacobian rows over the window
layout, and the normal equations (PyTorch port of
`ctrlvio_tpu/solver/assemble.py`).

Every factor's 4-knot block Jacobians expand into dense rows over the
C-dim camera system; H = J^T J is then one matrix product, and the
(diagonal) landmark block stays separate for analytic Schur elimination.
Robust loss: Cauchy with scale c, applied as the sqrt(rho') rescaling.
The image and IMU factors' rows come from `ops/factor_kernels.py` (on the
card kernels K2 and K3, one launch a chunk); the bias and prior rows, the
products and the landmark sums are here. The factor evaluations and the
normal equations run inside `torch.profiler.record_function` ranges
("image factors", "IMU factors", "normal equations"), which a profile of
an eager solve attributes device time to.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from ctrlvio_tpu_torch.ops import factor_kernels as fk
from ctrlvio_tpu_torch.ops import factors as F
from ctrlvio_tpu_torch.ops import spline
from ctrlvio_tpu_torch.ops.factor_kernels import (_cauchy_weight_and_cost,
                                                  _segments)

from .layout import (BiasFactors, ImageFactors, ImuFactors, PriorFactor,
                     SolveOptions, WindowConfig, WindowParams, boxminus_full)


class Linearization(NamedTuple):
    J: torch.Tensor        # (R, C) dense camera-system Jacobian rows
    r: torch.Tensor        # (R,) residuals (robust-weighted)
    J_lm: torch.Tensor     # (OBS, 2) d r_img / d dinv (robust-weighted)
    lm_idx: torch.Tensor   # (OBS,)
    obs_valid: torch.Tensor  # (OBS,)
    cost: torch.Tensor     # robustified total cost (scalar)


def _bias_rows(si, cfg: WindowConfig):
    """(NB-1, 6, C) bias-pair rows from masked per-pair sqrt info (NB-1, 6):
    gyro rows touch bg_i (-) and bg_j (+); accel rows touch ba."""
    KW, NB = cfg.KW, cfg.NB
    dtype, dev = si.dtype, si.device
    nb = torch.arange(NB, device=dev)
    pair = torch.arange(NB - 1, device=dev)
    oh_bi = (nb[None, :] == pair[:, None]).to(dtype)
    oh_bj = (nb[None, :] == pair[:, None] + 1).to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    bg_rows = (torch.einsum("pd,pb->pdb", si[:, :3], oh_bj - oh_bi)[:, :, :, None]
               * eye3[None, :, None, :]).reshape(NB - 1, 3, 3 * NB)
    ba_rows = (torch.einsum("pd,pb->pdb", si[:, 3:], oh_bj - oh_bi)[:, :, :, None]
               * eye3[None, :, None, :]).reshape(NB - 1, 3, 3 * NB)
    zKW = torch.zeros((NB - 1, 3, 6 * KW), dtype=dtype, device=dev)
    z3NB = torch.zeros((NB - 1, 3, 3 * NB), dtype=dtype, device=dev)
    z1 = torch.zeros((NB - 1, 3, 1), dtype=dtype, device=dev)
    gyro_rows = torch.cat([zKW, bg_rows, z3NB, z1], dim=2)
    accel_rows = torch.cat([zKW, z3NB, ba_rows, z1], dim=2)
    return torch.cat([gyro_rows, accel_rows], dim=1)


def linearize(params: WindowParams, img: ImageFactors, imu: ImuFactors,
              bias: BiasFactors, prior: PriorFactor, ext, gravity, imu_info,
              sqrt_info_img, cfg: WindowConfig, opts: SolveOptions,
              marg_mode: bool = False) -> Linearization:
    """Evaluate all residuals and build dense Jacobian rows.

    marg_mode=True restricts to the marginalization factor subset
    (marg_drop flags, Cauchy scale 1) and is used to build the prior."""
    dtype = params.knots_p.dtype
    C, NB = cfg.C, cfg.NB
    R_img, R_imu, R_bias = 2 * cfg.OBS, 6 * cfg.MIMU, 6 * (NB - 1)

    img_active = (img.valid & img.marg_drop) if marg_mode else img.valid
    imu_active = (imu.valid & imu.marg_drop) if marg_mode else imu.valid
    cauchy_c = 1.0 if marg_mode else opts.cauchy_c

    with record_function("image factors"):
        ir = fk.image_factor_rows(params, img, img_active, ext,
                                  sqrt_info_img, cauchy_c, cfg)
    cost = 0.5 * torch.sum(ir.cost)
    with record_function("IMU factors"):
        mr = fk.imu_factor_rows(params, imu, imu_active, gravity, imu_info,
                                cfg)
    cost = cost + 0.5 * torch.sum(mr.cost)

    bias_active = bias.valid
    if marg_mode:
        # only the first bias pair is marginalized
        bias_active = bias.valid & (
            torch.arange(NB - 1, device=bias.valid.device) == 0)
    rb = F.bias_residual(params.bg[:-1], params.bg[1:], params.ba[:-1],
                         params.ba[1:], bias.sqrt_info)
    m_bias = bias_active.to(dtype)
    r_bias = (rb * m_bias[:, None]).reshape(-1)
    cost = cost + 0.5 * torch.sum((rb * m_bias[:, None]) ** 2)

    dx = boxminus_full(params, prior.knots_q0, prior.knots_p0, prior.bg0,
                       prior.ba0, prior.ld0, cfg)
    r_prior = prior.r0 + prior.J @ dx
    cost = cost + 0.5 * torch.sum(r_prior * r_prior)

    J_bias_rows = _bias_rows(bias.sqrt_info * m_bias[:, None], cfg)
    J = torch.cat([
        ir.rows.reshape(R_img, C),
        mr.rows.reshape(R_imu, C),
        J_bias_rows.reshape(R_bias, C),
        prior.J,
    ], dim=0)
    r = torch.cat([ir.rw.reshape(-1), mr.r.reshape(-1), r_bias, r_prior])
    return Linearization(J=J, r=r, J_lm=ir.J_lm, lm_idx=img.lm_idx,
                         obs_valid=img_active, cost=cost)


def _chunks(t, Q: int):
    n = t[0].shape[0]
    for a in range(0, n, Q):
        yield type(t)(*(f[a : a + Q] for f in t))


def accumulate_normal_equations(params: WindowParams, img: ImageFactors,
                                imu: ImuFactors, bias: BiasFactors,
                                ext, gravity, imu_info, sqrt_info_img,
                                cfg: WindowConfig, opts: SolveOptions,
                                chunk: Optional[int] = None):
    """Normal equations by accumulation over factor chunks of `chunk` slots
    (None or 0 = one chunk holding every factor): algebraically identical
    to `linearize` + `lm.build_normal_equations`, without materializing the
    (R, C) Jacobian.

    Returns (H (C,C), g (C,), h_ll (LM,), g_l (LM,), H_cl (LM,C), cost),
    without the prior (hoisted by `lm.solve_window`)."""
    if not chunk:
        chunk = max(cfg.OBS, cfg.MIMU)
    dtype, dev = params.knots_p.dtype, params.knots_p.device
    C, NB, LM = cfg.C, cfg.NB, cfg.LM
    H = torch.zeros((C, C), dtype=dtype, device=dev)
    g = torch.zeros((C,), dtype=dtype, device=dev)
    h_ll = torch.zeros((LM,), dtype=dtype, device=dev)
    g_l = torch.zeros((LM,), dtype=dtype, device=dev)
    H_cl = torch.zeros((LM, C), dtype=dtype, device=dev)
    cost = torch.zeros((), dtype=dtype, device=dev)

    if cfg.OBS % min(chunk, cfg.OBS) or cfg.MIMU % min(chunk, cfg.MIMU):
        raise ValueError("OBS and MIMU must be multiples of the chunk size")

    for ic in _chunks(img, min(chunk, cfg.OBS)):
        with record_function("image factors"):
            ir = fk.image_factor_rows(params, ic, ic.valid, ext,
                                      sqrt_info_img, opts.cauchy_c, cfg)
        cost = cost + 0.5 * torch.sum(ir.cost)
        rows, rw, Jl = ir.rows, ir.rw, ir.J_lm
        H = H + torch.einsum("qrc,qrd->cd", rows, rows)
        g = g + torch.einsum("qrc,qr->c", rows, rw)
        h_ll = h_ll.index_add(0, ic.lm_idx, torch.sum(Jl * Jl, -1))
        g_l = g_l.index_add(0, ic.lm_idx, torch.sum(Jl * rw, -1))
        H_cl = H_cl.index_add(0, ic.lm_idx, torch.einsum("qr,qrc->qc", Jl, rows))

    for mc in _chunks(imu, min(chunk, cfg.MIMU)):
        with record_function("IMU factors"):
            mr = fk.imu_factor_rows(params, mc, mc.valid, gravity, imu_info,
                                    cfg)
        cost = cost + 0.5 * torch.sum(mr.cost)
        H = H + torch.einsum("qrc,qrd->cd", mr.rows, mr.rows)
        g = g + torch.einsum("qrc,qr->c", mr.rows, mr.r)

    rb = F.bias_residual(params.bg[:-1], params.bg[1:], params.ba[:-1],
                         params.ba[1:], bias.sqrt_info)
    mb = bias.valid.to(dtype)
    cost = cost + 0.5 * torch.sum((rb * mb[:, None]) ** 2)
    rows_b = _bias_rows(bias.sqrt_info * mb[:, None], cfg)
    rwb = rb * mb[:, None]
    H = H + torch.einsum("qrc,qrd->cd", rows_b, rows_b)
    g = g + torch.einsum("qrc,qr->c", rows_b, rwb)
    return H, g, h_ll, g_l, H_cl, cost


def _residuals(params: WindowParams, img: ImageFactors, imu: ImuFactors,
               bias: BiasFactors, prior: PriorFactor, ext, gravity, imu_info,
               sqrt_info_img, cfg: WindowConfig):
    """Raw (unweighted by the robust loss) residuals of every factor type."""
    inv_dt = 1.0 / cfg.dt
    ld = params.ld
    ui_tot, uj_tot, shift_i, shift_j, s_i, s_j = _segments(img, ld, inv_dt,
                                                           cfg.KW)
    q4i = spline.gather_local(params.knots_q, s_i)
    p4i = spline.gather_local(params.knots_p, s_i)
    q4j = spline.gather_local(params.knots_q, s_j)
    p4j = spline.gather_local(params.knots_p, s_j)
    dinv = params.dinv[img.lm_idx]
    r_img = F.reproj_residual(q4i, p4i, ui_tot - shift_i, q4j, p4j,
                              uj_tot - shift_j, inv_dt, img.pt_i, img.pt_j,
                              dinv, ext, sqrt_info_img)
    s = torch.clamp(imu.i0, 0, cfg.KW - 4)
    q4 = spline.gather_local(params.knots_q, s)
    p4 = spline.gather_local(params.knots_p, s)
    r_m = F.imu_residual(q4, p4, imu.u, inv_dt, params.bg[imu.bias_idx],
                         params.ba[imu.bias_idx], imu.gyro, imu.accel,
                         gravity, imu_info)
    rb = F.bias_residual(params.bg[:-1], params.bg[1:], params.ba[:-1],
                         params.ba[1:], bias.sqrt_info)
    dx = boxminus_full(params, prior.knots_q0, prior.knots_p0, prior.bg0,
                       prior.ba0, prior.ld0, cfg)
    r_prior = prior.r0 + prior.J @ dx
    return r_img, r_m, rb, r_prior


def residual_rms(params: WindowParams, img: ImageFactors, imu: ImuFactors,
                 bias: BiasFactors, prior: PriorFactor, ext, gravity,
                 imu_info, sqrt_info_img, cfg: WindowConfig,
                 opts: SolveOptions):
    """Per-factor-type raw residual RMS: (4,) [image, imu, bias, prior]."""
    dtype = params.knots_p.dtype
    r_img, r_m, rb, r_prior = _residuals(params, img, imu, bias, prior, ext,
                                         gravity, imu_info, sqrt_info_img, cfg)
    m_img = img.valid.to(dtype)
    rms_img = torch.sqrt(torch.sum(r_img * r_img * m_img[:, None])
                         / torch.clamp(2.0 * torch.sum(m_img), min=1.0))
    m_imu = imu.valid.to(dtype)
    rms_imu = torch.sqrt(torch.sum(r_m * r_m * m_imu[:, None])
                         / torch.clamp(6.0 * torch.sum(m_imu), min=1.0))
    m_b = bias.valid.to(dtype)
    rms_bias = torch.sqrt(torch.sum(rb * rb * m_b[:, None])
                          / torch.clamp(6.0 * torch.sum(m_b), min=1.0))
    n_prior = torch.sum((torch.sum(prior.J * prior.J, dim=1) > 0).to(dtype))
    rms_prior = torch.sqrt(torch.sum(r_prior * r_prior)
                           / torch.clamp(n_prior, min=1.0))
    return torch.stack([rms_img, rms_imu, rms_bias, rms_prior])


def total_cost(params: WindowParams, img: ImageFactors, imu: ImuFactors,
               bias: BiasFactors, prior: PriorFactor, ext, gravity, imu_info,
               sqrt_info_img, cfg: WindowConfig, opts: SolveOptions):
    """Residual-only robust cost."""
    dtype = params.knots_p.dtype
    r_img, r_m, rb, r_prior = _residuals(params, img, imu, bias, prior, ext,
                                         gravity, imu_info, sqrt_info_img, cfg)
    _, cost_img = _cauchy_weight_and_cost(torch.sum(r_img * r_img, dim=-1),
                                          opts.cauchy_c)
    cost = 0.5 * torch.sum(cost_img * img.valid.to(dtype))
    cost = cost + 0.5 * torch.sum((r_m * imu.valid.to(dtype)[:, None]) ** 2)
    cost = cost + 0.5 * torch.sum((rb * bias.valid.to(dtype)[:, None]) ** 2)
    return cost + 0.5 * torch.sum(r_prior * r_prior)
