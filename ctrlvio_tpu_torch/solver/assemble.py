"""Linearization: packed factors -> dense Jacobian rows over the window
layout, and the normal equations (PyTorch port of
`ctrlvio_tpu/solver/assemble.py`).

Every factor's 4-knot block Jacobians expand into dense rows over the
C-dim camera system by one-hot contractions; H = J^T J is then one matrix
product, and the (diagonal) landmark block stays separate for analytic
Schur elimination. Robust loss: Cauchy with scale c, applied as the
sqrt(rho') rescaling.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd

from ctrlvio_tpu_torch.ops import factors as F
from ctrlvio_tpu_torch.ops import spline
from ctrlvio_tpu_torch.ops.reproj_analytic import reproj_analytic

from .layout import (BiasFactors, ImageFactors, ImuFactors, PriorFactor,
                     SolveOptions, WindowConfig, WindowParams, boxminus_full)


class Linearization(NamedTuple):
    J: torch.Tensor        # (R, C) dense camera-system Jacobian rows
    r: torch.Tensor        # (R,) residuals (robust-weighted)
    J_lm: torch.Tensor     # (OBS, 2) d r_img / d dinv (robust-weighted)
    lm_idx: torch.Tensor   # (OBS,)
    obs_valid: torch.Tensor  # (OBS,)
    cost: torch.Tensor     # robustified total cost (scalar)


def _cauchy_weight_and_cost(r2, c):
    """Per-factor robust weight sqrt(rho'(s)) and cost rho(s), s=||r||^2."""
    b = c * c
    w = 1.0 / torch.sqrt(1.0 + r2 / b)
    cost = b * torch.log1p(r2 / b)
    return w, cost


def _segments(img: ImageFactors, ld, inv_dt, KW: int):
    """Row-shifted grid coordinates with the integer shift frozen at this
    linearization: (shift_i, shift_j, s_i, s_j)."""
    ui_tot = img.f_i + img.row_i * ld * inv_dt
    uj_tot = img.f_j + img.row_j * ld * inv_dt
    shift_i = torch.floor(ui_tot)
    shift_j = torch.floor(uj_tot)
    s_i = torch.clamp(img.i0_i + shift_i.to(img.i0_i.dtype), 0, KW - 4)
    s_j = torch.clamp(img.i0_j + shift_j.to(img.i0_j.dtype), 0, KW - 4)
    return ui_tot, uj_tot, shift_i, shift_j, s_i, s_j


def _image_blocks(params: WindowParams, img: ImageFactors, ext,
                  cfg: WindowConfig, opts: SolveOptions, sqrt_info):
    """Residual + closed-form tangent-block Jacobians of all image factors."""
    inv_dt = 1.0 / cfg.dt
    ld = params.ld
    _, _, shift_i, shift_j, s_i, s_j = _segments(img, ld, inv_dt, cfg.KW)
    q4i = spline.gather_local(params.knots_q, s_i)
    p4i = spline.gather_local(params.knots_p, s_i)
    q4j = spline.gather_local(params.knots_q, s_j)
    p4j = spline.gather_local(params.knots_p, s_j)
    dinv = params.dinv[img.lm_idx]
    r, J_ri, J_pi, J_rj, J_pj, J_d, J_ld = reproj_analytic(
        q4i, p4i, q4j, p4j, dinv, ld, img.f_i, img.f_j, shift_i, shift_j,
        img.row_i, img.row_j, inv_dt, img.pt_i, img.pt_j, ext, sqrt_info)
    return r, J_ri, J_pi, J_rj, J_pj, J_d, J_ld, s_i, s_j


def _imu_blocks(params: WindowParams, imu: ImuFactors, gravity, imu_info,
                cfg: WindowConfig):
    """Residual + forward-mode tangent-block Jacobians of all IMU factors."""
    inv_dt = 1.0 / cfg.dt
    s = torch.clamp(imu.i0, 0, cfg.KW - 4)
    q4 = spline.gather_local(params.knots_q, s)
    p4 = spline.gather_local(params.knots_p, s)
    bg = params.bg[imu.bias_idx]
    ba = params.ba[imu.bias_idx]
    dt, dev = p4.dtype, p4.device
    n = q4.shape[0]
    z43 = torch.zeros((4, 3), dtype=dt, device=dev)
    z3 = torch.zeros((3,), dtype=dt, device=dev)

    # one perturbation shared by every factor: factor k depends on its own
    # inputs only, so d r_k / d(shared) is its own tangent block, and one
    # batched jacfwd gives the (n, 6, ...) blocks of all factors at once
    def f(xi_r, xi_p, d_bg, d_ba):
        r = F.imu_residual_tangent(
            xi_r.expand(n, 4, 3), xi_p.expand(n, 4, 3), d_bg.expand(n, 3),
            d_ba.expand(n, 3), q4, p4, imu.u, inv_dt, bg, ba, imu.gyro,
            imu.accel, gravity, imu_info)
        return r, r

    (J_r, J_p, J_bg, J_ba), r = jacfwd(f, argnums=(0, 1, 2, 3),
                                       has_aux=True)(z43, z43, z3, z3)
    return r, J_r, J_p, J_bg, J_ba, s


def _knot_onehot(s, KW: int, dtype):
    """(N, 4, KW): one-hot of knot indices s..s+3."""
    kw = torch.arange(KW, device=s.device)
    four = torch.arange(4, device=s.device)
    return (kw[None, None, :] == (s[:, None, None] + four[None, :, None])).to(dtype)


def _expand_knots(Jr, Jp, oh, KW: int):
    """Jr/Jp: (N, rdim, 4, 3); oh: (N, 4, KW) -> two (N, rdim, 3*KW)."""
    rot = torch.einsum("nrkd,nkw->nrwd", Jr, oh).reshape(Jr.shape[0], -1, 3 * KW)
    pos = torch.einsum("nrkd,nkw->nrwd", Jp, oh).reshape(Jp.shape[0], -1, 3 * KW)
    return rot, pos


def _image_rows(J_ri, J_pi, J_rj, J_pj, J_ld, s_i, s_j, w, cfg: WindowConfig):
    """(Q, 2, C) dense robust-weighted image rows."""
    KW, NB = cfg.KW, cfg.NB
    dtype = J_ri.dtype
    rot_i, pos_i = _expand_knots(J_ri, J_pi, _knot_onehot(s_i, KW, dtype), KW)
    rot_j, pos_j = _expand_knots(J_rj, J_pj, _knot_onehot(s_j, KW, dtype), KW)
    w2 = w[:, None, None]
    zeros = torch.zeros((w.shape[0], 2, 6 * NB), dtype=dtype, device=w.device)
    return torch.cat([(rot_i + rot_j) * w2, (pos_i + pos_j) * w2, zeros,
                      (J_ld * w[:, None])[..., None]], dim=2)


def _imu_rows(J_mr, J_mp, J_mbg, J_mba, s_m, bias_idx, m, cfg: WindowConfig):
    """(M, 6, C) dense masked IMU rows."""
    KW, NB = cfg.KW, cfg.NB
    dtype = J_mr.dtype
    n = J_mr.shape[0]
    rot_m, pos_m = _expand_knots(J_mr, J_mp, _knot_onehot(s_m, KW, dtype), KW)
    nb = torch.arange(NB, device=bias_idx.device)
    oh_bias = (nb[None, :] == bias_idx[:, None]).to(dtype)  # (M, NB)
    bg_m = torch.einsum("nrd,nb->nrbd", J_mbg, oh_bias).reshape(n, 6, 3 * NB)
    ba_m = torch.einsum("nrd,nb->nrbd", J_mba, oh_bias).reshape(n, 6, 3 * NB)
    zeros = torch.zeros((n, 6, 1), dtype=dtype, device=m.device)
    return torch.cat([rot_m, pos_m, bg_m, ba_m, zeros], dim=2) * m[:, None, None]


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

    (r_i, J_ri, J_pi, J_rj, J_pj, J_d, J_ld, s_i, s_j) = _image_blocks(
        params, img, ext, cfg, opts, sqrt_info_img)
    w_img, cost_img = _cauchy_weight_and_cost(torch.sum(r_i * r_i, dim=-1),
                                              cauchy_c)
    m_img = img_active.to(dtype)
    w_img = w_img * m_img
    cost = 0.5 * torch.sum(cost_img * m_img)
    r_img = (r_i * w_img[:, None]).reshape(-1)
    J_lm = J_d * w_img[:, None]

    r_m, J_mr, J_mp, J_mbg, J_mba, s_m = _imu_blocks(params, imu, gravity,
                                                     imu_info, cfg)
    m_imu = imu_active.to(dtype)
    r_imu = (r_m * m_imu[:, None]).reshape(-1)
    cost = cost + 0.5 * torch.sum((r_m * m_imu[:, None]) ** 2)

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

    J_img_rows = _image_rows(J_ri, J_pi, J_rj, J_pj, J_ld, s_i, s_j, w_img, cfg)
    J_imu_rows = _imu_rows(J_mr, J_mp, J_mbg, J_mba, s_m, imu.bias_idx, m_imu,
                           cfg)
    J_bias_rows = _bias_rows(bias.sqrt_info * m_bias[:, None], cfg)
    J = torch.cat([
        J_img_rows.reshape(R_img, C),
        J_imu_rows.reshape(R_imu, C),
        J_bias_rows.reshape(R_bias, C),
        prior.J,
    ], dim=0)
    r = torch.cat([r_img, r_imu, r_bias, r_prior])
    return Linearization(J=J, r=r, J_lm=J_lm, lm_idx=img.lm_idx,
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
        (r_i, J_ri, J_pi, J_rj, J_pj, J_d, J_ld, s_i, s_j) = _image_blocks(
            params, ic, ext, cfg, opts, sqrt_info_img)
        w, cost_i = _cauchy_weight_and_cost(torch.sum(r_i * r_i, -1),
                                            opts.cauchy_c)
        m = ic.valid.to(dtype)
        w = w * m
        cost = cost + 0.5 * torch.sum(cost_i * m)
        rows = _image_rows(J_ri, J_pi, J_rj, J_pj, J_ld, s_i, s_j, w, cfg)
        rw = r_i * w[:, None]
        H = H + torch.einsum("qrc,qrd->cd", rows, rows)
        g = g + torch.einsum("qrc,qr->c", rows, rw)
        Jl = J_d * w[:, None]
        h_ll = h_ll.index_add(0, ic.lm_idx, torch.sum(Jl * Jl, -1))
        g_l = g_l.index_add(0, ic.lm_idx, torch.sum(Jl * rw, -1))
        H_cl = H_cl.index_add(0, ic.lm_idx, torch.einsum("qr,qrc->qc", Jl, rows))

    for mc in _chunks(imu, min(chunk, cfg.MIMU)):
        r_m, J_mr, J_mp, J_mbg, J_mba, s_m = _imu_blocks(
            params, mc, gravity, imu_info, cfg)
        mm = mc.valid.to(dtype)
        cost = cost + 0.5 * torch.sum((r_m * mm[:, None]) ** 2)
        rows = _imu_rows(J_mr, J_mp, J_mbg, J_mba, s_m, mc.bias_idx, mm, cfg)
        rw = r_m * mm[:, None]
        H = H + torch.einsum("qrc,qrd->cd", rows, rows)
        g = g + torch.einsum("qrc,qr->c", rows, rw)

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
