"""Continuous-time marginalization: build the linearized prior (PyTorch port
of `ctrlvio_tpu/solver/marginalize.py`).

1. linearize the marg factor subset (old image factors with their inverse
   depths, IMU factors before ts[1], the first bias factor, the previous
   prior) at the current estimate (`assemble.linearize(marg_mode=True)`);
2. eliminate the diagonal landmark block analytically, then the dropped
   knot/bias coordinates (normal-equation form, `build_prior`), or
   eliminate both by one Q-less Householder QR of the stacked square-root
   rows (`build_prior_sqrt`, kernel K6 on the card:
   `ops/qr_prior.py`);
3. keep the square root of the remaining system as J and r0, linearized at
   the current values.

The dropped set is a boolean mask over coordinates, so a window slide is a
column roll (`roll_prior`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import assemble
from .layout import (BiasFactors, ImageFactors, ImuFactors, PriorFactor,
                     SolveOptions, WindowConfig, WindowParams)
from .lm import cholesky_nan
from ctrlvio_tpu_torch.ops import qr_prior

EIG_REL_EPS = {torch.float32: 1e-6, torch.float64: 1e-12}


def _eig_thresh(S):
    """Relative eigenvalue truncation threshold."""
    rel = EIG_REL_EPS.get(S.dtype, 1e-6)
    return torch.clamp(torch.max(S), min=0.0) * rel + 1e-30


def drop_mask(cfg: WindowConfig, drop_knots, drop_bias0: bool):
    """(C+LM,) bool mask of dropped coordinates (knots leaving the window,
    optionally the first bias, and every landmark)."""
    dev = drop_knots.device
    km = drop_knots[:, None].expand(-1, 3).reshape(-1)
    bias_m = torch.zeros((3 * cfg.NB,), dtype=torch.bool, device=dev)
    bias_m[:3] = drop_bias0
    ld_m = torch.zeros((1,), dtype=torch.bool, device=dev)
    c_mask = torch.cat([km, km, bias_m, bias_m, ld_m])
    return torch.cat([c_mask, torch.ones((cfg.LM,), dtype=torch.bool,
                                         device=dev)])


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def build_prior(params: WindowParams, img: ImageFactors, imu: ImuFactors,
                bias: BiasFactors, old_prior: PriorFactor, drop_knots,
                ext, gravity, imu_info, sqrt_info_img,
                cfg: WindowConfig, opts: SolveOptions,
                knot_shift: Optional[int] = None,
                bias_shift: Optional[int] = None) -> PriorFactor:
    """Construct the new prior after a MARGIN_OLD solve (normal-equation
    form). With knot_shift/bias_shift the prior comes out in the
    post-slide window layout."""
    dtype, dev = params.knots_p.dtype, params.knots_p.device
    C, LM = cfg.C, cfg.LM

    lin = assemble.linearize(params, img, imu, bias, old_prior, ext, gravity,
                             imu_info, sqrt_info_img, cfg, opts, marg_mode=True)
    J = lin.J
    H_cc = J.T @ J
    g_c = J.T @ lin.r
    Jl = lin.J_lm
    h_ll = torch.zeros((LM,), dtype=dtype, device=dev).index_add(
        0, lin.lm_idx, torch.sum(Jl * Jl, -1))
    r_img = lin.r[: 2 * cfg.OBS].reshape(cfg.OBS, 2)
    g_l = torch.zeros((LM,), dtype=dtype, device=dev).index_add(
        0, lin.lm_idx, torch.sum(Jl * r_img, -1))
    J_rows = J[: 2 * cfg.OBS].reshape(cfg.OBS, 2, C)
    W = torch.einsum("oc,ock->ok", Jl, J_rows)
    H_cl = torch.zeros((LM, C), dtype=dtype, device=dev).index_add(
        0, lin.lm_idx, W)

    # [1] diagonal landmark block: truncated pseudo-inverse
    thr = _eig_thresh(h_ll)
    inv_hll = torch.where(h_ll > thr, 1.0 / torch.maximum(h_ll, thr),
                          torch.zeros_like(h_ll))
    H1 = H_cc - H_cl.T @ (H_cl * inv_hll[:, None])
    g1 = g_c - H_cl.T @ (inv_hll * g_l)
    H1 = 0.5 * (H1 + H1.T)

    # [2] Schur-eliminate the dropped window coords (masked, Jacobi-scaled
    # Cholesky)
    d = drop_mask(cfg, drop_knots, True)[:C].to(dtype)
    k = 1.0 - d
    s = 1.0 / torch.sqrt(torch.clamp(torch.abs(torch.diagonal(H1)), min=1e-8))
    eps = 1e-7 if dtype == torch.float32 else 1e-10
    Hs = H1 * s[:, None] * s[None, :]
    Hs_dd = Hs * d[:, None] * d[None, :]
    Hs_dd = 0.5 * (Hs_dd + Hs_dd.T) + torch.diag(eps * d + (1.0 - d))
    Ld = cholesky_nan(Hs_dd)
    eye = torch.eye(C, dtype=dtype, device=dev)
    Ld_inv = _solve_lower(Ld, eye)
    Hs_dd_inv = (Ld_inv.T @ Ld_inv) * d[:, None] * d[None, :]
    H_dd_inv = Hs_dd_inv * s[:, None] * s[None, :]

    H_kd = H1 * k[:, None] * d[None, :]
    H_sc = H1 * k[:, None] * k[None, :] - H_kd @ H_dd_inv @ H_kd.T
    b_sc = g1 * k - H_kd @ (H_dd_inv @ (g1 * d))

    # [3] square root of the kept block: Hs_kk + eps I = L L^T,
    # J = L^T Dinv, L r = D b_sc
    H_sc = 0.5 * (H_sc + H_sc.T)
    Hs_kk = H_sc * s[:, None] * s[None, :]
    Hs_kk = 0.5 * (Hs_kk + Hs_kk.T) + eps * eye
    L2 = cholesky_nan(Hs_kk)
    J_lin = L2.T * (1.0 / s)[None, :]
    r_lin = _solve_lower(L2, (s * b_sc)[:, None])[:, 0]

    out = PriorFactor(J=J_lin, r0=r_lin, knots_q0=params.knots_q,
                      knots_p0=params.knots_p, bg0=params.bg, ba0=params.ba,
                      ld0=params.ld)
    if knot_shift is not None:
        out = roll_prior(out, knot_shift, bias_shift, cfg)
    return out


def marg_caps(cfg: WindowConfig, obs: Optional[int] = None,
              imu: Optional[int] = None,
              lm: Optional[int] = None) -> Tuple[int, int, int]:
    """Static capacity of the compacted marginalization subset (obs rows,
    IMU rows, landmark columns); None takes the default (384, 128, 128),
    capped by the window's own sizes."""
    return (obs or min(cfg.OBS, 384), imu or min(cfg.MIMU, 128),
            lm or min(cfg.LM, 128))


def _stable_front(mask, n: int):
    """Indices of the True entries first (stable), then the rest; first n."""
    return torch.argsort((~mask).to(torch.int32), stable=True)[:n]


def build_prior_sqrt(params: WindowParams, img: ImageFactors, imu: ImuFactors,
                     bias: BiasFactors, old_prior: PriorFactor, drop_knots,
                     ext, gravity, imu_info, sqrt_info_img,
                     cfg: WindowConfig, opts: SolveOptions,
                     knot_shift: Optional[int] = None,
                     bias_shift: Optional[int] = None,
                     return_overflow: bool = False,
                     caps: Optional[Tuple[int, int, int]] = None,
                     n_drop_knots: Optional[int] = None):
    """Square-root (QR) marginalization: the marg-subset factor rows, the
    landmark columns and the old prior's rows as one tall [A | b] over
    columns [landmarks | dropped coords | kept coords], each scaled to unit
    norm, with eps rows; one Q-less Householder QR eliminates landmarks and
    dropped coords by orthogonal transforms only (`ops/qr_prior.py`: K6 on
    the card, from the rows as `linearize` gives them; the plain version
    on the CPU). Takes the full (uncompacted) factor arrays; `caps`
    overrides `marg_caps(cfg)`. `n_drop_knots` is the number of True
    entries of `drop_knots` (a python int, or a device tensor, one per lane
    of a batch; None counts them on the device); `knot_shift` and
    `bias_shift` likewise take ints or tensors (`roll_prior`)."""
    dtype, dev = params.knots_p.dtype, params.knots_p.device
    C, LM = cfg.C, cfg.LM
    MOBS, MMIMU, MLM = caps if caps is not None else marg_caps(cfg)

    m_img = img.valid & img.marg_drop
    m_imu = imu.valid & imu.marg_drop
    n_img = torch.sum(m_img.to(torch.int64))
    n_imu = torch.sum(m_imu.to(torch.int64))
    ord_i = _stable_front(m_img, MOBS)
    ord_m = _stable_front(m_imu, MMIMU)
    img_c = ImageFactors(*(f[ord_i] for f in img))
    imu_c = ImuFactors(*(f[ord_m] for f in imu))
    cfg_m = cfg._replace(OBS=MOBS, MIMU=MMIMU)

    lin = assemble.linearize(params, img_c, imu_c, bias, old_prior, ext,
                             gravity, imu_info, sqrt_info_img, cfg_m, opts,
                             marg_mode=True)
    R = lin.J.shape[0]

    # landmark column compaction: slots with active marg rows, front-packed
    act = img_c.valid & img_c.marg_drop
    cnt = torch.zeros((LM,), dtype=torch.int64, device=dev).index_add(
        0, img_c.lm_idx, act.to(torch.int64))
    has = cnt > 0
    n_lm = torch.sum(has.to(torch.int64))
    perm_lm = _stable_front(has, MLM)
    # out-of-place scatters (a batched index cannot write into a fresh
    # unbatched tensor under torch.func.vmap)
    rank = torch.zeros((LM,), dtype=torch.int64, device=dev).scatter(
        0, perm_lm, torch.arange(MLM, device=dev))
    new_idx = rank[lin.lm_idx]

    # an active row whose landmark did not win a compact slot is dropped
    sel = torch.zeros((LM,), dtype=torch.bool, device=dev).scatter(
        0, perm_lm, has[perm_lm])
    won = sel[img_c.lm_idx]
    row_ok = ((~act) | won).to(dtype)

    overflow = torch.stack([torch.clamp(n_img - MOBS, min=0),
                            torch.clamp(n_imu - MMIMU, min=0),
                            torch.clamp(n_lm - MLM, min=0)])

    # column scaling (exact: scaling a variable commutes with marginalizing)
    row_mask = torch.cat([row_ok[:, None].expand(-1, 2).reshape(-1),
                          torch.ones((R - 2 * MOBS,), dtype=dtype,
                                     device=dev)])
    cs_c = torch.linalg.vector_norm(lin.J * row_mask[:, None], dim=0)
    cs_c = torch.where(cs_c > 1e-12, cs_c, torch.ones_like(cs_c))

    drop_c = drop_mask(cfg, drop_knots, True)[:C]
    order = _stable_front(drop_c, C)

    if n_drop_knots is None:
        n_drop_knots = torch.sum(drop_knots.to(torch.int64))
    # eps rows eps*I under every column give each a private pivot axis
    # (rank-deficiency guard for the unpivoted Householder QR); the
    # dropped coordinates, 6 per knot (rotation, position) and the first
    # keyframe's 6 bias coordinates, lead the window columns, and the
    # prior keeps R's rows after them
    eps = 3e-4 if dtype == torch.float32 else 1e-7
    live_bias = bias.valid & (torch.arange(cfg.NB - 1, device=dev) == 0)
    J_out, r_out = qr_prior.qr_prior_r(
        lin.J, lin.r, lin.J_lm, new_idx, act & won,
        imu_c.valid & imu_c.marg_drop, live_bias, cs_c, order,
        6 * n_drop_knots + 6, MLM, eps)

    out = PriorFactor(J=J_out, r0=r_out, knots_q0=params.knots_q,
                      knots_p0=params.knots_p, bg0=params.bg, ba0=params.ba,
                      ld0=params.ld)
    if knot_shift is not None:
        out = roll_prior(out, knot_shift, bias_shift, cfg)
    if return_overflow:
        return out, overflow
    return out


def roll_prior(prior: PriorFactor, knot_shift, bias_shift,
               cfg: WindowConfig) -> PriorFactor:
    """Shift the prior's columns and linearization point when the window
    slides: knots advance by `knot_shift`, keyframe biases by `bias_shift`;
    zero fill beyond the window edge. The shifts are python ints or device
    tensors (one per lane under torch.func.vmap): every block is one gather
    at clamped indices and a mask, so nothing is read back."""
    KW, NB = cfg.KW, cfg.NB
    dtype, dev = prior.J.dtype, prior.J.device

    def shifted(n, shift):
        """Source index of each of n slots after a roll by `shift`, clamped,
        and whether it lies inside."""
        idx = torch.arange(n, device=dev) + shift
        return torch.clamp(idx, max=n - 1), idx < n

    # column sources of the whole (C,) layout: the knot and bias blocks
    # roll by their own shifts, the line delay stays
    blocks = [shifted(3 * KW, 3 * knot_shift), shifted(3 * KW, 3 * knot_shift),
              shifted(3 * NB, 3 * bias_shift), shifted(3 * NB, 3 * bias_shift),
              shifted(1, 0)]
    starts = [0, 3 * KW, 6 * KW, 6 * KW + 3 * NB, 6 * KW + 6 * NB]
    src = torch.cat([i + s for (i, _), s in zip(blocks, starts)])
    inside = torch.cat([ok for _, ok in blocks])
    J = torch.where(inside[None, :], prior.J[:, src],
                    torch.zeros((), dtype=dtype, device=dev))

    def roll_rows(a, shift, fill):
        idx, ok = shifted(a.shape[0], shift)
        return torch.where(ok[:, None], a[idx], fill)

    # made on the device: a python number written into one element of a
    # CUDA tensor is copied from the host and synchronizes
    ident = torch.eye(1, 4, dtype=dtype, device=dev)[0]
    zero = torch.zeros((), dtype=dtype, device=dev)
    return PriorFactor(
        J=J, r0=prior.r0,
        knots_q0=roll_rows(prior.knots_q0, knot_shift, ident),
        knots_p0=roll_rows(prior.knots_p0, knot_shift, zero),
        bg0=roll_rows(prior.bg0, bias_shift, zero),
        ba0=roll_rows(prior.ba0, bias_shift, zero),
        ld0=prior.ld0,
    )
