"""Levenberg–Marquardt with analytic Schur elimination of landmarks (PyTorch
port of `ctrlvio_tpu/solver/lm.py`).

Per iteration: normal equations (camera system H (C,C), diagonal landmark
block, coupling H_cl) -> damped Schur-complement solve (Jacobi-scaled
Cholesky, or fixed-count block-Jacobi PCG) -> landmark back-substitution
-> robust-cost accept/reject with the lambda schedule. Two loops share
that iteration body:

- `solve_window` stops at `opts.max_iters` or at the first accepted step
  whose relative cost decrease is below `opts.tol`, reading the device
  twice an iteration to decide;
- `solve_window_fixed` always issues `opts.max_iters` iterations and never
  reads the device: a device flag `done` (set by the same rule) freezes
  every piece of state, so its result equals the other's. The streaming
  megastep uses it, as the JAX package's megastep uses a device-side
  while loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import assemble
from .layout import (BiasFactors, ImageFactors, ImuFactors, PriorFactor,
                     SolveOptions, WindowConfig, WindowParams, boxminus_full,
                     column_mask, retract)


class SolveStats(NamedTuple):
    cost0: torch.Tensor
    cost: torch.Tensor
    lm_lambda: torch.Tensor
    accepted: torch.Tensor  # number of accepted steps


def cholesky_nan(A):
    """Lower Cholesky factor; NaN-filled where the factorization fails
    (LAPACK's behaviour under JAX, which the LM accept test relies on)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def build_normal_equations(lin: assemble.Linearization, cfg: WindowConfig,
                           col_mask):
    """H, g for the camera system + diagonal landmark system + coupling.
    Returns (H (C,C), g (C,), H_ll (LM,), g_l (LM,), H_cl (LM, C))."""
    dtype, dev = lin.J.dtype, lin.J.device
    J = lin.J * col_mask[None, :]
    H = J.T @ J
    g = J.T @ lin.r
    Jl = lin.J_lm
    h_ll = torch.zeros((cfg.LM,), dtype=dtype, device=dev).index_add(
        0, lin.lm_idx, torch.sum(Jl * Jl, dim=-1))
    r_img = lin.r[: 2 * cfg.OBS].reshape(cfg.OBS, 2)
    g_l = torch.zeros((cfg.LM,), dtype=dtype, device=dev).index_add(
        0, lin.lm_idx, torch.sum(Jl * r_img, dim=-1))
    J_rows = J[: 2 * cfg.OBS].reshape(cfg.OBS, 2, cfg.C)
    W = torch.einsum("oc,ock->ok", Jl, J_rows)
    H_cl = torch.zeros((cfg.LM, cfg.C), dtype=dtype, device=dev).index_add(
        0, lin.lm_idx, W)
    return H, g, h_ll, g_l, H_cl


def _block_jacobi_inverse(H_n, nb3: int):
    """Inverses of the (nb3, 3, 3) diagonal blocks of H_n's leading
    3*nb3 coordinates, by the adjugate; identity where |det| <= 1e-12."""
    Hb = H_n[: 3 * nb3, : 3 * nb3].reshape(nb3, 3, nb3, 3)
    blk = torch.diagonal(Hb, dim1=0, dim2=2).permute(2, 0, 1)   # (nb3, 3, 3)
    cross = torch.linalg.cross
    cof = torch.stack([cross(blk[:, 1], blk[:, 2], dim=-1),
                       cross(blk[:, 2], blk[:, 0], dim=-1),
                       cross(blk[:, 0], blk[:, 1], dim=-1)], dim=2)
    det = torch.einsum("ni,ni->n", blk[:, 0], cof[:, :, 0])
    ok = torch.abs(det) > 1e-12
    det = torch.where(ok, det, torch.ones_like(det))
    eye = torch.eye(3, dtype=blk.dtype, device=blk.device)
    return torch.where(ok[:, None, None], cof / det[:, None, None],
                       eye.expand(nb3, 3, 3))


def _pcg(H_n, b, iters: int):
    """`iters` iterations of conjugate gradients on H_n y = b from y = 0,
    preconditioned by the 3x3 block Jacobi inverse; no host read."""
    nb3 = (H_n.shape[0] - 1) // 3
    inv_blk = _block_jacobi_inverse(H_n, nb3)

    def prec(r):
        zb = torch.einsum("nij,nj->ni", inv_blk, r[: 3 * nb3].reshape(nb3, 3))
        return torch.cat([zb.reshape(-1), r[3 * nb3:]])

    x = torch.zeros_like(b)
    r = b
    z = prec(b)
    p = z
    rz = b @ z
    for _ in range(iters):
        Hp = H_n @ p
        alpha = rz / torch.clamp(p @ Hp, min=1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z = prec(r)
        rz_new = r @ z
        p = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
        rz = rz_new
    return x


def schur_solve(H, g, h_ll, g_l, H_cl, lam, col_mask, dtype_eps=1e-8,
                solver: str = "chol", cg_iters: int = 48):
    """Damped Schur-complement solve. Returns (dx_cam (C,), dx_lm (LM,)).

    solver: "chol", the exact Jacobi-scaled Cholesky solve (a failed
    factorization yields NaNs, which the accept test rejects); or "cg",
    `cg_iters` iterations of block-Jacobi preconditioned conjugate
    gradients on the same scaled system: matrix-vector products only, an
    inexact step that the LM accept test and lambda schedule absorb."""
    if solver not in ("chol", "cg"):
        raise ValueError(f"unknown Schur solver {solver!r}")
    diag = torch.clamp(torch.diagonal(H), 1e-6, 1e32)
    H_d = H + lam * torch.diag(diag)
    H_d = H_d + torch.diag(1.0 - col_mask)
    h_ll_d = h_ll * (1.0 + lam) + dtype_eps

    inv_hll = 1.0 / h_ll_d
    H_sc = H_d - H_cl.T @ (H_cl * inv_hll[:, None])
    g_sc = g - H_cl.T @ (g_l * inv_hll)

    # Jacobi preconditioning (bias information ~1e6 vs knot blocks ~1e2)
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H_sc), min=1e-12))
    H_n = 0.5 * (H_sc * s[:, None] * s[None, :]
                 + H_sc.T * s[None, :] * s[:, None])
    b = -(s * g_sc)
    if solver == "cg":
        dx = s * _pcg(H_n, b, cg_iters)
    else:
        L = cholesky_nan(H_n)
        y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
        dx = s * torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    dx = dx * col_mask
    dx_lm = -(g_l + H_cl @ dx) * inv_hll
    return dx, dx_lm


def _setup(params: WindowParams, img: ImageFactors, imu: ImuFactors,
           bias: BiasFactors, prior: PriorFactor, fixed_knots, ext, gravity,
           imu_info, sqrt_info_img, cfg: WindowConfig, opts: SolveOptions,
           ne_mode: str, chunk: Optional[int], reduce=None):
    """What the iterations share: the column mask, the landmark mask and
    `ne_at(p) -> (normal equations, cost)`.

    reduce: None, or a function that sums a tuple of tensors across the
    ranks holding the other shards of the factors (`parallel/
    sharded_lm.py`); it is applied to the landmark use count and to the
    factors' normal equations and cost before the hoisted prior is added,
    so the prior counts once. Needs ne_mode "chunked"."""
    if ne_mode not in ("chunked", "dense"):
        raise ValueError(f"unknown ne_mode {ne_mode!r}")
    if reduce is not None and ne_mode != "chunked":
        raise ValueError("a reduced solve needs ne_mode 'chunked'")
    dtype, dev = params.knots_p.dtype, params.knots_p.device
    cmask = column_mask(cfg, opts, fixed_knots, dtype)

    lm_used = torch.zeros((cfg.LM,), dtype=torch.int64, device=dev).index_add(
        0, img.lm_idx, img.valid.to(torch.int64))
    if reduce is not None:
        (lm_used,) = reduce((lm_used,))
    lm_mask = (lm_used > 0).to(dtype)

    Pm = prior.J * cmask[None, :]
    H_p = Pm.T @ Pm
    g_p0 = Pm.T @ prior.r0
    A_p = Pm.T @ prior.J

    def ne_at(p):
        if ne_mode == "dense":
            lin = assemble.linearize(p, img, imu, bias, prior, ext, gravity,
                                     imu_info, sqrt_info_img, cfg, opts)
            return build_normal_equations(lin, cfg, cmask), lin.cost
        ne_f = assemble.accumulate_normal_equations(
            p, img, imu, bias, ext, gravity, imu_info, sqrt_info_img, cfg,
            opts, chunk)
        if reduce is not None:
            ne_f = reduce(ne_f)
        H, g, h_ll, g_l, H_cl, cost_f = ne_f
        H = H * cmask[:, None] * cmask[None, :] + H_p
        dx0 = boxminus_full(p, prior.knots_q0, prior.knots_p0, prior.bg0,
                            prior.ba0, prior.ld0, cfg)
        g = g * cmask + g_p0 + A_p @ dx0
        H_cl = H_cl * cmask[None, :]
        r_prior = prior.r0 + prior.J @ dx0
        return (H, g, h_ll, g_l, H_cl), cost_f + 0.5 * torch.sum(r_prior * r_prior)

    return cmask, lm_mask, ne_at


def _trial(p, ne, cost, lam, cmask, lm_mask, ne_at, cfg: WindowConfig,
           opts: SolveOptions):
    """One LM iteration's trial step from p: (trial params, its normal
    equations, its cost, device bool `accept`)."""
    dx, dx_lm = schur_solve(*ne, lam, cmask, solver=opts.solver,
                            cg_iters=opts.cg_iters)
    trial = retract(p, dx, cfg, opts)
    trial = trial._replace(dinv=p.dinv + dx_lm * lm_mask)
    ne_t, cost_t = ne_at(trial)
    accept = (cost_t < cost) & torch.isfinite(cost_t)
    return trial, ne_t, cost_t, accept


def solve_window(params: WindowParams, img: ImageFactors, imu: ImuFactors,
                 bias: BiasFactors, prior: PriorFactor, fixed_knots,
                 ext, gravity, imu_info, sqrt_info_img,
                 cfg: WindowConfig, opts: SolveOptions,
                 ne_mode: str = "chunked", chunk: Optional[int] = None):
    """Run up to `opts.max_iters` LM iterations, leaving the loop on the
    host at the first accepted step with relative decrease below `tol`.

    fixed_knots: (KW,) bool, knots held constant.
    ne_mode: "chunked" (`assemble.accumulate_normal_equations`, `chunk`
    factor slots at a time, the prior's constant Gauss-Newton pieces
    hoisted out of the loop) or "dense" (`assemble.linearize` +
    `build_normal_equations`); the two are algebraically identical.
    Returns (params, SolveStats)."""
    dtype, dev = params.knots_p.dtype, params.knots_p.device
    cmask, lm_mask, ne_at = _setup(params, img, imu, bias, prior, fixed_knots,
                                   ext, gravity, imu_info, sqrt_info_img, cfg,
                                   opts, ne_mode, chunk)
    ne, cost = ne_at(params)
    cost0 = cost
    p = params
    lam = torch.full((), opts.lm_lambda_init, dtype=dtype, device=dev)
    n_acc = 0
    for _ in range(opts.max_iters):
        trial, ne_t, cost_t, accept = _trial(p, ne, cost, lam, cmask, lm_mask,
                                             ne_at, cfg, opts)
        if bool(accept):
            rel_dec = (cost - cost_t) / torch.clamp(cost, min=1e-30)
            p, ne, cost = trial, ne_t, cost_t
            lam = torch.clamp(lam * opts.lm_lambda_down, 1e-10, 1e8)
            n_acc += 1
            if bool(rel_dec < opts.tol):
                break
        else:
            lam = torch.clamp(lam * opts.lm_lambda_up, 1e-10, 1e8)
    return p, SolveStats(cost0=cost0, cost=cost, lm_lambda=lam,
                         accepted=torch.tensor(n_acc, device=dev))


def solve_window_fixed(params: WindowParams, img: ImageFactors,
                       imu: ImuFactors, bias: BiasFactors, prior: PriorFactor,
                       fixed_knots, ext, gravity, imu_info, sqrt_info_img,
                       cfg: WindowConfig, opts: SolveOptions,
                       ne_mode: str = "chunked",
                       chunk: Optional[int] = None, reduce=None):
    """`solve_window` with no host exit: exactly `opts.max_iters`
    iterations, each selecting params, normal equations, cost, lambda and
    the accepted count by `torch.where` on a device `accept` that is false
    once `done` (an accepted step with relative decrease below `tol`) is
    set. Same result as `solve_window`; nothing is read back. So ranks
    that each hold a shard of the factors issue the same collectives in
    the same order (`reduce`, see `_setup`)."""
    dtype, dev = params.knots_p.dtype, params.knots_p.device
    cmask, lm_mask, ne_at = _setup(params, img, imu, bias, prior, fixed_knots,
                                   ext, gravity, imu_info, sqrt_info_img, cfg,
                                   opts, ne_mode, chunk, reduce)
    ne, cost = ne_at(params)
    cost0 = cost
    p = params
    lam = torch.full((), opts.lm_lambda_init, dtype=dtype, device=dev)
    n_acc = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(opts.max_iters):
        trial, ne_t, cost_t, accept = _trial(p, ne, cost, lam, cmask, lm_mask,
                                             ne_at, cfg, opts)
        accept = accept & ~done
        rel_dec = (cost - cost_t) / torch.clamp(cost, min=1e-30)
        p = type(p)(*(torch.where(accept, b, a) for a, b in zip(p, trial)))
        ne = tuple(torch.where(accept, b, a) for a, b in zip(ne, ne_t))
        cost = torch.where(accept, cost_t, cost)
        lam_next = torch.clamp(torch.where(accept, lam * opts.lm_lambda_down,
                                           lam * opts.lm_lambda_up),
                               1e-10, 1e8)
        lam = torch.where(done, lam, lam_next)
        n_acc = n_acc + accept.to(torch.int64)
        done = done | (accept & (rel_dec < opts.tol))
    return p, SolveStats(cost0=cost0, cost=cost, lm_lambda=lam,
                         accepted=n_acc)
