"""Levenberg–Marquardt with analytic Schur elimination of landmarks (PyTorch
port of `ctrlvio_tpu/solver/lm.py`).

Per iteration: normal equations (camera system H (C,C), diagonal landmark
block, coupling H_cl) -> damped Schur-complement solve (Jacobi-scaled
Cholesky, or fixed-count block-Jacobi PCG) -> landmark back-substitution
-> robust-cost accept/reject with the lambda schedule, which is one
launch of kernel K4 on the card (`ops/lm_kernels.py::accept_step`: every
piece of state selected on a device `accept` that is false once a device
flag `done`, an accepted step with relative cost decrease below
`opts.tol`, is set). Two loops share that iteration body:

- `solve_window` stops at `opts.max_iters` or once `done` is set, reading
  the device once an iteration to decide;
- `solve_window_fixed` never reads the device, so its result equals the
  other's. Its iterations after the first are the body of
  `graphs.run_while`: in a captured program a CUDA-graph WHILE node whose
  condition K4 sets (not done, fewer than `max_iters` iterations), as the
  JAX package's device-side while loop runs; run eagerly (and on the CPU)
  all `opts.max_iters` run, the frozen ones changing nothing. Every
  captured solve uses it.

`SolveStats.iters` is the iteration at which `done` was set, or
`max_iters` (≙ the JAX loop's `it` carry at its exit). The normal
equations, the Schur solve, the retraction and the accept step run inside
`torch.profiler.record_function` ranges of those names ("LM accept" for
the last).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from ctrlvio_tpu_torch.ops.lm_kernels import LMState, accept_step
from ctrlvio_tpu_torch.utils import graphs, spans

from . import assemble
from .layout import (BiasFactors, ImageFactors, ImuFactors, PriorFactor,
                     SolveOptions, WindowConfig, WindowParams, boxminus_full,
                     column_mask, retract)


class SolveStats(NamedTuple):
    cost0: torch.Tensor
    cost: torch.Tensor
    lm_lambda: torch.Tensor
    accepted: torch.Tensor  # number of accepted steps
    iters: torch.Tensor     # iterations until done, or max_iters (int64)


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
        with record_function("normal equations"):
            return _ne(p)

    def _ne(p):
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


def _trial(p, ne, lam, cmask, lm_mask, ne_at, cfg: WindowConfig,
           opts: SolveOptions):
    """One LM iteration's trial step from p: (trial params, its normal
    equations, its cost)."""
    with record_function("Schur solve"):
        dx, dx_lm = schur_solve(*ne, lam, cmask, solver=opts.solver,
                                cg_iters=opts.cg_iters)
    with record_function("retract"):
        trial = retract(p, dx, cfg, opts)
        trial = trial._replace(dinv=p.dinv + dx_lm * lm_mask)
    ne_t, cost_t = ne_at(trial)
    return trial, ne_t, cost_t


def _iteration(st: LMState, cmask, lm_mask, ne_at, cfg: WindowConfig,
               opts: SolveOptions, handle=None,
               in_place: bool = False) -> LMState:
    """One LM iteration: the trial, then the accept step (K4 on the card;
    `handle`, `in_place` as `accept_step` takes them)."""
    trial, ne_t, cost_t = _trial(st.p, st.ne, st.lam, cmask, lm_mask, ne_at,
                                 cfg, opts)
    with record_function("LM accept"):
        return accept_step(st, trial, ne_t, cost_t, opts, handle, in_place)


def _start(params, ne_at, opts: SolveOptions) -> LMState:
    """The state before the first iteration."""
    dtype, dev = params.knots_p.dtype, params.knots_p.device
    ne, cost0 = ne_at(params)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return LMState(p=params, ne=ne, cost=cost0,
                   lam=torch.full((), opts.lm_lambda_init, dtype=dtype,
                                  device=dev),
                   n_acc=zero, done=torch.zeros((), dtype=torch.bool,
                                                device=dev),
                   iters=zero)


def _stats(cost0, st: LMState) -> SolveStats:
    return SolveStats(cost0=cost0, cost=st.cost, lm_lambda=st.lam,
                      accepted=st.n_acc, iters=st.iters)


def solve_window(params: WindowParams, img: ImageFactors, imu: ImuFactors,
                 bias: BiasFactors, prior: PriorFactor, fixed_knots,
                 ext, gravity, imu_info, sqrt_info_img,
                 cfg: WindowConfig, opts: SolveOptions,
                 ne_mode: str = "chunked", chunk: Optional[int] = None):
    """Run up to `opts.max_iters` LM iterations, leaving the loop on the
    host once an accepted step's relative decrease is below `tol`.

    fixed_knots: (KW,) bool, knots held constant.
    ne_mode: "chunked" (`assemble.accumulate_normal_equations`, `chunk`
    factor slots at a time, the prior's constant Gauss-Newton pieces
    hoisted out of the loop) or "dense" (`assemble.linearize` +
    `build_normal_equations`); the two are algebraically identical.
    Returns (params, SolveStats)."""
    cmask, lm_mask, ne_at = _setup(params, img, imu, bias, prior, fixed_knots,
                                   ext, gravity, imu_info, sqrt_info_img, cfg,
                                   opts, ne_mode, chunk)
    st = _start(params, ne_at, opts)
    cost0 = st.cost
    for _ in range(opts.max_iters):
        st = _iteration(st, cmask, lm_mask, ne_at, cfg, opts)
        if bool(st.done):
            break
    return st.p, _stats(cost0, st)


def solve_window_fixed(params: WindowParams, img: ImageFactors,
                       imu: ImuFactors, bias: BiasFactors, prior: PriorFactor,
                       fixed_knots, ext, gravity, imu_info, sqrt_info_img,
                       cfg: WindowConfig, opts: SolveOptions,
                       ne_mode: str = "chunked",
                       chunk: Optional[int] = None, reduce=None,
                       exit_node: bool = True, stamps=None):
    """`solve_window` with no host exit. Each iteration's accept step
    selects params, normal equations, cost, lambda and the accepted count
    on a device `accept` that is false once `done` is set. Same result as
    `solve_window`; nothing is read back.

    exit_node: iterations 2..`max_iters` are one `graphs.run_while` body,
    updating the state's tensors (made by the first iteration) in place,
    its accept step (K4) setting the WHILE node's condition: a captured
    program stops once the solve is done, eagerly all run. False runs
    every iteration unconditionally, each making fresh tensors: the form
    `torch.func.vmap` takes (a batched `done` is no scalar condition),
    and the form a reduced solve takes (`reduce`, see `_setup`), so that
    ranks that each hold a shard of the factors make the same collectives
    in the same order whatever the card skips.

    stamps: a `utils.spans.StampRing` (a stamped program's) takes a stamp
    after the first iteration ("lm_first") and one at each trip of the
    WHILE node's body ("trip"); None stamps nothing."""
    cmask, lm_mask, ne_at = _setup(params, img, imu, bias, prior, fixed_knots,
                                   ext, gravity, imu_info, sqrt_info_img, cfg,
                                   opts, ne_mode, chunk, reduce)
    st = _start(params, ne_at, opts)
    cost0 = st.cost
    if not (exit_node and reduce is None) or opts.max_iters < 2:
        for _ in range(opts.max_iters):
            st = _iteration(st, cmask, lm_mask, ne_at, cfg, opts)
        return st.p, _stats(cost0, st)
    handle = graphs.while_handle(params.knots_p.device)
    # fresh tensors: the ones the later iterations update
    st = _iteration(st, cmask, lm_mask, ne_at, cfg, opts, handle)
    spans.stamp(stamps, "lm_first")

    def body(s, h):
        _iteration(s, cmask, lm_mask, ne_at, cfg, opts, h, in_place=True)
        spans.stamp(stamps, "trip")

    graphs.run_while(body, st, opts.max_iters - 1, handle)
    return st.p, _stats(cost0, st)
