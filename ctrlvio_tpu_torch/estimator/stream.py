"""Device-resident streaming estimator core (PyTorch port of
`ctrlvio_tpu/estimator/stream.py`).

The whole per-frame update — merge uploads → LM solve → 4-DoF gauge →
square-root marginalization → window slide (knot roll, bias roll, landmark
depth handoff) — is one call, `megastep`, chained frame to frame through a
device-resident `DevState`, with no host read inside it:

- the LM loop freezes its state on the device once it has converged, and
  a captured megastep skips the iterations after that
  (`lm.solve_window_fixed`); the batched form runs every iteration;
- the slide branch (marginalize the oldest keyframe or drop the second
  newest) is chosen on the host, which decided it when it packed the frame,
  and the dropped-knot count rides in as a host int; `megastep_branchless`
  instead computes both slides and selects per field on the device from
  the blob's directives, the form that B lanes run as one batched call
  (`parallel/stream_batch.py`);
- the host packs every per-frame input into one flat buffer, moved by one
  copy; the device returns one flat summary, which the host pulls
  asynchronously a few frames later for its numpy mirror.

The marginalization runs on the device in the solver dtype in the QR
square-root form (`solver/marginalize.py::build_prior_sqrt`). The prior,
the window roll and the summary's residual RMS run inside
`torch.profiler.record_function` ranges ("QR prior", "slide", "residual
summary"), which a profiler sees only where the megastep runs eagerly; a
stamped megastep (`stamps`) writes its phases' device times itself, on
every replay (`utils/spans.py`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ctrlvio_tpu_torch.ops import so3, spline
from ctrlvio_tpu_torch.solver import assemble, gauge, lm, marginalize
from ctrlvio_tpu_torch.solver.layout import (BiasFactors, ImageFactors,
                                             ImuFactors, PriorFactor,
                                             SolveOptions, WindowConfig,
                                             WindowParams)
from ctrlvio_tpu_torch.utils import spans
from ctrlvio_tpu_torch.utils.precision import pin_f32_matmuls

INIT_DEPTH = 5.0  # ≙ parameters.cpp INIT_DEPTH (see features.py)


class DevState(NamedTuple):
    """Device-resident estimator state chained between megasteps."""

    params: WindowParams
    prior: PriorFactor


class StreamScalars(NamedTuple):
    """Per-frame slide directives (float-encoded in the upload blob)."""

    marg_old: torch.Tensor    # bool: MARGIN_OLD (slide + marginalize)
    knot_shift: torch.Tensor  # int: window roll on MARGIN_OLD
    t0_i0: torch.Tensor       # int grid coords of kf_t[0] (pre-slide) ...
    t0_f: torch.Tensor
    t1_i0: torch.Tensor       # ... and kf_t[1]: camera poses for depth handoff
    t1_f: torch.Tensor
    old_hi: torch.Tensor      # int: window-relative knot count before extend
    new_hi: torch.Tensor      # int: ... and after (n_active)
    host_seeds: torch.Tensor  # bool: knot seeds from the upload (warmup
    #                           handoff) instead of the in-graph dead-reckon


# ---------------------------------------------------------------------------
# blob pack / unpack: one flat buffer a frame, one host-to-device copy
# ---------------------------------------------------------------------------


def pack_stream_blob(img: ImageFactors, imu: ImuFactors, bias: BiasFactors,
                     fixed, seed_q, seed_p, seed_mask, dinv_perm, dinv_seed,
                     drop_knots, marg_old: bool, knot_shift: int,
                     t0_grid, t1_grid, old_hi: int = 0, new_hi: int = 0,
                     host_seeds: bool = True, dtype=np.float32) -> np.ndarray:
    """Host side: concatenate all per-frame inputs (numpy) into one flat
    buffer. Integers are float-encoded (all values << 2^24, exact in f32)."""
    parts = []
    for t in (img, imu, bias):
        for f in t:
            parts.append(np.asarray(f, dtype).ravel())
    parts.append(np.asarray(fixed, dtype))
    parts.append(np.asarray(seed_q, dtype).ravel())
    parts.append(np.asarray(seed_p, dtype).ravel())
    parts.append(np.asarray(seed_mask, dtype))
    parts.append(np.asarray(dinv_perm, dtype))
    parts.append(np.asarray(dinv_seed, dtype))
    parts.append(np.asarray(drop_knots, dtype))
    parts.append(np.asarray(
        [1.0 if marg_old else 0.0, knot_shift,
         t0_grid[0], t0_grid[1], t1_grid[0], t1_grid[1],
         old_hi, new_hi, 1.0 if host_seeds else 0.0], dtype))
    return np.concatenate(parts)


def unpack_stream_blob(blob: torch.Tensor, cfg: WindowConfig, dtype):
    """Inverse of pack_stream_blob on the device: views of one tensor at
    static offsets (integer and boolean fields converted)."""
    OBS, M, NB, KW, LM = cfg.OBS, cfg.MIMU, cfg.NB, cfg.KW, cfg.LM
    o = [0]

    def take(shape, dt=None):
        n = int(np.prod(shape))
        x = blob[o[0] : o[0] + n].reshape(shape)
        o[0] += n
        if dt is torch.bool:
            return x != 0
        return x if dt is None else x.to(dt)

    i64, b = torch.int64, torch.bool
    img = ImageFactors(
        i0_i=take((OBS,), i64), f_i=take((OBS,)), row_i=take((OBS,)),
        pt_i=take((OBS, 3)), i0_j=take((OBS,), i64), f_j=take((OBS,)),
        row_j=take((OBS,)), pt_j=take((OBS, 3)),
        lm_idx=take((OBS,), i64), valid=take((OBS,), b),
        marg_drop=take((OBS,), b))
    imu = ImuFactors(
        i0=take((M,), i64), u=take((M,)), gyro=take((M, 3)),
        accel=take((M, 3)), bias_idx=take((M,), i64),
        valid=take((M,), b), marg_drop=take((M,), b))
    bias = BiasFactors(sqrt_info=take((NB - 1, 6)),
                       valid=take((NB - 1,), b))
    fixed = take((KW,), b)
    seed_q = take((KW, 4), dtype)
    seed_p = take((KW, 3), dtype)
    seed_mask = take((KW,), b)
    dinv_perm = take((LM,), i64)
    dinv_seed = take((LM,), dtype)
    drop_knots = take((KW,), b)
    s = take((9,))
    sc = StreamScalars(
        marg_old=s[0] > 0.5, knot_shift=s[1].to(i64),
        t0_i0=s[2].to(i64), t0_f=s[3], t1_i0=s[4].to(i64), t1_f=s[5],
        old_hi=s[6].to(i64), new_hi=s[7].to(i64), host_seeds=s[8] > 0.5)
    return img, imu, bias, fixed, seed_q, seed_p, seed_mask, dinv_perm, \
        dinv_seed, drop_knots, sc


# ---------------------------------------------------------------------------
# slide pieces
# ---------------------------------------------------------------------------


def _roll_clamp(a, shift):
    """Roll rows forward by `shift`, repeating the last row at the tail
    (a finite placeholder, overwritten by the next frame's seeds)."""
    n = a.shape[0]
    idx = torch.clamp(torch.arange(n, device=a.device) + shift, 0, n - 1)
    return a[idx]


def _camera_pose_at(p: WindowParams, i0, f, ext, cfg: WindowConfig):
    """Camera pose at grid time (i0, f) from the window spline
    (≙ `Trajectory::GetCameraPose`, global-shutter frame time)."""
    dtype = p.knots_p.dtype
    i0c = torch.clamp(i0, 0, cfg.KW - 4)
    q4 = spline.gather_local(p.knots_q, i0c)
    p4 = spline.gather_local(p.knots_p, i0c)
    qi = spline.so3_eval(q4, f.to(dtype))
    pi = spline.rd_eval(p4, f.to(dtype), 1.0 / cfg.dt, 0)
    qc = so3.quat_mul(qi, ext.q_CtoI)
    pc = pi + so3.quat_rotate(qi, ext.p_CinI)
    return qc, pc


def _depth_handoff(p: WindowParams, img: ImageFactors, sc: StreamScalars,
                   ext, cfg: WindowConfig):
    """Re-anchor inverse depths of landmarks whose anchor frame leaves the
    window (≙ removeBackShiftDepth, `feature_manager.cpp:341-381`).

    The affected landmarks and their anchor observations come from the
    uploaded factors: marg_drop marks exactly the start_frame==0, depth>0
    observations, and their pt_i is the anchor bearing."""
    dtype = p.knots_p.dtype
    m = (img.valid & img.marg_drop).to(dtype)                     # (OBS,)
    oh = ((torch.arange(cfg.LM, device=m.device)[None, :]
           == img.lm_idx[:, None]).to(dtype) * m[:, None])        # (OBS, LM)
    cnt = torch.sum(oh, dim=0)
    pt_old = (oh.T @ img.pt_i) / torch.clamp(cnt, min=1.0)[:, None]

    qc0, pc0 = _camera_pose_at(p, sc.t0_i0, sc.t0_f, ext, cfg)
    qc1, pc1 = _camera_pose_at(p, sc.t1_i0, sc.t1_f, ext, cfg)

    dinv = p.dinv
    pos = dinv > 1e-6
    depth = 1.0 / torch.where(pos, dinv, torch.ones_like(dinv))
    X0 = pt_old * depth[:, None]
    w = so3.quat_rotate(qc0[None], X0) + pc0[None]
    X1 = so3.quat_rotate(so3.quat_conj(qc1)[None], w - pc1[None])
    d_new = torch.where(X1[:, 2] > 0, X1[:, 2],
                        torch.full_like(X1[:, 2], INIT_DEPTH))
    apply = (cnt > 0) & pos
    return torch.where(apply, 1.0 / d_new, dinv)


def _prefix_quat_products(dq):
    """Inclusive prefix products x[i] = dq[0] dq[1] ... dq[i] (Hamilton,
    earlier factor on the left) by a Hillis-Steele scan: log2(n) steps,
    step s computing x[i] = x[i-s] x[i] for i >= s."""
    x = dq
    s = 1
    while s < x.shape[0]:
        x = torch.cat([x[:s], so3.quat_mul(x[:-s], x[s:])], dim=0)
        s *= 2
    return x


def _extend_inertial(params: WindowParams, imu: ImuFactors,
                     sc: StreamScalars, gravity, cfg: WindowConfig):
    """In-graph dead-reckon seeds for knots appended this frame
    (≙ ExtendTrajectory + InitTrajectory): integrate the uploaded IMU
    samples from the device spline's end state and place knot i at the pose
    of t=(i-1)·dt (the cubic B-spline offset). Seeding from the device
    state, not the host mirror, keeps the prediction path lag-free."""
    dtype, dev = params.knots_p.dtype, params.knots_p.device
    dt = cfg.dt
    inv_dt = 1.0 / dt
    KW = cfg.KW

    # anchor well inside the image-constrained region: the last ~3 knots
    # before old_hi are only weakly constrained, so they are re-seeded
    re_lo = torch.clamp(sc.old_hi - 3, min=4)
    i0q = torch.clamp(re_lo - 4, 0, KW - 4)
    q4 = spline.gather_local(params.knots_q, i0q)
    p4 = spline.gather_local(params.knots_p, i0q)
    zero = torch.zeros((), dtype=dtype, device=dev)
    q0 = spline.so3_eval(q4, zero)
    p0 = spline.rd_eval(p4, zero, inv_dt, 0)
    v0 = spline.rd_eval(p4, zero, inv_dt, 1)
    bg = params.bg[cfg.NB - 1]
    ba = params.ba[cfg.NB - 1]

    t0 = i0q.to(dtype) * dt
    t_hi = (sc.new_hi - 3).to(dtype) * dt
    t_m = (imu.i0.to(dtype) + imu.u) * dt                 # (M,) window-rel
    in_rng = imu.valid & (t_m > t0) & (t_m <= t_hi + dt)

    # per-sample step sizes (the in-range samples are contiguous and
    # chronological; the first one is clamped at t0)
    t_prev = torch.cat([t0[None], t_m[:-1]])
    dts = torch.where(in_rng,
                      torch.clamp(t_m - torch.maximum(t_prev, t0), 0.0, 0.05),
                      0.0)

    dq = so3.quat_exp((imu.gyro - bg[None, :]) * dts[:, None])   # (M, 4)
    chain = _prefix_quat_products(dq)
    qs = so3.quat_normalize(so3.quat_mul(q0[None, :], chain))
    q_prev = torch.cat([q0[None, :], qs[:-1]], dim=0)

    a_w = so3.quat_rotate(q_prev, imu.accel - ba[None, :]) - gravity[None, :]
    dv = a_w * dts[:, None]
    vs = v0[None, :] + torch.cumsum(dv, dim=0)
    v_prev = torch.cat([v0[None, :], vs[:-1]], dim=0)
    dp = v_prev * dts[:, None] + 0.5 * a_w * dts[:, None] ** 2
    ps = p0[None, :] + torch.cumsum(dp, dim=0)

    # knot i carries the pose at (i-1)*dt: last in-range sample <= query
    iota = torch.arange(KW, device=dev)
    t_q = (iota - 1).to(dtype) * dt                              # (KW,)
    m_iota = torch.arange(cfg.MIMU, device=dev)
    hit = in_rng[None, :] & (t_m[None, :] <= t_q[:, None] + 1e-9)  # (KW, M)
    idx = torch.max(torch.where(hit, m_iota[None, :], -1), dim=1).values
    found = idx >= 0
    idx = torch.clamp(idx, 0, cfg.MIMU - 1)
    seed_q = torch.where(found[:, None], qs[idx], q0[None, :])
    seed_p = torch.where(found[:, None], ps[idx], p0[None, :])
    return seed_q, seed_p


# ---------------------------------------------------------------------------
# the megastep
# ---------------------------------------------------------------------------


def _merge_solve(state: DevState, blob: torch.Tensor, ext, gravity, imu_info,
                 sqrt_info_img, cfg: WindowConfig, opts: SolveOptions,
                 host_seeds: Optional[bool], ne_mode: str = "chunked",
                 chunk: Optional[int] = None, exit_node: bool = True,
                 stamps=None):
    """Unpack the blob, merge its seeds into the device window state, solve
    (normal equations by `ne_mode` and `chunk`, as `lm.solve_window_fixed`
    takes them) and restore the gauge. `host_seeds` None selects the seeds
    by the blob's own flag on the device (both computed); `exit_node` and
    `stamps` as `lm.solve_window_fixed` takes them ("merged" and "gauge"
    stamped after the merge and the gauge). Returns (the unpacked blob,
    solved params, SolveStats)."""
    dtype = state.params.knots_p.dtype
    unpacked = unpack_stream_blob(blob, cfg, dtype)
    (img, imu, bias, fixed, seed_q, seed_p, seed_mask, dinv_perm, dinv_seed,
     _, sc) = unpacked

    # ---- merge host uploads into the device window state ----------------
    params = state.params
    # new-knot seeds: IMU dead-reckoning from the device spline end
    # (lag-free); the uploaded values only at the warmup handoff, where the
    # host mirror is authoritative
    if host_seeds is None:
        dr_q, dr_p = _extend_inertial(params, imu, sc, gravity, cfg)
        seed_q = torch.where(sc.host_seeds, seed_q, dr_q)
        seed_p = torch.where(sc.host_seeds, seed_p, dr_p)
    elif not host_seeds:
        seed_q, seed_p = _extend_inertial(params, imu, sc, gravity, cfg)
    sm = seed_mask[:, None]
    params = params._replace(
        knots_q=torch.where(sm, seed_q, params.knots_q),
        knots_p=torch.where(sm, seed_p, params.knots_p),
        dinv=torch.where(dinv_perm >= 0,
                         params.dinv[torch.clamp(dinv_perm, 0, cfg.LM - 1)],
                         dinv_seed))
    spans.stamp(stamps, "merged")

    # ---- solve + gauge ---------------------------------------------------
    q_ref = params.knots_q[0]
    p_ref = params.knots_p[0]
    p_out, stats = lm.solve_window_fixed(params, img, imu, bias, state.prior,
                                         fixed, ext, gravity, imu_info,
                                         sqrt_info_img, cfg, opts,
                                         ne_mode=ne_mode, chunk=chunk,
                                         exit_node=exit_node, stamps=stamps)
    q_new, p_new = gauge.restore_gauge(p_out.knots_q, p_out.knots_p,
                                       q_ref, p_ref, 0, 0)
    spans.stamp(stamps, "gauge")
    return unpacked, p_out._replace(knots_q=q_new, knots_p=p_new), stats


def _slide_old(state: DevState, p_out: WindowParams, unpacked, ext, gravity,
               imu_info, sqrt_info_img, cfg: WindowConfig, opts: SolveOptions,
               caps, knot_shift, stamps=None):
    """MARGIN_OLD: the square-root marginalization prior, the depth
    handoff and the window roll by `knot_shift` (int or device tensor),
    `stamps` around the prior ("prior_begin", "prior_end") and after the
    roll ("slide"). Returns (next state, summary depths, overflow
    counts)."""
    img, imu, bias, drop_knots, sc = (unpacked[0], unpacked[1], unpacked[2],
                                      unpacked[9], unpacked[10])
    # the host's marg_drop gates on its lagged depth; a landmark whose
    # device depth has since failed must not enter the prior
    img_m = img._replace(marg_drop=img.marg_drop
                         & (p_out.dinv[img.lm_idx] > 1e-4))
    spans.stamp(stamps, "prior_begin")
    with record_function("QR prior"):
        prior_new, ovf = marginalize.build_prior_sqrt(
            p_out, img_m, imu, bias, state.prior, drop_knots, ext, gravity,
            imu_info, sqrt_info_img, cfg, opts._replace(cauchy_c=1.0),
            knot_shift=knot_shift, bias_shift=1, return_overflow=True,
            caps=caps, n_drop_knots=knot_shift)
    spans.stamp(stamps, "prior_end")
    with record_function("slide"):
        dinv_sum = _depth_handoff(p_out, img, sc, ext, cfg)
        new_params = p_out._replace(
            knots_q=_roll_clamp(p_out.knots_q, knot_shift),
            knots_p=_roll_clamp(p_out.knots_p, knot_shift),
            bg=_roll_clamp(p_out.bg, 1), ba=_roll_clamp(p_out.ba, 1),
            dinv=dinv_sum)
    spans.stamp(stamps, "slide")
    return (DevState(params=new_params, prior=prior_new), dinv_sum,
            ovf.to(p_out.knots_p.dtype))


def _slide_second_new(state: DevState, p_out: WindowParams,
                      cfg: WindowConfig, stamps=None):
    """MARGIN_SECOND_NEW: the newest keyframe's biases replace the second
    newest's; the prior rides through ("slide" stamped after). Same
    returns as `_slide_old`."""
    nb = cfg.NB

    def drop_second_new(b):
        return torch.cat([b[: nb - 2], b[nb - 1:], b[nb - 1:]])

    with record_function("slide"):
        new_params = p_out._replace(bg=drop_second_new(p_out.bg),
                                    ba=drop_second_new(p_out.ba))
        zeros = torch.zeros((3,), dtype=p_out.knots_p.dtype,
                            device=p_out.knots_p.device)
    spans.stamp(stamps, "slide")
    return DevState(params=new_params, prior=state.prior), p_out.dinv, zeros


def _summary(state: DevState, p_out: WindowParams, stats, unpacked, dinv_sum,
             marg_ovf, ext, gravity, imu_info, sqrt_info_img,
             cfg: WindowConfig, opts: SolveOptions):
    """The flat summary: this frame's pre-slide window, post-handoff depths,
    the solve statistics, the per-type residual RMS at the solution
    (≙ the reference's per-solve ResidualSummary), the overflow counts and
    the LM iteration count."""
    dtype = p_out.knots_p.dtype
    img, imu, bias = unpacked[:3]
    with record_function("residual summary"):
        rms4 = assemble.residual_rms(p_out, img, imu, bias, state.prior, ext,
                                     gravity, imu_info, sqrt_info_img, cfg,
                                     opts)
    return torch.cat([
        p_out.knots_q.reshape(-1), p_out.knots_p.reshape(-1),
        p_out.bg.reshape(-1), p_out.ba.reshape(-1),
        dinv_sum.to(dtype), p_out.ld.reshape(1).to(dtype),
        torch.stack([stats.cost0, stats.cost,
                     stats.accepted.to(dtype)]).to(dtype),
        rms4.to(dtype),
        marg_ovf,  # > 0: marg subset overflowed [obs, imu, lm]
        stats.iters.reshape(1).to(dtype),
    ])


def megastep(state: DevState, blob: torch.Tensor, ext, gravity, imu_info,
             sqrt_info_img, cfg: WindowConfig, opts: SolveOptions, *,
             marg_old: bool, host_seeds: bool,
             knot_shift: Optional[int] = None,
             caps: Optional[Tuple[int, int, int]] = None,
             ne_mode: str = "chunked", chunk: Optional[int] = None,
             stamps=None):
    """One frame on the device. Returns (next state, flat summary).

    `marg_old` and `host_seeds` are the host's own copies of the
    directives it packed into `blob`: they choose the branches, so nothing
    is read back and only a MARGIN_OLD frame pays the QR. The window roll
    `knot_shift` is a host int or, by default, the blob's own on the device
    (the same numbers, `roll_prior`): so one captured program a branch
    serves every shift (`CtrlVIO._stream_dispatch`).
    `caps` overrides `marginalize.marg_caps(cfg)`; `ne_mode` and `chunk`
    choose how the solve builds its normal equations (`lm.solve_window`).
    `stamps`, a `utils.spans.StampRing`, stamps the megastep's phases into
    its row ("start" first, "end" after the summary; `spans.TAGS`); None
    stamps nothing.

    Order ≙ the reference per-frame pipeline: solve (`UpdateTrajectory`),
    gauge restore (`double2vector`), marginalization (`UpdateVIOPrior`),
    slide (`SlideWindow{Old,New}`)."""
    pin_f32_matmuls()
    spans.stamp(stamps, "start")
    unpacked, p_out, stats = _merge_solve(state, blob, ext, gravity,
                                          imu_info, sqrt_info_img, cfg, opts,
                                          host_seeds, ne_mode, chunk,
                                          stamps=stamps)
    if marg_old:
        if knot_shift is None:
            knot_shift = unpacked[10].knot_shift
        state2, dinv_sum, marg_ovf = _slide_old(
            state, p_out, unpacked, ext, gravity, imu_info, sqrt_info_img,
            cfg, opts, caps, knot_shift, stamps)
    else:
        state2, dinv_sum, marg_ovf = _slide_second_new(state, p_out, cfg,
                                                       stamps)
    summary = _summary(state, p_out, stats, unpacked, dinv_sum, marg_ovf,
                       ext, gravity, imu_info, sqrt_info_img, cfg, opts)
    spans.stamp(stamps, "end")
    return state2, summary


def _select(cond, a, b):
    """Field by field torch.where(cond, a, b) over nested named tuples."""
    if isinstance(a, tuple):
        vals = [_select(cond, x, y) for x, y in zip(a, b)]
        return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
    return torch.where(cond, a, b)


def megastep_branchless(state: DevState, blob: torch.Tensor, ext, gravity,
                        imu_info, sqrt_info_img, cfg: WindowConfig,
                        opts: SolveOptions,
                        caps: Optional[Tuple[int, int, int]] = None,
                        ne_mode: str = "chunked", chunk: Optional[int] = None):
    """`megastep` with every directive read from the blob's StreamScalars
    on the device (≙ the JAX megastep under `vmap`, where `lax.cond`
    becomes a select): both seed sources and both slides are computed and
    each field is chosen by `torch.where` on `marg_old` / `host_seeds`;
    the knot roll takes `knot_shift` as a tensor. So one call over stacked
    lanes (`torch.func.vmap`, `parallel.stream_batch`) serves lanes whose
    keyframe decisions differ. Every LM iteration runs (no exit node:
    under vmap `done` is a lane vector, no scalar predicate). Same results
    as `megastep`."""
    pin_f32_matmuls()
    unpacked, p_out, stats = _merge_solve(state, blob, ext, gravity,
                                          imu_info, sqrt_info_img, cfg, opts,
                                          None, ne_mode, chunk,
                                          exit_node=False)
    sc = unpacked[10]
    old = _slide_old(state, p_out, unpacked, ext, gravity, imu_info,
                     sqrt_info_img, cfg, opts, caps, sc.knot_shift)
    new = _slide_second_new(state, p_out, cfg)
    state2, dinv_sum, marg_ovf = _select(sc.marg_old, old, new)
    return state2, _summary(state, p_out, stats, unpacked, dinv_sum,
                            marg_ovf, ext, gravity, imu_info, sqrt_info_img,
                            cfg, opts)


def summary_size(cfg: WindowConfig) -> int:
    return 7 * cfg.KW + 6 * cfg.NB + cfg.LM + 12


def unpack_summary(host: np.ndarray, cfg: WindowConfig):
    """Host-side summary split. Returns a dict of numpy views."""
    KW, NB, LM = cfg.KW, cfg.NB, cfg.LM
    o = 0

    def take(n, shape=None):
        nonlocal o
        x = host[o : o + n]
        o += n
        return x.reshape(shape) if shape else x

    return dict(
        knots_q=take(4 * KW, (KW, 4)), knots_p=take(3 * KW, (KW, 3)),
        bg=take(3 * NB, (NB, 3)), ba=take(3 * NB, (NB, 3)),
        dinv=take(LM), ld=float(take(1)[0]), cost0=float(take(1)[0]),
        cost=float(take(1)[0]), accepted=float(take(1)[0]),
        rms=take(4),  # per-type residual RMS [image, imu, bias, prior]
        marg_ovf=take(3),  # marg-cap overflow counts [obs, imu, lm]
        iters=float(take(1)[0]))  # LM iterations until done, or max_iters
