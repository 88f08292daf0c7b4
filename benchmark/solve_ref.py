"""The plain float64 reference of the streamed window solve: plain PyTorch,
nothing of the port.

For a sample of the window's calls, drawn from the seed, the driver keeps
what the port was handed and what it returned (`Record`): the frame's
packed input, which says which keyframes, landmark slots, observation pairs
and IMU samples the window holds; the marginalization prior and the knots
the port held before the call (the port's own state: the reference follows
the port solve by solve from it); and the solved window it returned.

`check` then, for each record:

1. works the measurements out again from the generator's draws: each
   packed observation is looked up by its landmark and frame time, each IMU
   sample by its time, the bias random walk's weights from the sample times
   and the configuration's sigmas; a packed value that is not the
   generator's (to float32 rounding) counts as an input fault;
2. builds the window's cost in float64 from those values: the
   rolling-shutter reprojection pairs through its own cumulative B-spline
   (Cauchy loss), the IMU factors (body rate and specific force of the
   spline), the bias random walk and the prior r0 + J (x [-] x0);
3. seeds the new knots by IMU dead reckoning as the port does, and runs
   the port's Levenberg-Marquardt algorithm on that cost in float64 for
   the port's own number of iterations (Jacobians by central differences,
   landmarks eliminated by their Schur complement, the port's damping and
   lambda schedule), then restores the 4-DoF gauge as the estimator does
   (knot 0 keeps the yaw and position it had before the solve);
4. measures how far the port's solved knots, biases and line delay lie
   from the reference's (`gaps`), and where the call marginalized the
   oldest keyframe, how far the prior it left lies from the reference's
   marginalization at the reference's solution (`prior_gaps`).

A float64 solve to the minimum would not do: the port's LM stops at a
relative decrease of `ba_tol`, tens of um short of the minimum, far more
than its float32 arithmetic moves it. Followed step by step, float32 and
float64 agree to ~0.1 urad, and TF32 matrix products part from them.

The blob's layout (`blob_fields`) and the summary's (`summary_fields`) are
the port's per-frame interface, read here only to find the window's
composition and the answer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# the image factors' Cauchy scale (the port's SolveOptions.cauchy_c, the
# upstream's CauchyLoss on reprojection) and the bias information cap of the
# port's packing (1e4, `bias_sqrt_info`)
CAUCHY_C = 2.0
BIAS_INFO_CAP = 1e4
DINV_FLOOR = 1e-5
Z_FLOOR = 1e-6
# the LM's schedule and the landmark diagonal's floor (the port's
# SolveOptions defaults and its Schur solve)
LAMBDA_INIT, LAMBDA_DOWN, LAMBDA_UP = 1e-4, 0.5, 4.0
LM_EPS = 1e-8
# a landmark enters the marginalization at an inverse depth above this
# (the port's gate on its solved depth)
MARG_DINV_MIN = 1e-4
# central-difference steps: knot rotation (rad) and position (m), biases,
# inverse depth (1/m), line delay (s a row); each difference is accurate
# to ~1e-10 of its derivative in float64
STEP_KNOT, STEP_BIAS, STEP_DINV, STEP_LD = 1e-6, 1e-6, 1e-7, 1e-11
# a packed value is the generator's to float32 rounding
F32_TOL = 4e-7


@dataclass
class Record:
    """One sampled call: the port's input and state before it, and its
    answer (all numpy)."""
    blob: np.ndarray
    prev: dict          # knots_q, knots_p, bg, ba, dinv, ld before the call
    prior: dict         # J, r0, knots_q0, knots_p0, bg0, ba0, ld0
    meta: dict          # win_knot0, n_active, slot_fids, marg_old
    summary: np.ndarray
    after: dict = None  # J, r0 of the prior the call left (marg_old)


def blob_fields(w: dict):
    """(name, shape) of the port's packed frame, in order."""
    OBS, M, NB, KW, LM = w["OBS"], w["MIMU"], w["NB"], w["KW"], w["LM"]
    img = [("i0_i", (OBS,)), ("f_i", (OBS,)), ("row_i", (OBS,)),
           ("pt_i", (OBS, 3)), ("i0_j", (OBS,)), ("f_j", (OBS,)),
           ("row_j", (OBS,)), ("pt_j", (OBS, 3)), ("lm_idx", (OBS,)),
           ("valid", (OBS,)), ("marg_drop", (OBS,))]
    imu = [("m_i0", (M,)), ("m_u", (M,)), ("gyro", (M, 3)),
           ("accel", (M, 3)), ("bias_idx", (M,)), ("m_valid", (M,)),
           ("m_marg_drop", (M,))]
    rest = [("bias_si", (NB - 1, 6)), ("bias_valid", (NB - 1,)),
            ("fixed", (KW,)), ("seed_q", (KW, 4)), ("seed_p", (KW, 3)),
            ("seed_mask", (KW,)), ("dinv_perm", (LM,)), ("dinv_seed", (LM,)),
            ("drop_knots", (KW,)), ("scalars", (9,))]
    return img + imu + rest


def summary_fields(w: dict):
    KW, NB, LM = w["KW"], w["NB"], w["LM"]
    return [("knots_q", (KW, 4)), ("knots_p", (KW, 3)), ("bg", (NB, 3)),
            ("ba", (NB, 3)), ("dinv", (LM,)), ("ld", (1,)),
            ("costs", (3,)), ("rms", (4,)), ("marg_ovf", (3,)),
            ("iters", (1,))]


def split(flat: np.ndarray, fields):
    out, o = {}, 0
    for name, shape in fields:
        n = int(np.prod(shape))
        out[name] = np.asarray(flat[o:o + n], np.float64).reshape(shape)
        o += n
    if o != len(flat):
        raise ValueError(f"layout of {o} values, got {len(flat)}")
    return out


# ---------------------------------------------------------------------------
# rotations and the spline
# ---------------------------------------------------------------------------


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def qmul(a, b):
    aw, av = a[..., :1], a[..., 1:]
    bw, bv = b[..., :1], b[..., 1:]
    return torch.cat([aw * bw - (av * bv).sum(-1, keepdim=True),
                      aw * bv + bw * av + cross(av, bv)], -1)


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def qexp(phi):
    t2 = (phi * phi).sum(-1, keepdim=True)
    small = t2 < 1e-20
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    k = torch.where(small, 0.5 - t2 / 48.0, torch.sin(0.5 * t) / t)
    w = torch.where(small, 1.0 - t2 / 8.0, torch.cos(0.5 * t))
    return torch.cat([w, k * phi], -1)


def qlog(q):
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    v = q[..., 1:]
    n2 = (v * v).sum(-1, keepdim=True)
    small = n2 < 1e-20
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    k = torch.where(small, 2.0 / q[..., :1], 2.0 * torch.atan2(n, q[..., :1])
                    / n)
    return k * v


def qrot(q, v):
    """R(q) v."""
    return qmul(qmul(q, torch.cat([torch.zeros_like(v[..., :1]), v], -1)),
                qconj(q))[..., 1:]


def qrot_inv(q, v):
    return qrot(qconj(q), v)


def rot_pose(q4, u):
    """The cumulative cubic B-spline's rotation at u in [0, 1) from four
    knots (..., 4, 4): q0 * prod_j exp(B~_j(u) log(q_{j-1}^-1 q_j))."""
    u = u[..., None]
    b = [(5 + 3 * u - 3 * u ** 2 + u ** 3) / 6,
         (1 + 3 * u + 3 * u ** 2 - 2 * u ** 3) / 6, u ** 3 / 6]
    q = q4[..., 0, :]
    for j in range(3):
        d = qlog(qmul(qconj(q4[..., j, :]), q4[..., j + 1, :]))
        q = qmul(q, qexp(b[j] * d))
    return q


def pos_basis(u, deriv):
    """The uniform cubic B-spline's four weights, or their second
    derivative in u."""
    u = u[..., None]
    if deriv == 0:
        return torch.cat([(1 - u) ** 3, 3 * u ** 3 - 6 * u ** 2 + 4,
                          -3 * u ** 3 + 3 * u ** 2 + 3 * u + 1, u ** 3],
                         -1) / 6
    return torch.cat([1 - u, 3 * u - 2, 1 - 3 * u, u], -1)


def pos_eval(p4, u, deriv=0):
    return (pos_basis(u, deriv)[..., None] * p4).sum(-2)


def body_rate(q4, u, inv_dt):
    """Body angular velocity of the cumulative spline: each factor's rate
    b~_j'(u) d_j, carried through the factors after it."""
    u = u[..., None]
    b = [(5 + 3 * u - 3 * u ** 2 + u ** 3) / 6,
         (1 + 3 * u + 3 * u ** 2 - 2 * u ** 3) / 6, u ** 3 / 6]
    db = [(3 - 6 * u + 3 * u ** 2) / 6, (3 + 6 * u - 6 * u ** 2) / 6,
          u ** 2 / 2]
    w = torch.zeros_like(q4[..., 0, 1:])
    for j in range(3):
        d = qlog(qmul(qconj(q4[..., j, :]), q4[..., j + 1, :]))
        w = qrot_inv(qexp(b[j] * d), w) + db[j] * d
    return w * inv_dt


# ---------------------------------------------------------------------------
# the factors
# ---------------------------------------------------------------------------


def reproj(q4i, p4i, ui, q4j, p4j, uj, pt_i, pt_j, dinv, ext_q, ext_p,
           w_img):
    qi, pi = rot_pose(q4i, ui), pos_eval(p4i, ui)
    qj, pj = rot_pose(q4j, uj), pos_eval(p4j, uj)
    dinv = torch.where(dinv.abs() < DINV_FLOOR,
                       torch.where(dinv < 0, -DINV_FLOOR, DINV_FLOOR), dinv)
    x_ci = pt_i / dinv[..., None]
    p_w = qrot(qi, qrot(ext_q, x_ci) + ext_p) + pi
    x_j = qrot_inv(ext_q, qrot_inv(qj, p_w - pj) - ext_p)
    z = x_j[..., 2]
    z = torch.where(z.abs() < Z_FLOOR,
                    torch.where(z < 0, -Z_FLOOR, Z_FLOOR), z)
    return w_img * (x_j[..., :2] / z[..., None] - pt_j[..., :2])


def imu_res(q4, p4, u, bg, ba, gyro, accel, gravity, info, inv_dt):
    w = body_rate(q4, u, inv_dt)
    a_w = pos_eval(p4, u, 2) * inv_dt ** 2
    f_b = qrot_inv(rot_pose(q4, u), a_w + gravity)
    return info * torch.cat([w - (gyro - bg), f_b - (accel - ba)], -1)


def perturb(q4, p4, x):
    """Four knots under a right perturbation x (..., 24): 12 rotation,
    then 12 position coordinates."""
    dq = x[..., :12].reshape(x.shape[:-1] + (4, 3))
    dp = x[..., 12:24].reshape(x.shape[:-1] + (4, 3))
    return qmul(q4, qexp(dq)), p4 + dp


def differences(f, steps):
    """f at no perturbation (n, r), and its Jacobian (n, r, k) by central
    differences of the k coordinates at `steps`, every perturbation in one
    batched call of f: f takes e (B, 1, k)."""
    k = len(steps)
    E = torch.cat([torch.zeros((1, k), dtype=steps.dtype,
                               device=steps.device),
                   torch.diag(steps), -torch.diag(steps)])
    y = f(E[:, None, :])
    J = (y[1:k + 1] - y[k + 1:]) / (2 * steps[:, None, None])
    return y[0], J.permute(1, 2, 0)


# ---------------------------------------------------------------------------
# one window
# ---------------------------------------------------------------------------


class Window:
    """The cost of one sampled window, in float64, from the generator's
    values; `faults` counts the packed values that were not the
    generator's."""

    def __init__(self, rec: Record, seq, config: dict, traffic: dict,
                 start_ns: int, device):
        w = config["estimator"]["window"]
        est = config["estimator"]
        self.w, self.dev = w, device
        self.KW, self.NB, self.LM = w["KW"], w["NB"], w["LM"]
        self.C = 6 * self.KW + 6 * self.NB + 1
        dt_ns = int(round(w["dt"] * 1e9))
        self.inv_dt = 1.0 / w["dt"]
        b = split(rec.blob, blob_fields(w))
        k0 = int(rec.meta["win_knot0"])
        self.n_active = int(rec.meta["n_active"])
        self.faults = 0
        f64 = dict(dtype=torch.float64, device=device)

        # ---- image pairs: the generator's points, rows and times
        frames = seq.frames
        t_first = frames[0][0]
        step = frames[1][0] - frames[0][0]
        valid = b["valid"] > 0.5
        slots = rec.meta["slot_fids"]
        rows_i, rows_j, pts_i, pts_j, f_i, f_j, i0_i, i0_j, lm, mg = (
            [] for _ in range(10))
        kf_times = set()
        for n in np.nonzero(valid)[0]:
            ok = True
            vals = []
            for side in ("i", "j"):
                i0 = int(round(b[f"i0_{side}"][n]))
                t_rel = (k0 + i0 + b[f"f_{side}"][n]) * dt_ns
                k = int(round((t_rel + start_ns - t_first) / step))
                t_abs = t_first + k * step if 0 <= k < len(frames) else None
                lid = int(slots[int(b["lm_idx"][n])]) \
                    if int(b["lm_idx"][n]) < len(slots) else -1
                if t_abs is None or abs(t_abs - start_ns - t_rel) > 1000:
                    ok = False
                    break
                _, ids, pts, rws = frames[k]
                at = np.searchsorted(ids, lid)
                if at >= len(ids) or ids[at] != lid:
                    ok = False
                    break
                t_exact = t_abs - start_ns
                i0x = t_exact // dt_ns - k0
                fx = (t_exact - (k0 + i0x) * dt_ns) / dt_ns
                pt = np.array([pts[at, 0], pts[at, 1], 1.0])
                ok &= (i0x == i0 and rws[at] == b[f"row_{side}"][n]
                       and close(b[f"pt_{side}"][n], pt)
                       and abs(fx - b[f"f_{side}"][n]) < 1e-6)
                vals.append((i0x, fx, float(rws[at]), pt))
                kf_times.add(t_exact)
            if not ok:
                self.faults += 1
                continue
            (a, fa, ra, pa), (c, fc, rc, pc) = vals
            i0_i.append(a); f_i.append(fa); rows_i.append(ra); pts_i.append(pa)
            i0_j.append(c); f_j.append(fc); rows_j.append(rc); pts_j.append(pc)
            lm.append(int(b["lm_idx"][n]))
            mg.append(bool(b["marg_drop"][n] > 0.5))
        t = lambda x: torch.tensor(np.array(x), **f64)  # noqa: E731
        ti = lambda x: torch.tensor(np.array(x), dtype=torch.int64,  # noqa
                                    device=device)
        self.img = dict(i0_i=ti(i0_i), f_i=t(f_i), row_i=t(rows_i),
                        pt_i=t(pts_i).reshape(-1, 3), i0_j=ti(i0_j),
                        f_j=t(f_j), row_j=t(rows_j),
                        pt_j=t(pts_j).reshape(-1, 3), lm=ti(lm),
                        marg=torch.tensor(mg, dtype=torch.bool,
                                          device=device))

        # ---- IMU samples: the generator's, every one between the first
        # and the last the window holds
        mv = b["m_valid"] > 0.5
        isteps = int(seq.imu_t_ns[1] - seq.imu_t_ns[0])
        kf = np.array(sorted(kf_times), np.int64)
        if len(kf) != self.NB:
            self.faults += 1
        idx, m_i0, m_u, bidx, mm = [], [], [], [], []
        for n in np.nonzero(mv)[0]:
            i0 = int(round(b["m_i0"][n]))
            t_rel = (k0 + i0 + b["m_u"][n]) * dt_ns
            k = int(round((t_rel + start_ns - int(seq.imu_t_ns[0]))
                          / isteps))
            if not 0 <= k < len(seq.imu_t_ns):
                self.faults += 1
                continue
            t_exact = int(seq.imu_t_ns[k]) - start_ns
            i0x = t_exact // dt_ns - k0
            ux = (t_exact - (k0 + i0x) * dt_ns) / dt_ns
            bi = int(np.clip(np.searchsorted(kf, t_exact, "right") - 1, 0,
                             self.NB - 1))
            if not (abs(t_exact - t_rel) < 1000 and i0x == i0
                    and abs(ux - b["m_u"][n]) < 1e-6
                    and close(b["gyro"][n], seq.gyro[k])
                    and close(b["accel"][n], seq.accel[k])
                    and bi == int(round(b["bias_idx"][n]))):
                self.faults += 1
                continue
            idx.append(k); m_i0.append(i0x); m_u.append(ux); bidx.append(bi)
            mm.append(bool(b["m_marg_drop"][n] > 0.5))
        if idx and (np.diff(np.sort(idx)) != 1).any():
            self.faults += 1  # a sample the window skips
        self.imu = dict(i0=ti(m_i0), u=t(m_u), bidx=ti(bidx),
                        marg=torch.tensor(mm, dtype=torch.bool, device=device),
                        gyro=t(seq.gyro[idx]).reshape(-1, 3),
                        accel=t(seq.accel[idx]).reshape(-1, 3))

        # ---- the bias random walk between consecutive keyframes
        si = np.zeros((self.NB - 1, 6))
        imu_t = seq.imu_t_ns.astype(np.int64) - start_ns
        for i in range(min(len(kf), self.NB) - 1):
            m = (imu_t[1:] < kf[i + 1]) & (imu_t[:-1] >= kf[i])
            s2 = float(np.sum(((imu_t[1:][m] - imu_t[:-1][m]) * 1e-9) ** 2))
            if s2 > 0:
                si[i, :3] = min(1 / math.sqrt(s2 * est["sigma_bg"] ** 2),
                                BIAS_INFO_CAP)
                si[i, 3:] = min(1 / math.sqrt(s2 * est["sigma_ba"] ** 2),
                                BIAS_INFO_CAP)
        if not np.allclose(si, b["bias_si"], rtol=1e-6, atol=0):
            self.faults += 1
        self.bias_si = t(si)

        # ---- constants the configuration states
        rig = config["rig"]
        self.ext_q = qexp(torch.tensor(rig["ext_rot"], **f64))
        self.ext_p = torch.tensor(rig["ext_pos"], **f64)
        self.gravity = torch.tensor([0.0, 0.0, traffic["gravity"]], **f64)
        self.info = torch.tensor([1 / est["sigma_gyro"]] * 3
                                 + [1 / est["sigma_accel"]] * 3, **f64)
        self.w_img = float(est["image_weight"])
        self.ld_box = (est["ld_lower"], est["ld_upper"])
        self.prior = {k: torch.tensor(np.asarray(v, np.float64), **f64)
                      for k, v in rec.prior.items()}
        fixed = torch.tensor(b["fixed"] > 0.5, device=device)
        kn = (~fixed).to(torch.float64).repeat_interleave(3)
        self.cmask = torch.cat([kn, kn, torch.ones(6 * self.NB, **f64),
                                torch.full((1,), 0.0 if est["fix_ld"]
                                           else 1.0, **f64)])
        self.lm_mask = torch.zeros(self.LM, **f64)
        if len(self.img["lm"]):
            self.lm_mask[self.img["lm"]] = 1.0

        # ---- the LM's start, as the port makes it: the knots it held
        # before the call, the ones appended this frame seeded by IMU dead
        # reckoning from its spline's end, its depths carried to this
        # frame's slots
        prev = {k: torch.tensor(np.asarray(v, np.float64), **f64)
                for k, v in rec.prev.items()}
        self.scalars = b["scalars"]
        self.marg_old = b["scalars"][0] > 0.5
        self.knot_shift = int(round(b["scalars"][1]))
        self.drop_knots = torch.tensor(b["drop_knots"] > 0.5, device=device)
        seed_mask = torch.tensor(b["seed_mask"] > 0.5, device=device)
        sq, sp = self.seed(prev)
        perm = b["dinv_perm"].round().astype(np.int64)
        dinv = np.where(perm >= 0, rec.prev["dinv"][np.clip(perm, 0, None)],
                        b["dinv_seed"])
        self.x = dict(q=torch.where(seed_mask[:, None], sq, prev["knots_q"]),
                      p=torch.where(seed_mask[:, None], sp, prev["knots_p"]),
                      bg=prev["bg"], ba=prev["ba"], ld=prev["ld"].reshape(()),
                      d=torch.tensor(dinv, **f64))
        self.q_ref, self.p_ref = self.x["q"][0], self.x["p"][0]
        self.answer = split(rec.summary, summary_fields(w))
        self.max_iters = est["ba_iters"]

    def seed(self, prev):
        """Dead-reckoned knots (KW) from the held spline's state at the
        knot `old_hi - 7` (clamped), by the frame's IMU samples after it:
        knot i takes the pose of the last sample at or before (i - 1) dt."""
        KW, NB, dt = self.KW, self.NB, 1.0 / self.inv_dt
        old_hi, new_hi = int(self.scalars[6]), int(self.scalars[7])
        i0 = min(max(max(old_hi - 3, 4) - 4, 0), KW - 4)
        q4, p4 = prev["knots_q"][i0:i0 + 4], prev["knots_p"][i0:i0 + 4]
        zero = torch.zeros((), dtype=torch.float64, device=self.dev)
        q0 = rot_pose(q4, zero)
        p0 = pos_eval(p4, zero)
        v0 = (torch.tensor([-0.5, 0.0, 0.5, 0.0], dtype=torch.float64,
                           device=self.dev)[:, None] * p4).sum(0) / dt
        bg, ba = prev["bg"][NB - 1], prev["ba"][NB - 1]
        mu = self.imu
        t0, t_hi = i0 * dt, (new_hi - 3) * dt
        t_m = (mu["i0"].to(torch.float64) + mu["u"]) * dt
        on = (t_m > t0) & (t_m <= t_hi + dt)
        t_prev = torch.cat([t_m.new_tensor([t0]), t_m[:-1]])
        dts = torch.where(on, torch.clamp(t_m - torch.clamp(t_prev, min=t0),
                                          0.0, 0.05), 0.0)
        q, v, p = q0, v0, p0
        qs, ps = [], []
        for k in range(len(dts)):
            a = qrot(q, mu["accel"][k] - ba) - self.gravity
            q = qmul(q, qexp((mu["gyro"][k] - bg) * dts[k]))
            q = q / q.norm()
            p = p + v * dts[k] + 0.5 * a * dts[k] ** 2
            v = v + a * dts[k]
            qs.append(q)
            ps.append(p)
        sq, sp = q0.expand(KW, 4).clone(), p0.expand(KW, 3).clone()
        for i in range(KW):
            hit = torch.nonzero(on & (t_m <= (i - 1) * dt + 1e-9))
            if len(hit):
                sq[i], sp[i] = qs[int(hit[-1])], ps[int(hit[-1])]
        return sq, sp

    # ---- cost, gradient and Gauss-Newton matrix over the full layout:
    # [rot 3KW | pos 3KW | bg 3NB | ba 3NB | ld | dinv LM]
    def col(self, what, i):
        KW, NB = self.KW, self.NB
        base = {"rot": 0, "pos": 3 * KW, "bg": 6 * KW, "ba": 6 * KW + 3 * NB}
        return base[what] + 3 * i

    def knot_cols(self, s):
        """(n, 24) columns of knots s..s+3: rotation, then position."""
        k = s[:, None] + torch.arange(4, device=s.device)
        c = torch.arange(3, device=s.device)
        rot = (3 * k[:, :, None] + c).reshape(-1, 12)
        return torch.cat([rot, rot + 3 * self.KW], 1)

    def segments(self, i0, f, row, ld):
        tot = f + row * ld * self.inv_dt
        shift = torch.floor(tot)
        s = torch.clamp(i0 + shift.to(torch.int64), 0, self.KW - 4)
        return s, tot - shift

    def factors(self, x, jac=True, marg=False):
        """The image, IMU and bias factors at x: cost, and with `jac` the
        gradient and Gauss-Newton matrix over [rot 3KW | pos 3KW | bg 3NB |
        ba 3NB | ld | dinv LM]."""
        KW = self.KW
        N = self.C + self.LM
        f64 = dict(dtype=torch.float64, device=self.dev)
        H = torch.zeros((N, N), dtype=torch.float64, device=self.dev)
        g = torch.zeros(N, dtype=torch.float64, device=self.dev)
        cost = torch.zeros((), dtype=torch.float64, device=self.dev)
        knots = lambda s: (x["q"][s[:, None] + torch.arange(  # noqa: E731
            4, device=s.device)], x["p"][s[:, None] + torch.arange(
                4, device=s.device)])

        def add(Jl, r, cols, wt=None):
            """H += sum w J^T J, g += sum w J^T r over factors (the Cauchy
            loss by its weight rho', as the port's rows carry it)."""
            if wt is None:
                wt = torch.ones(r.shape[0], dtype=r.dtype, device=r.device)
            JtJ = torch.einsum("n,nri,nrj->nij", wt, Jl, Jl)
            Jtr = torch.einsum("n,nri,nr->ni", wt, Jl, r)
            H.index_put_((cols[:, :, None].expand_as(JtJ),
                          cols[:, None, :].expand_as(JtJ)), JtJ,
                         accumulate=True)
            g.index_put_((cols,), Jtr, accumulate=True)

        im, mu = self.img, self.imu
        c = CAUCHY_C
        if marg:
            # the factors that leave with the oldest keyframe: its
            # landmarks' pairs (of a positive depth), the IMU samples before
            # the second keyframe, the first bias pair; the Cauchy scale 1
            keep = im["marg"] & (x["d"][im["lm"]] > MARG_DINV_MIN)
            im = {k: v[keep] for k, v in im.items()}
            mu = {k: v[mu["marg"]] for k, v in mu.items()}
            c = 1.0
        if len(im["lm"]):
            s_i, u_i = self.segments(im["i0_i"], im["f_i"], im["row_i"],
                                     x["ld"])
            s_j, u_j = self.segments(im["i0_j"], im["f_j"], im["row_j"],
                                     x["ld"])
            q4i, p4i = knots(s_i)
            q4j, p4j = knots(s_j)
            d = x["d"][im["lm"]]

            # perturbations e (B, 1, 50), each shared by every factor: a
            # factor depends on its own knots alone, so its difference
            # quotient by a shared one is its own block
            def f_img(e):
                qi, pi = perturb(q4i, p4i, e[..., :24])
                qj, pj = perturb(q4j, p4j, e[..., 24:48])
                dld = e[..., 49] * self.inv_dt
                return reproj(qi, pi, u_i + im["row_i"] * dld, qj, pj,
                              u_j + im["row_j"] * dld, im["pt_i"],
                              im["pt_j"], d + e[..., 48], self.ext_q,
                              self.ext_p, self.w_img)

            steps = torch.cat([torch.full((48,), STEP_KNOT, **f64),
                               torch.tensor([STEP_DINV, STEP_LD], **f64)])
            r, Jl = differences(f_img, steps)
            s2 = (r * r).sum(-1)
            c2 = c ** 2
            cost = cost + 0.5 * (c2 * torch.log1p(s2 / c2)).sum()
            if jac:
                cols = torch.cat([self.knot_cols(s_i), self.knot_cols(s_j),
                                  (self.C + im["lm"])[:, None],
                                  torch.full_like(im["lm"], self.C - 1)[
                                      :, None]], 1)
                add(Jl, r, cols, 1.0 / (1.0 + s2 / c2))

        if len(mu["u"]):
            s = torch.clamp(mu["i0"], 0, KW - 4)
            q4, p4 = knots(s)
            bg, ba = x["bg"][mu["bidx"]], x["ba"][mu["bidx"]]

            def f_imu(e):
                q, p = perturb(q4, p4, e[..., :24])
                return imu_res(q, p, mu["u"], bg + e[..., 24:27],
                               ba + e[..., 27:30], mu["gyro"], mu["accel"],
                               self.gravity, self.info, self.inv_dt)

            r, Jl = differences(f_imu, torch.cat([
                torch.full((24,), STEP_KNOT, **f64),
                torch.full((6,), STEP_BIAS, **f64)]))
            cost = cost + 0.5 * (r * r).sum()
            if jac:
                c3 = torch.arange(3, device=self.dev)
                cols = torch.cat([
                    self.knot_cols(s),
                    self.col("bg", 0) + 3 * mu["bidx"][:, None] + c3,
                    self.col("ba", 0) + 3 * mu["bidx"][:, None] + c3], 1)
                add(Jl, r, cols)

        # the bias random walk: linear, rows -+sqrt_info on pairs i, i+1
        dbg = x["bg"][1:] - x["bg"][:-1]
        dba = x["ba"][1:] - x["ba"][:-1]
        si = self.bias_si
        if marg:
            si = si * (torch.arange(self.NB - 1, device=self.dev) == 0)[
                :, None]
        rb = si * torch.cat([dbg, dba], -1)
        cost = cost + 0.5 * (rb * rb).sum()
        if jac:
            pair = torch.arange(self.NB - 1, device=self.dev)[:, None]
            c6 = torch.arange(6, device=self.dev)
            base = torch.where(c6 < 3, self.col("bg", 0) + c6,
                               self.col("ba", 0) + c6 - 3)
            a = (base + 3 * pair).reshape(-1)
            bcol = a + 3
            w = si.reshape(-1)
            Jl = torch.stack([-w, w], -1)[:, None, :]
            add(Jl, rb.reshape(-1, 1), torch.stack([a, bcol], -1))

        return cost, g, H

    def boxminus(self, x):
        pr = self.prior
        return torch.cat([
            qlog(qmul(qconj(pr["knots_q0"]), x["q"])).reshape(-1),
            (x["p"] - pr["knots_p0"]).reshape(-1),
            (x["bg"] - pr["bg0"]).reshape(-1),
            (x["ba"] - pr["ba0"]).reshape(-1),
            (x["ld"] - pr["ld0"]).reshape(1)])

    def retract(self, x, dx, dx_lm):
        KW, NB = self.KW, self.NB
        lo, hi = self.ld_box
        return dict(
            q=qmul(x["q"], qexp(dx[:3 * KW].reshape(KW, 3))),
            p=x["p"] + dx[3 * KW:6 * KW].reshape(KW, 3),
            bg=x["bg"] + dx[6 * KW:6 * KW + 3 * NB].reshape(NB, 3),
            ba=x["ba"] + dx[6 * KW + 3 * NB:self.C - 1].reshape(NB, 3),
            ld=torch.clamp(x["ld"] + dx[self.C - 1], lo, hi),
            d=x["d"] + dx_lm)

    def normal_equations(self, x):
        """The LM's normal equations at x: the camera system (C, C) with
        its gradient, the landmarks' diagonal and gradient, their coupling,
        and the cost. Fixed knots' columns are masked; the prior enters by
        its Jacobian J, as its linearization takes x [-] x0 to first
        order."""
        C = self.C
        cost, g, H = self.factors(x)
        cm = self.cmask
        pr = self.prior
        rp = pr["r0"] + pr["J"] @ self.boxminus(x)
        Pm = pr["J"] * cm[None, :]
        Hc = H[:C, :C] * cm[:, None] * cm[None, :] + Pm.T @ Pm
        gc = g[:C] * cm + Pm.T @ rp
        ne = (Hc, gc, torch.diagonal(H[C:, C:]).clone(), g[C:],
              H[C:, :C] * cm[None, :])
        return ne, cost + 0.5 * (rp * rp).sum()

    def schur(self, ne, lam):
        """The damped step: landmarks eliminated, the camera system
        Jacobi-scaled and solved by Cholesky (a failed factorization gives
        no step, which the accept test rejects)."""
        H, g, h_ll, g_l, H_cl = ne
        cm = self.cmask
        dg = torch.clamp(torch.diagonal(H), 1e-6, 1e32)
        H_d = H + lam * torch.diag(dg) + torch.diag(1.0 - cm)
        inv = 1.0 / (h_ll * (1.0 + lam) + LM_EPS)
        H_sc = H_d - H_cl.T @ (H_cl * inv[:, None])
        g_sc = g - H_cl.T @ (g_l * inv)
        s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H_sc), min=1e-12))
        H_n = 0.5 * (H_sc + H_sc.T) * s[:, None] * s[None, :]
        L, info = torch.linalg.cholesky_ex(H_n)
        if int(info) != 0:
            return None
        dx = s * torch.cholesky_solve((-(s * g_sc))[:, None], L)[:, 0]
        dx = dx * cm
        return dx, -(g_l + H_cl @ dx) * inv

    def lm(self, iters: int):
        """The port's Levenberg-Marquardt loop in float64, for `iters`
        iterations (the port's own count, its summary's: where its
        stopping test, an accepted step lowering the cost by less than
        `ba_tol`, falls on a tie at float32 rounding, the count is the
        port's): a trial accepted when it lowers the cost, lambda halved on
        an accept and quadrupled on a reject. Returns (x, cost at the
        start)."""
        x = self.x
        ne, cost = self.normal_equations(x)
        cost0, lam = float(cost), LAMBDA_INIT
        for _ in range(iters):
            step = self.schur(ne, lam)
            ok = False
            if step is not None:
                trial = self.retract(x, step[0], step[1] * self.lm_mask)
                ne_t, cost_t = self.normal_equations(trial)
                ok = bool(torch.isfinite(cost_t)) and float(cost_t) < float(
                    cost)
            if ok:
                x, ne, cost = trial, ne_t, cost_t
                lam = min(max(lam * LAMBDA_DOWN, 1e-10), 1e8)
            else:
                lam = min(max(lam * LAMBDA_UP, 1e-10), 1e8)
        return x, cost0

    def marginal(self, x):
        """The prior the oldest keyframe's marginalization leaves, at x (the
    solved window in its restored gauge, where the port marginalizes), in
        the slid window's layout: the information and gradient (C, C),
        (C,) of the marginalized factors and the old prior, with the
        landmarks, the dropped knots and the first biases eliminated by
        their Schur complement (the port's QR square root computes the
        same two)."""
        C, KW, NB = self.C, self.KW, self.NB
        _, g, H = self.factors(x, marg=True)
        pr = self.prior
        rp = pr["r0"] + pr["J"] @ self.boxminus(x)
        H[:C, :C] += pr["J"].T @ pr["J"]
        g[:C] += pr["J"].T @ rp
        kn = self.drop_knots.repeat_interleave(3)
        b0 = torch.zeros(3 * NB, dtype=torch.bool, device=self.dev)
        b0[:3] = True
        drop_c = torch.cat([kn, kn, b0, b0, torch.zeros(1, dtype=torch.bool,
                                                        device=self.dev)])
        used = torch.diagonal(H)[C:] > 0
        D = torch.cat([drop_c, used])
        K = torch.cat([~drop_c, torch.zeros_like(used)])
        HDD, HKD = H[D][:, D], H[K][:, D]
        sol = torch.linalg.solve(HDD, torch.cat([HKD.T, g[D][:, None]], 1))
        Hm = H[K][:, K] - HKD @ sol[:, :-1]
        gm = g[K] - HKD @ sol[:, -1]
        # the slid layout: knot k to k - shift, keyframe b to b - 1
        src = torch.nonzero(K[:C])[:, 0]
        s = self.knot_shift
        dst = torch.where(src < 6 * KW,
                          src - 3 * s,
                          torch.where(src < C - 1, src - 3, src))
        Hs = torch.zeros((C, C), dtype=torch.float64, device=self.dev)
        gs = torch.zeros(C, dtype=torch.float64, device=self.dev)
        Hs[dst[:, None], dst[None, :]] = Hm
        gs[dst] = gm
        return Hs, gs

    def gauge(self, x):
        """Knot 0 back to its yaw and position before the solve (the full
        rotation near a pitch of +-90 deg)."""
        def ypr(q):
            w, a, b, c = q
            r00, r10 = 1 - 2 * (b * b + c * c), 2 * (a * b + w * c)
            r20 = 2 * (a * c - w * b)
            y = torch.atan2(r10, r00)
            p = torch.atan2(-r20, r00 * torch.cos(y) + r10 * torch.sin(y))
            return y, p
        y_ref, p_ref = ypr(self.q_ref)
        y_new, p_new = ypr(x["q"][0])
        near = math.radians(1.0)
        if (abs(abs(float(p_ref)) - math.pi / 2) < near
                or abs(abs(float(p_new)) - math.pi / 2) < near):
            qd = qmul(self.q_ref, qconj(x["q"][0]))
        else:
            h = 0.5 * (y_ref - y_new)
            z = torch.zeros_like(h)
            qd = torch.stack([torch.cos(h), z, z, torch.sin(h)])
        t = self.p_ref - qrot(qd, x["p"][0])
        q = qmul(qd.expand_as(x["q"]), x["q"])
        return q / q.norm(dim=-1, keepdim=True), qrot(qd.expand_as(x["q"]),
                                                     x["p"]) + t


def close(packed, exact) -> bool:
    exact = np.asarray(exact, np.float64)
    return bool(np.all(np.abs(np.asarray(packed) - exact)
                       <= F32_TOL * np.maximum(1.0, np.abs(exact))))


def gaps(win: Window, x) -> dict:
    """The port's answer against the reference's: the largest rotation
    (urad) and position (um) gap over the active knots, the biases' and
    the line delay's (ns a row)."""
    q, p = win.gauge(x)
    a, n = win.answer, win.n_active
    f64 = dict(dtype=torch.float64, device=win.dev)
    qa = torch.tensor(a["knots_q"][:n], **f64)
    qa = qa / qa.norm(dim=-1, keepdim=True)
    dq = qmul(qconj(q[:n]), qa)
    ang = 2 * torch.atan2(dq[:, 1:].norm(dim=-1), dq[:, 0].abs())
    dp = (torch.tensor(a["knots_p"][:n], **f64) - p[:n]).norm(dim=-1)
    return {"rot_urad": float(ang.max()) * 1e6,
            "pos_um": float(dp.max()) * 1e6,
            "bg": float(np.abs(a["bg"] - x["bg"].cpu().numpy()).max()),
            "ba": float(np.abs(a["ba"] - x["ba"].cpu().numpy()).max()),
            "ld_ns": abs(float(a["ld"][0]) - float(x["ld"])) * 1e9,
            "overflow": float(np.sum(a["marg_ovf"]))}


def prior_gaps(win: Window, x, after: dict) -> dict:
    """The prior the port left against the reference's marginalization:
    the largest gap of its information J^T J and of its gradient J^T r0,
    each entry over the reference's standard deviations (d_i d_j, d_i
    with d = sqrt(diag) of the reference's information)."""
    q, p = win.gauge(x)
    Hs, gs = win.marginal(dict(x, q=q, p=p))
    f64 = dict(dtype=torch.float64, device=win.dev)
    J = torch.tensor(np.asarray(after["J"], np.float64), **f64)
    r0 = torch.tensor(np.asarray(after["r0"], np.float64), **f64)
    d = torch.sqrt(torch.diagonal(Hs))
    on = d > 0
    dd = torch.where(on, d, torch.ones_like(d))
    eH = ((J.T @ J - Hs) / (dd[:, None] * dd[None, :]))[on][:, on]
    eg = ((J.T @ r0 - gs) / dd)[on]
    return {"prior_info": float(eH.abs().max()),
            "prior_grad": float(eg.abs().max())}


def check(records, seq, config, traffic, start_ns, device):
    """Each record's gaps, its input faults (an iteration count out of
    range counts as one), the reference's start cost against the port's
    (relative) and the iterations run."""
    out = []
    for rec in records:
        win = Window(rec, seq, config, traffic, start_ns, device)
        iters = int(win.answer["iters"][0])
        bad = not 1 <= iters <= win.max_iters
        x, cost0 = win.lm(min(max(iters, 1), win.max_iters))
        c0 = float(win.answer["costs"][0])
        rec_out = dict(gaps(win, x), faults=win.faults + bad,
                       cost0_rel=abs(cost0 - c0) / max(abs(c0), 1e-30),
                       iters=iters)
        if win.marg_old and rec.after is not None:
            rec_out.update(prior_gaps(win, x, rec.after))
        out.append(rec_out)
    return out
