"""The square-root marginalization's Q-less QR: kernel K6 and its plain
version.

`solver/marginalize.py::build_prior_sqrt` needs the R of one tall [A | b]:
the marginalized image, IMU, bias and old-prior rows over the columns
[landmarks | window coordinates, dropped first | b], each column scaled to
unit norm, with eps rows eps I under every column. It keeps R's rows of the
kept window coordinates as the new prior. K6 (`csrc/qr_prior.cu`,
`qr_prior_r`) computes them from the rows' window part U = [(J /
cs_c)[:, order] | r] (`kernel_inputs`, one gather) and the landmark
entries: neither the landmark columns nor the eps rows are built. It
replaces no Pallas kernel: the JAX package leaves the QR to XLA
(`ctrlvio_tpu/solver/marginalize.py:287`).

- Stage 1, the landmark columns: landmark j's column holds only its own
  observation rows' entries l_i (J_lm scaled by the column's norm) and its
  eps row, so one reflection pivoted on the eps row eliminates it, and each
  observation row's window part becomes u_i - l_i s_j with s_j =
  (sum_i l_i u_i) / (|l| (|l| + eps)), |l|^2 = eps^2 + sum_i l_i^2.
- Stage 2, the window columns: the reduced image rows, the live IMU and
  bias rows and the old prior's rows are absorbed into R = eps I (C rows
  over C + 1 columns) by one Householder reflection a column (LAPACK's
  dlarfg conventions). K6 absorbs them in batches (64 rows in f32, 32 in
  f64; `geometry`), block k of a lane holding batch k and passing R on to
  block k + 1 row by row; the plain version absorbs every row at once,
  column panels of `PANEL` applied to the trailing columns as one block
  reflector. The batches change the rounding and R's row signs, not
  R^T R. (Wider windows take K6's instance of half the rows a block.)
- Out: R's rows from `keep_from` on, scaled back by the columns' norms, in
  the window's column order, as the prior's J (C, C) and r0 (C,); the rows
  before are zero.

`qr_prior_r_plain` is the plain PyTorch version (vmappable: the serving
lanes run it under torch.func.vmap on the CPU). `qr_prior_r` is the
wrapper: CPU tensors take the plain version; CUDA tensors go through the
custom op `torch.ops.ctrlvio_tpu_torch.qr_prior_r` (a lane axis first; its
vmap rule folds the vmapped axis into it, so B lanes are one launch, grid
y the lane), which launches K6 or raises. `qr_prior_r.launches` counts
K6's launches and `qr_prior_r_plain.calls` the plain version's runs;
`counts()` reads them (settled with `utils/graphs.py`: a launch in a
captured program counts on each replay), `reset_counts()` zeroes them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ctrlvio_tpu_torch.ops import factor_kernels
from ctrlvio_tpu_torch.utils import graphs

OP = "ctrlvio_tpu_torch::qr_prior_r"
FLOATS = (torch.float32, torch.float64)
PANEL = 32


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def landmark_reduced_rows(J, r, J_lm, new_idx, live_img, cs_c, order,
                          MLM: int, eps: float):
    """Stage 1: the scaled, permuted rows U = [(J / cs_c)[:, order] | r]
    (R, C + 1), each live image row's landmark column eliminated (u_i -
    l_i s_j); image rows that are not live are zero."""
    dtype = J.dtype
    MOBS = new_idx.shape[0]
    m = live_img.to(dtype)
    idx = torch.where(live_img, new_idx, torch.zeros_like(new_idx))
    jl = J_lm * m[:, None]
    cs2 = torch.zeros((MLM,), dtype=dtype, device=J.device).index_add(
        0, idx, torch.sum(jl * jl, dim=1))
    cs = torch.sqrt(cs2)
    cs = torch.where(cs > 1e-12, cs, torch.ones_like(cs))
    l = jl / cs[idx][:, None]
    nl = torch.sqrt(eps * eps + torch.zeros(
        (MLM,), dtype=dtype, device=J.device).index_add(
            0, idx, torch.sum(l * l, dim=1)))
    U = torch.cat([(J / cs_c[None, :])[:, order], r[:, None]], dim=1)
    Ui = U[: 2 * MOBS].reshape(MOBS, 2, -1)
    g = torch.zeros((MLM, U.shape[1]), dtype=dtype, device=J.device).index_add(
        0, idx, torch.einsum("ok,okc->oc", l, Ui))
    s = g / (nl * (nl + eps))[:, None]
    Ui = (Ui - l[:, :, None] * s[idx][:, None, :]) * m[:, None, None]
    return torch.cat([Ui.reshape(2 * MOBS, -1), U[2 * MOBS:]], dim=0)


def _reflector(alpha, x):
    """dlarfg for [alpha; x]: beta, tau and the scale of x in v = (1, x *
    scale); the identity (tau 0) where x is zero."""
    n2 = torch.sum(x * x)
    zero = n2 == 0
    beta = torch.where(zero, alpha,
                       -torch.copysign(torch.sqrt(alpha * alpha + n2), alpha))
    den = torch.where(zero, torch.ones_like(beta), beta)
    tau = torch.where(zero, torch.zeros_like(beta), (beta - alpha) / den)
    diff = torch.where(zero, torch.ones_like(beta), alpha - beta)
    scale = torch.where(zero, torch.zeros_like(beta), 1.0 / diff)
    return beta, tau, scale


def absorb(R0, B):
    """The R (C, N) of [R0; B] for an upper-trapezoidal R0 (C, N) and rows
    B (m, N): for each column j < C one reflection of R0's row j and B's
    rows; each panel of PANEL columns first on its own columns, then on the
    trailing columns as one block reflector (I - Y T^T Y^T, Y = [I; V])."""
    C, N = R0.shape
    dtype, dev = R0.dtype, R0.device
    out = []
    for j0 in range(0, C, PANEL):
        k = min(PANEL, C - j0)
        # B holds the columns from j0 on
        pr, pb = R0[j0:j0 + k, j0:j0 + k], B[:, :k]
        ar, ab = R0[j0:j0 + k, j0 + k:], B[:, k:]
        cols = torch.arange(k, device=dev)
        V, taus = [], []
        for s in range(k):
            beta, tau, scale = _reflector(pr[s, s], pb[:, s])
            v = pb[:, s] * scale
            w = torch.where(cols > s, tau * (pr[s] + v @ pb),
                            torch.zeros((), dtype=dtype, device=dev))
            row = (cols == s).to(dtype)
            pr = pr - row[:, None] * w[None, :] \
                + (row[:, None] * row[None, :]) * (beta - pr[s, s])
            pb = pb - v[:, None] * w[None, :]
            V.append(v)
            taus.append(tau)
        V = torch.stack(V, dim=1)
        vtv = V.T @ V
        T = torch.zeros((k, k), dtype=dtype, device=dev)
        for s in range(k):
            col = -taus[s] * (T @ (vtv[:, s] * (cols < s).to(dtype)))
            col = torch.where(cols == s, taus[s], col)
            T = T + col[:, None] * (cols == s).to(dtype)[None, :]
        W = T.T @ (ar + V.T @ ab)
        out.append(torch.cat([torch.zeros((k, j0), dtype=dtype, device=dev),
                              pr, ar - W], dim=1))
        B = ab - V @ W
    return torch.cat(out, dim=0)


def qr_prior_r_plain(J, r, J_lm, new_idx, live_img, live_imu, live_bias,
                     cs_c, order, keep_from, MLM: int, eps: float):
    """The prior's (J (C, C), r0 (C,)) from the marginalized rows of one
    window: J (R, C) and r (R,) the stacked [image (2 MOBS) | IMU (6 MIMU)
    | bias (6 (NB - 1)) | old prior (C)] rows, J_lm (MOBS, 2) the image
    rows' landmark entries, new_idx (MOBS,) their compact landmark slots
    (< MLM), the live masks of the image, IMU and bias factors, cs_c (C,)
    the columns' norms, order (C,) the window columns with the dropped ones
    first, keep_from (int or 0-dim tensor) the first kept row."""
    qr_prior_r_plain.calls += 1
    dtype = J.dtype
    MOBS, MIMU, NBM1, C = (new_idx.shape[0], live_imu.shape[0],
                           live_bias.shape[0], J.shape[1])
    U = landmark_reduced_rows(J, r, J_lm, new_idx, live_img, cs_c, order,
                              MLM, eps)
    m = torch.cat([torch.ones((2 * MOBS,), dtype=dtype, device=J.device),
                   live_imu.to(dtype).repeat_interleave(6),
                   live_bias.to(dtype).repeat_interleave(6),
                   torch.ones((C,), dtype=dtype, device=J.device)])
    R0 = torch.cat([eps * torch.eye(C, dtype=dtype, device=J.device),
                    torch.zeros((C, 1), dtype=dtype, device=J.device)], 1)
    R = absorb(R0, U * m[:, None])
    keep = (torch.arange(C, device=J.device) >= keep_from).to(dtype)[:, None]
    R = R * keep
    J_out = R[:, :C][:, torch.argsort(order)] * cs_c[None, :]
    return J_out, R[:, C]


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------


def declare(lib):
    """`lib` (the CUDA library, or a host build of the same source) with
    its entry points' signatures declared."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qr_prior_r.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                               ctypes.c_longlong, ctypes.c_double, p]
    lib.qr_prior_r.restype = i
    lib.qr_prior_rows.argtypes = [i, i, i]
    lib.qr_prior_rows.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its entry points' signatures declared."""
    from ctrlvio_tpu_torch.utils import cuda_build

    lib = declare(cuda_build.load("qr_prior"))
    lib.qr_prior_attributes.argtypes = [ctypes.c_void_p]
    lib.qr_prior_attributes.restype = ctypes.c_int
    return lib


INSTANCES = ("float32", "float32 wide", "float64", "float64 wide")
ATTRIBUTES = ("registers", "local_bytes", "shared_bytes",
              "max_threads_per_block")


def kernel_attributes():
    """Each instance's resources on the card (`cudaFuncGetAttributes`):
    registers a thread, local (spill) bytes a thread, static shared bytes
    a block and the most threads a block it can launch with."""
    n = len(ATTRIBUTES)
    out = (ctypes.c_longlong * (n * len(INSTANCES)))()
    err = _lib().qr_prior_attributes(out)
    if err != 0:
        raise RuntimeError(f"qr_prior_attributes: cudaError {err}")
    return {name: dict(zip(ATTRIBUTES, out[n * k: n * (k + 1)]))
            for k, name in enumerate(INSTANCES)}


def geometry(lib, dtype, R: int, C: int):
    """(rows a block, chain positions a lane, threads for the C + 1
    columns and one past them, padded to warps) of a launch over R rows
    and C window columns; raises for a window wider than a block takes."""
    ncolp = (C + 2 + 31) // 32 * 32
    rows = lib.qr_prior_rows(FLOATS.index(dtype), C, ncolp)
    if rows < 0:
        raise ValueError(f"qr_prior_r: C = {C} window columns is more than "
                         f"a block takes")
    return rows, (R + rows - 1) // rows, ncolp


def kernel_inputs(ts, MLM: int):
    """The kernel's tensors from the op's (J, r, J_lm, new_idx, live_img,
    live_imu, live_bias, cs_c, order, keep or None; each with a lane axis):
    U = [(J / cs_c)[:, order] | r] (the scaled, permuted rows, as the plain
    version makes them) and the image obs sorted by their live landmark
    slot (the others last), so that each block finds its landmarks' rows
    as one run."""
    J, r, J_lm, new_idx, live_img, live_imu, live_bias, cs_c, order, keep = ts
    L, R, C = J.shape
    U = torch.cat([torch.gather(J / cs_c[:, None, :], 2,
                                order[:, None, :].expand(L, R, C)),
                   r[:, :, None]], dim=2)
    key = torch.where(live_img, new_idx, torch.full_like(new_idx, MLM))
    perm = torch.argsort(key, dim=1, stable=True)
    return (U, J_lm, new_idx, live_img, live_imu, live_bias, cs_c, order,
            keep, perm)


def call(lib, ts, keep_i, MLM, eps, stream=None):
    """One call of `lib`'s entry point on the op's tensors `ts` (J, r,
    J_lm, new_idx, live_img, live_imu, live_bias, cs_c, order, keep or
    None; each with a lane axis): (J_out, r_out), allocated here with the
    kernel's inputs (`kernel_inputs`), the chain's scratch and its counters
    (zeroed) on their device. Raises if the entry point returns an error."""
    J = ts[0]
    dtype, dev = J.dtype, J.device
    L, R, C = J.shape
    MOBS, MIMU, NBM1 = ts[3].shape[1], ts[5].shape[1], ts[6].shape[1]
    rows, npos, ncolp = geometry(lib, dtype, R, C)
    ks = kernel_inputs(ts, MLM)
    J_out = torch.empty((L, C, C), dtype=dtype, device=dev)
    r_out = torch.empty((L, C), dtype=dtype, device=dev)
    buf = torch.empty((L, npos, C, ncolp), dtype=dtype, device=dev)
    counters = torch.zeros((L, npos + 1), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * len(ks))(*[None if t is None else t.data_ptr()
                                         for t in ks])
    strides = (ctypes.c_longlong * len(ks))(*[
        t.stride(0) if t is not None and t.shape[0] > 1 else 0 for t in ks])
    err = lib.qr_prior_r(FLOATS.index(dtype), ptrs, strides,
                         J_out.data_ptr(), r_out.data_ptr(), buf.data_ptr(),
                         counters.data_ptr(), L, MOBS, MIMU, NBM1, C, MLM,
                         npos, ncolp, int(keep_i), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"qr_prior_r: K6 launch failed (cudaError {err})")
    return J_out, r_out


_NAMES = ("J", "r", "J_lm", "new_idx", "live_img", "live_imu", "live_bias",
          "cs_c", "order", "keep")


def _check(ts, MLM):
    """Raise unless the op's tensors are what K6 takes: one device, one
    float dtype (f32 or f64), int64 indices, bool masks, a lane axis of one
    length, each lane's block contiguous, shapes that agree."""
    J = ts[0]
    fdt, dev, L = J.dtype, J.device, J.shape[0]
    if fdt not in FLOATS:
        raise TypeError(f"qr_prior_r: J must be float32 or float64, got {fdt}")
    want = (fdt, fdt, fdt, torch.int64, torch.bool, torch.bool, torch.bool,
            fdt, torch.int64, torch.int64)
    for t, name, w in zip(ts, _NAMES, want):
        if t is None:
            continue
        if t.dtype != w:
            raise TypeError(f"qr_prior_r: {name} is {t.dtype}, expected {w}")
        if t.device != dev:
            raise ValueError(f"qr_prior_r: {name} is on {t.device}, "
                             f"expected {dev}")
        if t.dim() < 1 or t.shape[0] != L:
            raise ValueError(f"qr_prior_r: {name} has shape "
                             f"{tuple(t.shape)}, expected a lane axis of {L}")
        if not t[0].is_contiguous():
            raise ValueError(f"qr_prior_r: {name} must be contiguous in each "
                             f"lane")
    if J.dim() != 3:
        raise ValueError(f"qr_prior_r: J has shape {tuple(J.shape)}, "
                         f"expected (L, R, C)")
    R, C = J.shape[1:]
    MOBS, MIMU, NBM1 = ts[3].shape[1], ts[5].shape[1], ts[6].shape[1]
    shapes = ((R, C), (R,), (MOBS, 2), (MOBS,), (MOBS,), (MIMU,), (NBM1,),
              (C,), (C,), ())
    for t, name, s in zip(ts, _NAMES, shapes):
        if t is not None and tuple(t.shape[1:]) != s:
            raise ValueError(f"qr_prior_r: {name} has shape "
                             f"{tuple(t.shape)}, expected (L, "
                             f"{', '.join(map(str, s))})")
    if R != 2 * MOBS + 6 * MIMU + 6 * NBM1 + C:
        raise ValueError(f"qr_prior_r: J's {R} rows are not 2 MOBS + 6 MIMU "
                         f"+ 6 (NB - 1) + C = "
                         f"{2 * MOBS + 6 * MIMU + 6 * NBM1 + C}")
    if MLM < 1:
        raise ValueError("qr_prior_r: MLM must be at least 1")


def _launch(J, r, J_lm, new_idx, live_img, live_imu, live_bias, cs_c, order,
            keep, keep_i, MLM, eps):
    """The op on the card: K6, once over every lane."""
    ts = (J, r, J_lm, new_idx, live_img, live_imu, live_bias, cs_c, order,
          keep)
    if J.device.type != "cuda":
        raise ValueError(f"qr_prior_r: unsupported device {J.device}")
    _check(ts, MLM)
    with torch.cuda.device(J.device):
        out = call(_lib(), ts, keep_i, MLM, eps,
                   torch.cuda.current_stream(J.device).cuda_stream)
    qr_prior_r.launches += 1
    return out


def _lanes_plain(J, r, J_lm, new_idx, live_img, live_imu, live_bias, cs_c,
                 order, keep, keep_i, MLM, eps):
    """The op off the card: the plain version lane by lane."""
    outs = [qr_prior_r_plain(
        J[k], r[k], J_lm[k], new_idx[k], live_img[k], live_imu[k],
        live_bias[k], cs_c[k], order[k], keep_i if keep is None else keep[k],
        MLM, eps) for k in range(J.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def _fake(J, *rest):
    L, _, C = J.shape
    return J.new_empty((L, C, C)), J.new_empty((L, C))


_SCHEMA = ("(Tensor J, Tensor r, Tensor J_lm, Tensor new_idx, "
           "Tensor live_img, Tensor live_imu, Tensor live_bias, Tensor cs_c, "
           "Tensor order, Tensor? keep, int keep_i, int MLM, float eps) -> "
           "(Tensor, Tensor)")

qr_prior_op = torch.library.custom_op(OP, _lanes_plain, mutates_args=(),
                                      schema=_SCHEMA)
qr_prior_op.register_kernel("cuda")(_launch)
qr_prior_op.register_fake(_fake)
# one launch over B x L lanes, as K2, K3 and K5 take them
torch.library.register_vmap(OP, factor_kernels._vmap_rule(qr_prior_op, 2))


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def qr_prior_r(J, r, J_lm, new_idx, live_img, live_imu, live_bias, cs_c,
               order, keep_from, MLM: int, eps: float):
    """The prior's (J (C, C), r0 (C,)) (see `qr_prior_r_plain`). CPU
    tensors take the plain version; CUDA tensors launch K6 once, for
    float32 or float64, or raise."""
    dev = J.device
    if dev.type == "cpu":
        return qr_prior_r_plain(J, r, J_lm, new_idx, live_img, live_imu,
                                live_bias, cs_c, order, keep_from, MLM, eps)
    if dev.type != "cuda":
        raise ValueError(f"qr_prior_r: unsupported device {dev}")
    if isinstance(keep_from, torch.Tensor):
        keep, keep_i = keep_from.reshape(1), 0
    else:
        keep, keep_i = None, int(keep_from)
    J_out, r_out = qr_prior_op(
        *(t.unsqueeze(0) for t in (J, r, J_lm, new_idx, live_img, live_imu,
                                   live_bias, cs_c, order)),
        keep, keep_i, int(MLM), float(eps))
    return J_out[0], r_out[0]


def reset_counts():
    """Set K6's launch count and the plain version's call count to 0."""
    qr_prior_r.launches = 0
    qr_prior_r_plain.calls = 0


def _counts():
    """K6's launches (`qr_prior_r`) and the plain version's runs
    (`qr_prior_r_plain`)."""
    return {"qr_prior_r": qr_prior_r.launches,
            "qr_prior_r_plain": qr_prior_r_plain.calls}


def _add_counts(delta):
    qr_prior_r.launches += delta.get("qr_prior_r", 0)
    qr_prior_r_plain.calls += delta.get("qr_prior_r_plain", 0)


reset_counts()
counts = graphs.register_counter(_counts, _add_counts)
