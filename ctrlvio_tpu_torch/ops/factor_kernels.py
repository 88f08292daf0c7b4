"""The window solve's factor linearization: kernels K2 and K3 and their
plain versions.

K2 (`csrc/factors.cu`, `image_factor_rows`) evaluates every image factor
of a window in one launch: residual, closed-form Jacobian blocks, Cauchy
weight and cost, and the factor's dense robust-weighted rows over the
camera system. K3 (`imu_factor_rows`) does the same for every IMU factor,
its rotation blocks by forward-mode dual numbers (as `torch.func.jacfwd`
computes them here). Neither replaces a Pallas kernel: they port what XLA
compiles from the JAX package's vmapped factor evaluations,
`ctrlvio_tpu/solver/assemble.py::_image_blocks` (:49) and `_imu_blocks`
(:84), with the one-hot expansion into dense rows.

- `image_factor_rows_plain`, `imu_factor_rows_plain`: the plain PyTorch
  versions, the solver's own composition (`_image_blocks` + `_image_rows`,
  `_imu_blocks` + `_imu_rows`).
- `image_factor_rows`, `imu_factor_rows`: the wrappers. Tensors on the CPU
  take the plain version; tensors on a CUDA device go through the custom
  op, which launches the kernel or raises: there is no fallback.
- The custom ops `torch.ops.ctrlvio_tpu_torch.image_factor_rows` and
  `imu_factor_rows` take flat tensors, each with a leading lane axis (1
  for one window). On CUDA they launch once over every lane; elsewhere
  they run the plain version lane by lane. `register_fake` gives their
  shapes, and their `torch.func.vmap` rule folds the vmapped axis into the
  lane axis, the shared inputs expanded with a lane stride of 0, so that
  B windows under vmap (the batched megastep and solver) are one launch.

Each kernel has a residual-only instance for the window's residual
summary (`solver/assemble.py::residual_rms`, `total_cost`; ≙ XLA's fused
factor evaluations in the JAX package's `residual_rms`,
`ctrlvio_tpu/solver/assemble.py:419`): `image_factor_residuals` gives each
image slot's raw residual and rho(|r|^2), `imu_factor_residuals` each IMU
slot's raw residual and |r|^2, unmasked, with their plain versions
(`factors.reproj_residual`, `factors.imu_residual`), custom ops
(`torch.ops.ctrlvio_tpu_torch.image_factor_residuals`,
`imu_factor_residuals`), fake shapes and vmap rules as the rows ops have.

`kernel_attributes()` reads each of the sixteen instances' registers,
spill bytes, shared bytes and threads a block on the card.

Each wrapper's `launches` counts its kernel's launches (and nothing
else); `*_plain.calls` count runs of the plain versions; `counts()` reads
them all, `reset_counts` sets them to 0. The counts are registered with
`utils/graphs.py`: a launch recorded into a captured graph counts on each
replay of it, one in a WHILE node's body on each trip (`counts()` settles
them first).
"""

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.func import jacfwd

from ctrlvio_tpu_torch.solver.layout import (ImageFactors, ImuFactors,
                                             WindowConfig, WindowParams)
from ctrlvio_tpu_torch.utils import graphs

from . import factors as F
from . import spline
from .reproj_analytic import reproj_analytic

NAMESPACE = "ctrlvio_tpu_torch"
IMAGE_OP = f"{NAMESPACE}::image_factor_rows"
IMU_OP = f"{NAMESPACE}::imu_factor_rows"
IMAGE_RES_OP = f"{NAMESPACE}::image_factor_residuals"
IMU_RES_OP = f"{NAMESPACE}::imu_factor_residuals"


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


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
                  cfg: WindowConfig, sqrt_info):
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


class ImageRows(NamedTuple):
    rows: torch.Tensor  # (Q, 2, C) dense robust-weighted rows
    rw: torch.Tensor    # (Q, 2) robust-weighted residuals
    J_lm: torch.Tensor  # (Q, 2) robust-weighted d r / d dinv
    cost: torch.Tensor  # (Q,) masked robust cost rho(|r|^2) (no 1/2)


class ImuRows(NamedTuple):
    rows: torch.Tensor  # (M, 6, C) dense masked rows
    r: torch.Tensor     # (M, 6) masked residuals
    cost: torch.Tensor  # (M,) masked |r|^2 (no 1/2)


def image_factor_rows_plain(params: WindowParams, img: ImageFactors, active,
                            ext, sqrt_info, cauchy_c: float,
                            cfg: WindowConfig) -> ImageRows:
    """Every image factor's rows, weighted residual, landmark column and
    cost: the factors `active` (bool (Q,)) selects, Cauchy scale
    `cauchy_c`."""
    image_factor_rows_plain.calls += 1
    dtype = params.knots_p.dtype
    (r_i, J_ri, J_pi, J_rj, J_pj, J_d, J_ld, s_i, s_j) = _image_blocks(
        params, img, ext, cfg, sqrt_info)
    w, cost = _cauchy_weight_and_cost(torch.sum(r_i * r_i, dim=-1), cauchy_c)
    m = active.to(dtype)
    w = w * m
    rows = _image_rows(J_ri, J_pi, J_rj, J_pj, J_ld, s_i, s_j, w, cfg)
    return ImageRows(rows, r_i * w[:, None], J_d * w[:, None], cost * m)


def imu_factor_rows_plain(params: WindowParams, imu: ImuFactors, active,
                          gravity, imu_info, cfg: WindowConfig) -> ImuRows:
    """Every IMU factor's masked rows, residual and squared norm, for the
    factors `active` (bool (M,)) selects."""
    imu_factor_rows_plain.calls += 1
    dtype = params.knots_p.dtype
    r_m, J_mr, J_mp, J_mbg, J_mba, s_m = _imu_blocks(params, imu, gravity,
                                                     imu_info, cfg)
    m = active.to(dtype)
    rows = _imu_rows(J_mr, J_mp, J_mbg, J_mba, s_m, imu.bias_idx, m, cfg)
    rm = r_m * m[:, None]
    return ImuRows(rows, rm, torch.sum(rm ** 2, dim=-1))


class ImageResiduals(NamedTuple):
    r: torch.Tensor     # (Q, 2) raw residuals: sqrt-info applied, unmasked
    cost: torch.Tensor  # (Q,) rho(|r|^2), unmasked (no 1/2)


class ImuResiduals(NamedTuple):
    r: torch.Tensor     # (M, 6) raw residuals, unmasked
    sq: torch.Tensor    # (M,) |r|^2, unmasked


def image_factor_residuals_plain(params: WindowParams, img: ImageFactors,
                                 ext, sqrt_info, cauchy_c: float,
                                 cfg: WindowConfig) -> ImageResiduals:
    """Every image factor's raw residual and Cauchy cost rho(|r|^2) at
    scale `cauchy_c`, valid or not."""
    image_factor_residuals_plain.calls += 1
    inv_dt = 1.0 / cfg.dt
    ui_tot, uj_tot, shift_i, shift_j, s_i, s_j = _segments(
        img, params.ld, inv_dt, cfg.KW)
    q4i = spline.gather_local(params.knots_q, s_i)
    p4i = spline.gather_local(params.knots_p, s_i)
    q4j = spline.gather_local(params.knots_q, s_j)
    p4j = spline.gather_local(params.knots_p, s_j)
    r = F.reproj_residual(q4i, p4i, ui_tot - shift_i, q4j, p4j,
                          uj_tot - shift_j, inv_dt, img.pt_i, img.pt_j,
                          params.dinv[img.lm_idx], ext, sqrt_info)
    _, cost = _cauchy_weight_and_cost(torch.sum(r * r, dim=-1), cauchy_c)
    return ImageResiduals(r, cost)


def imu_factor_residuals_plain(params: WindowParams, imu: ImuFactors,
                               gravity, imu_info,
                               cfg: WindowConfig) -> ImuResiduals:
    """Every IMU factor's raw residual and |r|^2, valid or not."""
    imu_factor_residuals_plain.calls += 1
    s = torch.clamp(imu.i0, 0, cfg.KW - 4)
    r = F.imu_residual(spline.gather_local(params.knots_q, s),
                       spline.gather_local(params.knots_p, s), imu.u,
                       1.0 / cfg.dt, params.bg[imu.bias_idx],
                       params.ba[imu.bias_idx], imu.gyro, imu.accel, gravity,
                       imu_info)
    return ImuResiduals(r, torch.sum(r * r, dim=-1))


# ---------------------------------------------------------------------------
# the custom ops
# ---------------------------------------------------------------------------

_IMAGE_SCHEMA = (
    "(Tensor knots_q, Tensor knots_p, Tensor dinv, Tensor ld, Tensor i0_i, "
    "Tensor f_i, Tensor row_i, Tensor pt_i, Tensor i0_j, Tensor f_j, "
    "Tensor row_j, Tensor pt_j, Tensor lm_idx, Tensor active, "
    "Tensor q_CtoI, Tensor p_CinI, Tensor sqrt_info, int KW, int NB, "
    "float dt, float cauchy_c) -> (Tensor, Tensor, Tensor, Tensor)")
_IMU_SCHEMA = (
    "(Tensor knots_q, Tensor knots_p, Tensor bg, Tensor ba, Tensor i0, "
    "Tensor u, Tensor gyro, Tensor accel, Tensor bias_idx, Tensor active, "
    "Tensor gravity, Tensor imu_info, int KW, int NB, float dt) "
    "-> (Tensor, Tensor, Tensor)")
# the residual ops take the rows ops' inputs but the active mask
_IMAGE_RES_SCHEMA = _IMAGE_SCHEMA.replace("Tensor active, ", "").replace(
    "(Tensor, Tensor, Tensor, Tensor)", "(Tensor, Tensor)")
_IMU_RES_SCHEMA = _IMU_SCHEMA.replace("Tensor active, ", "").replace(
    "(Tensor, Tensor, Tensor)", "(Tensor, Tensor)")
N_IMAGE_IN, N_IMU_IN = 17, 12
IMAGE_ACTIVE, IMU_ACTIVE = 13, 9  # the mask's place among the rows' inputs
FLOATS = (torch.float32, torch.float64)
INDICES = (torch.int32, torch.int64)


def _image_lanes_plain(knots_q, knots_p, dinv, ld, i0_i, f_i, row_i, pt_i,
                       i0_j, f_j, row_j, pt_j, lm_idx, active, q_CtoI, p_CinI,
                       sqrt_info, KW, NB, dt, cauchy_c):
    """The image op off the card: the plain version lane by lane."""
    cfg = WindowConfig(KW=KW, NB=NB, dt=dt)
    outs = []
    for l in range(knots_q.shape[0]):
        params = WindowParams(knots_q[l], knots_p[l], None, None, dinv[l],
                              ld[l])
        img = ImageFactors(i0_i[l], f_i[l], row_i[l], pt_i[l], i0_j[l],
                           f_j[l], row_j[l], pt_j[l], lm_idx[l], active[l],
                           active[l])
        ext = F.CamExtrinsics(q_CtoI[l], p_CinI[l])
        outs.append(image_factor_rows_plain(params, img, active[l], ext,
                                            sqrt_info[l], cauchy_c, cfg))
    return tuple(torch.stack(o) for o in zip(*outs))


def _imu_lanes_plain(knots_q, knots_p, bg, ba, i0, u, gyro, accel, bias_idx,
                     active, gravity, imu_info, KW, NB, dt):
    """The IMU op off the card: the plain version lane by lane."""
    cfg = WindowConfig(KW=KW, NB=NB, dt=dt)
    outs = []
    for l in range(knots_q.shape[0]):
        params = WindowParams(knots_q[l], knots_p[l], bg[l], ba[l], None,
                              None)
        imu = ImuFactors(i0[l], u[l], gyro[l], accel[l], bias_idx[l],
                         active[l], active[l])
        outs.append(imu_factor_rows_plain(params, imu, active[l], gravity[l],
                                          imu_info[l], cfg))
    return tuple(torch.stack(o) for o in zip(*outs))


def _image_res_lanes_plain(knots_q, knots_p, dinv, ld, i0_i, f_i, row_i,
                           pt_i, i0_j, f_j, row_j, pt_j, lm_idx, q_CtoI,
                           p_CinI, sqrt_info, KW, NB, dt, cauchy_c):
    """The image residual op off the card: the plain version lane by
    lane."""
    cfg = WindowConfig(KW=KW, NB=NB, dt=dt)
    outs = []
    for l in range(knots_q.shape[0]):
        params = WindowParams(knots_q[l], knots_p[l], None, None, dinv[l],
                              ld[l])
        img = ImageFactors(i0_i[l], f_i[l], row_i[l], pt_i[l], i0_j[l],
                           f_j[l], row_j[l], pt_j[l], lm_idx[l], None, None)
        ext = F.CamExtrinsics(q_CtoI[l], p_CinI[l])
        outs.append(image_factor_residuals_plain(params, img, ext,
                                                 sqrt_info[l], cauchy_c, cfg))
    return tuple(torch.stack(o) for o in zip(*outs))


def _imu_res_lanes_plain(knots_q, knots_p, bg, ba, i0, u, gyro, accel,
                         bias_idx, gravity, imu_info, KW, NB, dt):
    """The IMU residual op off the card: the plain version lane by lane."""
    cfg = WindowConfig(KW=KW, NB=NB, dt=dt)
    outs = []
    for l in range(knots_q.shape[0]):
        params = WindowParams(knots_q[l], knots_p[l], bg[l], ba[l], None,
                              None)
        imu = ImuFactors(i0[l], u[l], gyro[l], accel[l], bias_idx[l], None,
                         None)
        outs.append(imu_factor_residuals_plain(params, imu, gravity[l],
                                               imu_info[l], cfg))
    return tuple(torch.stack(o) for o in zip(*outs))


def _check_inputs(fn, tensors, names, floats, indices):
    """Raise unless the op's inputs are what its kernel takes: one device,
    f32 or f64 floats of one dtype, int32 or int64 indices of one dtype, a
    bool mask, a lane axis of one length, each lane's block contiguous."""
    dev = tensors[0].device
    L = tensors[0].shape[0]
    fdt, idt = tensors[floats[0]].dtype, tensors[indices[0]].dtype
    if fdt not in FLOATS:
        raise TypeError(f"{fn}: float inputs must be float32 or float64, "
                        f"got {fdt}")
    if idt not in INDICES:
        raise TypeError(f"{fn}: index inputs must be int32 or int64, "
                        f"got {idt}")
    for i, (t, name) in enumerate(zip(tensors, names)):
        want = fdt if i in floats else idt if i in indices else torch.bool
        if t.dtype != want:
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected {want}")
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, expected {dev}")
        if t.dim() < 1 or t.shape[0] != L:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected a lane axis of {L}")
        if not t[0].is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous in each lane")


def _check_shapes(fn, tensors, names, shapes):
    for t, name, shape in zip(tensors, names, shapes):
        if tuple(t.shape[1:]) != tuple(shape):
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected (L, {', '.join(map(str, shape))})")


def _require_cuda(fn, dev):
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")


def declare(lib):
    """`lib` (the CUDA library, or a host build of the same source) with
    its entry points' signatures declared."""
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.image_factor_rows.argtypes = [i, i, p, p, p, i, i, i, i, i, d, d, p]
    lib.image_factor_rows.restype = ctypes.c_int
    lib.imu_factor_rows.argtypes = [i, i, p, p, p, i, i, i, i, d, p]
    lib.imu_factor_rows.restype = ctypes.c_int
    lib.image_factor_residuals.argtypes = lib.image_factor_rows.argtypes
    lib.image_factor_residuals.restype = ctypes.c_int
    lib.imu_factor_residuals.argtypes = lib.imu_factor_rows.argtypes
    lib.imu_factor_residuals.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its entry points' signatures declared."""
    from ctrlvio_tpu_torch.utils import cuda_build

    lib = declare(cuda_build.load("factors"))
    lib.factor_kernel_attributes.argtypes = [ctypes.c_void_p]
    lib.factor_kernel_attributes.restype = ctypes.c_int
    return lib


# the kernels' sixteen instances in `factor_kernel_attributes`' order
# (K2r, K3r: K2's and K3's residual-only instances), and what it reports
# of each
KERNELS = ("K2", "K3", "K2r", "K3r")
INSTANCES = tuple(f"{k} {f} {i}" for k in KERNELS
                  for f in ("float32", "float64") for i in ("int32", "int64"))
ATTRIBUTES = ("registers", "local_bytes", "shared_bytes",
              "max_threads_per_block", "threads_per_block")


def kernel_attributes():
    """Each instance's resources on the card (`cudaFuncGetAttributes`):
    registers a thread, local (spill) bytes a thread, static shared bytes
    a block, the most threads a block it can launch with and the threads
    a block it launches with, by instance ("K2 float32 int32", ...)."""
    n = len(ATTRIBUTES)
    out = (ctypes.c_longlong * (n * len(INSTANCES)))()
    err = _lib().factor_kernel_attributes(out)
    if err != 0:
        raise RuntimeError(f"factor_kernel_attributes: cudaError {err}")
    return {name: dict(zip(ATTRIBUTES, out[n * k: n * (k + 1)]))
            for k, name in enumerate(INSTANCES)}


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _on(dev):
    return torch.cuda.device(dev)


def _pointers(tensors):
    """(pointer array, lane-stride array) of the inputs: a lane axis of one
    has no stride; None is a null pointer (an input the entry point does
    not read)."""
    n = len(tensors)
    ptrs = (ctypes.c_void_p * n)(*[None if t is None else t.data_ptr()
                                   for t in tensors])
    strides = (ctypes.c_longlong * n)(*[
        t.stride(0) if t is not None and t.shape[0] > 1 else 0
        for t in tensors])
    return ptrs, strides


def _call(lib, entry, ts, shapes, KW, NB, dt, cauchy_c, stream):
    """One call of `lib`'s entry point `entry` on the inputs `ts` (each
    with a lane axis; None for one it does not read) into outputs of
    `shapes` allocated here on their device. Raises if it returns an
    error."""
    fdt, idt, dev = ts[0].dtype, ts[4].dtype, ts[0].device
    L, n = ts[0].shape[0], ts[4].shape[1]
    outs = tuple(torch.empty(s, dtype=fdt, device=dev) for s in shapes)
    ptrs, strides = _pointers(ts)
    optrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    codes = (FLOATS.index(fdt), INDICES.index(idt))
    if entry.startswith("image"):
        err = getattr(lib, entry)(*codes, ptrs, strides, optrs, L, n, KW,
                                  NB, ts[2].shape[1], float(dt),
                                  float(cauchy_c), stream)
    else:
        err = getattr(lib, entry)(*codes, ptrs, strides, optrs, L, n, KW,
                                  NB, float(dt), stream)
    if err != 0:
        raise RuntimeError(f"{entry}: launch failed (cudaError {err})")
    return outs


def call_rows(lib, image, ts, KW, NB, dt, cauchy_c=0.0, stream=None):
    """One call of `lib`'s K2 (`image`) or K3 entry point on the op's
    inputs `ts` (each with a lane axis), into outputs allocated here on
    their device: (rows, rw, J_lm, cost) or (rows, r, cost), each with the
    lane axis. Raises if the entry point returns an error."""
    L, n, C = ts[0].shape[0], ts[4].shape[1], 6 * KW + 6 * NB + 1
    if image:
        return _call(lib, "image_factor_rows", ts,
                     [(L, n, 2, C), (L, n, 2), (L, n, 2), (L, n)], KW, NB,
                     dt, cauchy_c, stream)
    return _call(lib, "imu_factor_rows", ts,
                 [(L, n, 6, C), (L, n, 6), (L, n)], KW, NB, dt, 0.0, stream)


def call_residuals(lib, image, ts, KW, NB, dt, cauchy_c=0.0, stream=None):
    """One call of `lib`'s residual-only K2 (`image`) or K3 entry point on
    the residual op's inputs `ts` (each with a lane axis): (r, rho(|r|^2))
    or (r, |r|^2), each with the lane axis. Raises if the entry point
    returns an error."""
    L, n = ts[0].shape[0], ts[4].shape[1]
    ts = list(ts)
    ts.insert(IMAGE_ACTIVE if image else IMU_ACTIVE, None)
    if image:
        return _call(lib, "image_factor_residuals", ts, [(L, n, 2), (L, n)],
                     KW, NB, dt, cauchy_c, stream)
    return _call(lib, "imu_factor_residuals", ts, [(L, n, 6), (L, n)], KW,
                 NB, dt, 0.0, stream)


_IMAGE_NAMES = ("knots_q", "knots_p", "dinv", "ld", "i0_i", "f_i", "row_i",
                "pt_i", "i0_j", "f_j", "row_j", "pt_j", "lm_idx", "active",
                "q_CtoI", "p_CinI", "sqrt_info")
_IMU_NAMES = ("knots_q", "knots_p", "bg", "ba", "i0", "u", "gyro", "accel",
              "bias_idx", "active", "gravity", "imu_info")


def _image_launch(knots_q, knots_p, dinv, ld, i0_i, f_i, row_i, pt_i, i0_j,
                  f_j, row_j, pt_j, lm_idx, active, q_CtoI, p_CinI, sqrt_info,
                  KW, NB, dt, cauchy_c):
    """The image op on the card: K2, once over every lane."""
    ts = (knots_q, knots_p, dinv, ld, i0_i, f_i, row_i, pt_i, i0_j, f_j,
          row_j, pt_j, lm_idx, active, q_CtoI, p_CinI, sqrt_info)
    fn = "image_factor_rows"
    _require_cuda(fn, knots_q.device)
    _check_inputs(fn, ts, _IMAGE_NAMES,
                  (0, 1, 2, 3, 5, 6, 7, 9, 10, 11, 14, 15, 16), (4, 8, 12))
    Q, LM = i0_i.shape[1], dinv.shape[1]
    _check_shapes(fn, ts, _IMAGE_NAMES,
                  ((KW, 4), (KW, 3), (LM,), (), (Q,), (Q,), (Q,), (Q, 3),
                   (Q,), (Q,), (Q,), (Q, 3), (Q,), (Q,), (4,), (3,), ()))
    if KW < 4 or NB < 1:
        raise ValueError(f"{fn}: KW must be at least 4 and NB at least 1")
    dev = knots_q.device
    with _on(dev):
        outs = call_rows(_lib(), True, ts, KW, NB, dt, cauchy_c, _stream(dev))
    image_factor_rows.launches += 1
    return outs


def _imu_launch(knots_q, knots_p, bg, ba, i0, u, gyro, accel, bias_idx,
                active, gravity, imu_info, KW, NB, dt):
    """The IMU op on the card: K3, once over every lane."""
    ts = (knots_q, knots_p, bg, ba, i0, u, gyro, accel, bias_idx, active,
          gravity, imu_info)
    fn = "imu_factor_rows"
    _require_cuda(fn, knots_q.device)
    _check_inputs(fn, ts, _IMU_NAMES, (0, 1, 2, 3, 5, 6, 7, 10, 11), (4, 8))
    M = i0.shape[1]
    _check_shapes(fn, ts, _IMU_NAMES,
                  ((KW, 4), (KW, 3), (NB, 3), (NB, 3), (M,), (M,), (M, 3),
                   (M, 3), (M,), (M,), (3,), (6,)))
    if KW < 4:
        raise ValueError(f"{fn}: KW must be at least 4")
    dev = knots_q.device
    with _on(dev):
        outs = call_rows(_lib(), False, ts, KW, NB, dt, stream=_stream(dev))
    imu_factor_rows.launches += 1
    return outs


_IMAGE_RES_NAMES = tuple(n for n in _IMAGE_NAMES if n != "active")
_IMU_RES_NAMES = tuple(n for n in _IMU_NAMES if n != "active")


def _image_res_launch(knots_q, knots_p, dinv, ld, i0_i, f_i, row_i, pt_i,
                      i0_j, f_j, row_j, pt_j, lm_idx, q_CtoI, p_CinI,
                      sqrt_info, KW, NB, dt, cauchy_c):
    """The image residual op on the card: K2's residual instance, once
    over every lane."""
    ts = (knots_q, knots_p, dinv, ld, i0_i, f_i, row_i, pt_i, i0_j, f_j,
          row_j, pt_j, lm_idx, q_CtoI, p_CinI, sqrt_info)
    fn = "image_factor_residuals"
    _require_cuda(fn, knots_q.device)
    _check_inputs(fn, ts, _IMAGE_RES_NAMES,
                  (0, 1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15), (4, 8, 12))
    Q, LM = i0_i.shape[1], dinv.shape[1]
    _check_shapes(fn, ts, _IMAGE_RES_NAMES,
                  ((KW, 4), (KW, 3), (LM,), (), (Q,), (Q,), (Q,), (Q, 3),
                   (Q,), (Q,), (Q,), (Q, 3), (Q,), (4,), (3,), ()))
    if KW < 4 or NB < 1:
        raise ValueError(f"{fn}: KW must be at least 4 and NB at least 1")
    dev = knots_q.device
    with _on(dev):
        outs = call_residuals(_lib(), True, ts, KW, NB, dt, cauchy_c,
                              _stream(dev))
    image_factor_residuals.launches += 1
    return outs


def _imu_res_launch(knots_q, knots_p, bg, ba, i0, u, gyro, accel, bias_idx,
                    gravity, imu_info, KW, NB, dt):
    """The IMU residual op on the card: K3's residual instance, once over
    every lane."""
    ts = (knots_q, knots_p, bg, ba, i0, u, gyro, accel, bias_idx, gravity,
          imu_info)
    fn = "imu_factor_residuals"
    _require_cuda(fn, knots_q.device)
    _check_inputs(fn, ts, _IMU_RES_NAMES, (0, 1, 2, 3, 5, 6, 7, 9, 10),
                  (4, 8))
    M = i0.shape[1]
    _check_shapes(fn, ts, _IMU_RES_NAMES,
                  ((KW, 4), (KW, 3), (NB, 3), (NB, 3), (M,), (M,), (M, 3),
                   (M, 3), (M,), (3,), (6,)))
    if KW < 4:
        raise ValueError(f"{fn}: KW must be at least 4")
    dev = knots_q.device
    with _on(dev):
        outs = call_residuals(_lib(), False, ts, KW, NB, dt,
                              stream=_stream(dev))
    imu_factor_residuals.launches += 1
    return outs


def _image_fake(knots_q, knots_p, dinv, ld, i0_i, *rest):
    KW, NB = rest[-4], rest[-3]
    L, Q = i0_i.shape[:2]
    C = 6 * KW + 6 * NB + 1
    return (knots_q.new_empty((L, Q, 2, C)), knots_q.new_empty((L, Q, 2)),
            knots_q.new_empty((L, Q, 2)), knots_q.new_empty((L, Q)))


def _imu_fake(knots_q, knots_p, bg, ba, i0, *rest):
    KW, NB = rest[-3], rest[-2]
    L, M = i0.shape[:2]
    C = 6 * KW + 6 * NB + 1
    return (knots_q.new_empty((L, M, 6, C)), knots_q.new_empty((L, M, 6)),
            knots_q.new_empty((L, M)))


def _image_res_fake(knots_q, knots_p, dinv, ld, i0_i, *rest):
    L, Q = i0_i.shape[:2]
    return knots_q.new_empty((L, Q, 2)), knots_q.new_empty((L, Q))


def _imu_res_fake(knots_q, knots_p, bg, ba, i0, *rest):
    L, M = i0.shape[:2]
    return knots_q.new_empty((L, M, 6)), knots_q.new_empty((L, M))


def _lane_major(a, d, B):
    """A vmapped input as the op takes it under vmap: the vmapped axis
    `d` (None: not vmapped, so shared by every lane) folded into the lane
    axis, each lane's block contiguous."""
    if d is None:
        a = a.unsqueeze(0).expand(B, *a.shape)
    else:
        a = a.movedim(d, 0)
    a = a.reshape(B * a.shape[1], *a.shape[2:])
    return a if a[0].is_contiguous() else a.contiguous()


def _vmap_rule(op, n_out):
    """The op's vmap rule: one call over B x L lanes, the outputs split
    back into (B, L, ...)."""
    def rule(info, in_dims, *args):
        B = info.batch_size
        flat = [_lane_major(a, d, B) if isinstance(a, torch.Tensor) else a
                for a, d in zip(args, in_dims)]
        outs = op(*flat)
        return (tuple(o.reshape(B, -1, *o.shape[1:]) for o in outs),
                (0,) * n_out)
    return rule


image_op = torch.library.custom_op(IMAGE_OP, _image_lanes_plain,
                                   mutates_args=(), schema=_IMAGE_SCHEMA)
image_op.register_kernel("cuda")(_image_launch)
image_op.register_fake(_image_fake)
torch.library.register_vmap(IMAGE_OP, _vmap_rule(image_op, 4))

imu_op = torch.library.custom_op(IMU_OP, _imu_lanes_plain, mutates_args=(),
                                 schema=_IMU_SCHEMA)
imu_op.register_kernel("cuda")(_imu_launch)
imu_op.register_fake(_imu_fake)
torch.library.register_vmap(IMU_OP, _vmap_rule(imu_op, 3))

image_res_op = torch.library.custom_op(IMAGE_RES_OP, _image_res_lanes_plain,
                                       mutates_args=(),
                                       schema=_IMAGE_RES_SCHEMA)
image_res_op.register_kernel("cuda")(_image_res_launch)
image_res_op.register_fake(_image_res_fake)
torch.library.register_vmap(IMAGE_RES_OP, _vmap_rule(image_res_op, 2))

imu_res_op = torch.library.custom_op(IMU_RES_OP, _imu_res_lanes_plain,
                                     mutates_args=(), schema=_IMU_RES_SCHEMA)
imu_res_op.register_kernel("cuda")(_imu_res_launch)
imu_res_op.register_fake(_imu_res_fake)
torch.library.register_vmap(IMU_RES_OP, _vmap_rule(imu_res_op, 2))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _const(x, dtype, device, shape):
    """A shared constant (tensor or number) as a lane-axis-1 tensor of
    `dtype` (a tensor of that dtype is not copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype).reshape(1, *shape)
    return torch.full((1, *shape), float(x), dtype=dtype, device=device)


def image_residual_inputs(params: WindowParams, img: ImageFactors, ext,
                          sqrt_info):
    """The image residual op's tensor inputs for one window (lane axis
    1)."""
    dt, dev = params.knots_p.dtype, params.knots_p.device
    one = [x.unsqueeze(0) for x in (
        params.knots_q, params.knots_p, params.dinv, params.ld, img.i0_i,
        img.f_i, img.row_i, img.pt_i, img.i0_j, img.f_j, img.row_j,
        img.pt_j, img.lm_idx)]
    return (*one, _const(ext.q_CtoI, dt, dev, (4,)),
            _const(ext.p_CinI, dt, dev, (3,)), _const(sqrt_info, dt, dev, ()))


def imu_residual_inputs(params: WindowParams, imu: ImuFactors, gravity,
                        imu_info):
    """The IMU residual op's tensor inputs for one window (lane axis 1)."""
    dt, dev = params.knots_p.dtype, params.knots_p.device
    one = [x.unsqueeze(0) for x in (
        params.knots_q, params.knots_p, params.bg, params.ba, imu.i0, imu.u,
        imu.gyro, imu.accel, imu.bias_idx)]
    return (*one, _const(gravity, dt, dev, (3,)),
            _const(imu_info, dt, dev, (6,)))


def image_inputs(params: WindowParams, img: ImageFactors, active, ext,
                 sqrt_info):
    """The image op's tensor inputs for one window (lane axis 1): the
    residual op's and the mask."""
    ts = image_residual_inputs(params, img, ext, sqrt_info)
    return (*ts[:IMAGE_ACTIVE], active.unsqueeze(0), *ts[IMAGE_ACTIVE:])


def imu_inputs(params: WindowParams, imu: ImuFactors, active, gravity,
               imu_info):
    """The IMU op's tensor inputs for one window (lane axis 1)."""
    ts = imu_residual_inputs(params, imu, gravity, imu_info)
    return (*ts[:IMU_ACTIVE], active.unsqueeze(0), *ts[IMU_ACTIVE:])


def image_factor_rows_op(params: WindowParams, img: ImageFactors, active,
                         ext, sqrt_info, cauchy_c: float,
                         cfg: WindowConfig) -> ImageRows:
    """`image_factor_rows` through the custom op, on any device."""
    out = image_op(*image_inputs(params, img, active, ext, sqrt_info),
                   cfg.KW, cfg.NB, float(cfg.dt), float(cauchy_c))
    return ImageRows(*(o[0] for o in out))


def imu_factor_rows_op(params: WindowParams, imu: ImuFactors, active,
                       gravity, imu_info, cfg: WindowConfig) -> ImuRows:
    """`imu_factor_rows` through the custom op, on any device."""
    out = imu_op(*imu_inputs(params, imu, active, gravity, imu_info),
                 cfg.KW, cfg.NB, float(cfg.dt))
    return ImuRows(*(o[0] for o in out))


def image_factor_rows(params: WindowParams, img: ImageFactors, active, ext,
                      sqrt_info, cauchy_c: float,
                      cfg: WindowConfig) -> ImageRows:
    """Every image factor's rows, weighted residual, landmark column and
    cost (see `image_factor_rows_plain`). CPU tensors take the plain
    version; CUDA tensors launch K2 once, for float32 or float64 and int32
    or int64 indices, or raise."""
    dev = params.knots_p.device
    if dev.type == "cpu":
        return image_factor_rows_plain(params, img, active, ext, sqrt_info,
                                       cauchy_c, cfg)
    _require_cuda("image_factor_rows", dev)
    return image_factor_rows_op(params, img, active, ext, sqrt_info,
                                cauchy_c, cfg)


def imu_factor_rows(params: WindowParams, imu: ImuFactors, active, gravity,
                    imu_info, cfg: WindowConfig) -> ImuRows:
    """Every IMU factor's masked rows, residual and squared norm (see
    `imu_factor_rows_plain`). CPU tensors take the plain version; CUDA
    tensors launch K3 once, or raise."""
    dev = params.knots_p.device
    if dev.type == "cpu":
        return imu_factor_rows_plain(params, imu, active, gravity, imu_info,
                                     cfg)
    _require_cuda("imu_factor_rows", dev)
    return imu_factor_rows_op(params, imu, active, gravity, imu_info, cfg)


def image_factor_residuals_op(params: WindowParams, img: ImageFactors, ext,
                              sqrt_info, cauchy_c: float,
                              cfg: WindowConfig) -> ImageResiduals:
    """`image_factor_residuals` through the custom op, on any device."""
    out = image_res_op(*image_residual_inputs(params, img, ext, sqrt_info),
                       cfg.KW, cfg.NB, float(cfg.dt), float(cauchy_c))
    return ImageResiduals(*(o[0] for o in out))


def imu_factor_residuals_op(params: WindowParams, imu: ImuFactors, gravity,
                            imu_info, cfg: WindowConfig) -> ImuResiduals:
    """`imu_factor_residuals` through the custom op, on any device."""
    out = imu_res_op(*imu_residual_inputs(params, imu, gravity, imu_info),
                     cfg.KW, cfg.NB, float(cfg.dt))
    return ImuResiduals(*(o[0] for o in out))


def image_factor_residuals(params: WindowParams, img: ImageFactors, ext,
                           sqrt_info, cauchy_c: float,
                           cfg: WindowConfig) -> ImageResiduals:
    """Every image factor's raw residual and rho(|r|^2), unmasked (see
    `image_factor_residuals_plain`). CPU tensors take the plain version;
    CUDA tensors launch K2's residual instance once, or raise."""
    dev = params.knots_p.device
    if dev.type == "cpu":
        return image_factor_residuals_plain(params, img, ext, sqrt_info,
                                            cauchy_c, cfg)
    _require_cuda("image_factor_residuals", dev)
    return image_factor_residuals_op(params, img, ext, sqrt_info, cauchy_c,
                                     cfg)


def imu_factor_residuals(params: WindowParams, imu: ImuFactors, gravity,
                         imu_info, cfg: WindowConfig) -> ImuResiduals:
    """Every IMU factor's raw residual and |r|^2, unmasked (see
    `imu_factor_residuals_plain`). CPU tensors take the plain version;
    CUDA tensors launch K3's residual instance once, or raise."""
    dev = params.knots_p.device
    if dev.type == "cpu":
        return imu_factor_residuals_plain(params, imu, gravity, imu_info,
                                          cfg)
    _require_cuda("imu_factor_residuals", dev)
    return imu_factor_residuals_op(params, imu, gravity, imu_info, cfg)


_COUNTED = {
    "image_factor_rows": (image_factor_rows, "launches"),
    "imu_factor_rows": (imu_factor_rows, "launches"),
    "image_factor_rows_plain": (image_factor_rows_plain, "calls"),
    "imu_factor_rows_plain": (imu_factor_rows_plain, "calls"),
    "image_factor_residuals": (image_factor_residuals, "launches"),
    "imu_factor_residuals": (imu_factor_residuals, "launches"),
    "image_factor_residuals_plain": (image_factor_residuals_plain, "calls"),
    "imu_factor_residuals_plain": (imu_factor_residuals_plain, "calls")}


def reset_counts():
    """Set every launch and plain-call count of this module to 0."""
    for fn, attr in _COUNTED.values():
        setattr(fn, attr, 0)


def _counts():
    """Every count of this module by name: the launches of K2
    (`image_factor_rows`), K3 (`imu_factor_rows`) and their residual
    instances (`*_factor_residuals`), and the runs of their plain
    versions."""
    return {k: getattr(fn, attr) for k, (fn, attr) in _COUNTED.items()}


def _add_counts(delta):
    for k, v in delta.items():
        fn, attr = _COUNTED[k]
        setattr(fn, attr, getattr(fn, attr) + v)


reset_counts()
counts = graphs.register_counter(_counts, _add_counts)
