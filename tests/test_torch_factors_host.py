"""K2 and K3's own code (`ctrlvio_tpu_torch/csrc/factors.cu`) on the CPU:
`tests/torch_factors_host.cpp` includes the source and runs each kernel's
phases block by block and thread by thread in the kernels' geometry (the
barriers between phases as a block-wide step, the block's shared struct
poisoned with NaN bytes), through the same C entry points as the CUDA
library. Held to the plain versions (`ops/factor_kernels.py`) on
`tests/test_torch_factor_kernels.py`'s window: float64 within 1e-12 of
each output's largest entry, float32 within `chip_smoke.FACTOR_TOL`;
marg_mode off and on, int32 and int64 indices, two lanes sharing the
factor inputs at lane stride 0, and slot counts that leave the last block
ragged and a lane's slots straddling two blocks, one slot; and rebuilt
with other geometries (`tools/factor_geometry.py`'s variants) the kernels
give the same bits. The harness builds with g++ into a temporary
directory (~4 s a build); without g++ the tests skip."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import FACTOR_TOL
from ctrlvio_tpu_torch.ops import factor_kernels as fk
from ctrlvio_tpu_torch.ops import so3
from ctrlvio_tpu_torch.solver import layout as tlayout
from ctrlvio_tpu_torch.tools.factor_geometry import variant_source
from tests.test_torch_factor_kernels import inputs, torch_args
from tests.test_torch_solver import TCFG, build_problem
from tests.torch_parity import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
HARNESS = REPO / "tests" / "torch_factors_host.cpp"
INCLUDE = '#include "../ctrlvio_tpu_torch/csrc/factors.cu"'
F64_TOL = 1e-12
TOL = {torch.float64: F64_TOL, torch.float32: FACTOR_TOL[torch.float32]}
DTYPES = {torch.float64: np.float64, torch.float32: np.float32}


def build(out_dir, source=None):
    """The harness built with g++ into `out_dir` and loaded, its entry
    points declared; `source` replaces `factors.cu`'s text."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' host harness")
    harness = HARNESS
    if source is not None:
        (out_dir / "factors.cu").write_text(source)
        harness = out_dir / HARNESS.name
        harness.write_text(HARNESS.read_text().replace(
            INCLUDE, '#include "factors.cu"'))
    lib_path = out_dir / "libfactors_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2",
                    "-ffp-contract=off", "-shared", "-fPIC", "-o",
                    str(lib_path), str(harness)], check=True,
                   capture_output=True, text=True)
    lib = fk.declare(ctypes.CDLL(str(lib_path)))
    geo = (ctypes.c_int * 4)()
    lib.factor_geometry(geo)
    lib.image_slots, lib.imu_slots = geo[0], geo[2]
    return lib


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return build(tmp_path_factory.mktemp("factors_host"))


@pytest.fixture(scope="module")
def prob():
    return build_problem()


def run(lib, kind, ts, KW, NB, dt, c=0.0):
    """The harness's K2 (`kind` "image") or K3 on the op's inputs `ts`
    (each with a lane axis)."""
    return fk.call_rows(lib, kind == "image", ts, KW, NB, dt, c)


def window(pb, dtype, index, marg_mode, img_slots=slice(None),
           imu_slots=slice(None)):
    """The window in `dtype` with `index` indices, its factors cut to the
    slots `img_slots` and `imu_slots` select: (params, img, imu, active
    image slots, active IMU slots, ext, gravity, info, sqrt_info,
    cauchy_c)."""
    params, img, imu, ext, grav, info, w = torch_args(
        inputs(pb, DTYPES[dtype]))
    img = type(img)(*(x[img_slots] for x in img))
    imu = type(imu)(*(x[imu_slots] for x in imu))
    img = img._replace(**{f: getattr(img, f).to(index)
                          for f in ("i0_i", "i0_j", "lm_idx")})
    imu = imu._replace(**{f: getattr(imu, f).to(index)
                          for f in ("i0", "bias_idx")})
    act_i = (img.valid & img.marg_drop) if marg_mode else img.valid
    act_m = (imu.valid & imu.marg_drop) if marg_mode else imu.valid
    c = 1.0 if marg_mode else tlayout.SolveOptions().cauchy_c
    return params, img, imu, act_i, act_m, ext, grav, info, w, c


def lane_inputs(win, params_lanes=None):
    """The ops' inputs for one lane, or for len(params_lanes) lanes whose
    parameters are stacked and whose every other input is the lane-1
    input expanded (lane stride 0)."""
    params, img, imu, act_i, act_m, ext, grav, info, w, _ = win
    ins_i = list(fk.image_inputs(params, img, act_i, ext, w))
    ins_m = list(fk.imu_inputs(params, imu, act_m, grav, info))
    if params_lanes is None:
        return ins_i, ins_m
    L = len(params_lanes)
    P = type(params)(*(torch.stack(f) for f in zip(*params_lanes)))
    for ins in (ins_i, ins_m):
        for k in range(len(ins)):
            ins[k] = ins[k].expand(L, *ins[k].shape[1:])
    ins_i[:4] = [P.knots_q, P.knots_p, P.dinv, P.ld]
    ins_m[:4] = [P.knots_q, P.knots_p, P.bg, P.ba]
    return ins_i, ins_m


def check(lib, ins_i, ins_m, c, tol):
    """Both kernels' outputs within `tol` of each output's largest entry
    of the plain versions run lane by lane."""
    KW, NB, dt = TCFG.KW, TCFG.NB, TCFG.dt
    for kind, ins, plain in (
            ("image", ins_i, lambda: fk._image_lanes_plain(*ins_i, KW, NB,
                                                           dt, c)),
            ("imu", ins_m, lambda: fk._imu_lanes_plain(*ins_m, KW, NB, dt))):
        got = run(lib, kind, ins, KW, NB, dt, c)
        ref = plain()
        for a, b in zip(got, ref):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert bool(torch.isfinite(a).all())
            scale = float(b.double().abs().max())
            err = float((a.double() - b.double()).abs().max())
            assert err <= tol * max(scale, 1e-300), (kind, err, scale)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("index", [torch.int64, torch.int32])
@pytest.mark.parametrize("marg_mode", [False, True])
def test_kernel_phases_match_plain_versions(host, prob, dtype, index,
                                            marg_mode):
    """One window, every slot: K2 and K3 against their plain versions."""
    win = window(prob, dtype, index, marg_mode)
    check(host, *lane_inputs(win), win[-1], TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_two_lanes_sharing_inputs_at_stride_zero(host, prob, dtype):
    """Two lanes of their own parameters, every factor input and constant
    shared at lane stride 0: each lane equals its plain version."""
    win = window(prob, dtype, torch.int64, False)
    params = win[0]
    rng = np.random.default_rng(5)
    other = params._replace(
        knots_q=so3.boxplus(params.knots_q, torch.tensor(
            rng.normal(size=(TCFG.KW, 3)) * 0.01, dtype=dtype)),
        knots_p=params.knots_p + torch.tensor(
            rng.normal(size=(TCFG.KW, 3)) * 0.01, dtype=dtype))
    ins_i, ins_m = lane_inputs(win, [params, other])
    assert ins_i[4].stride(0) == 0 and ins_m[4].stride(0) == 0
    check(host, ins_i, ins_m, win[-1], TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ragged_blocks_and_lanes_straddling_them(host, prob, dtype):
    """Slot counts that are no multiple of a block's slots, one lane and
    two (the second lane's first slot in the middle of a block)."""
    n_img, n_imu = host.image_slots * 9 + 5, host.imu_slots * 11 + 3
    win = window(prob, dtype, torch.int64, False, slice(n_img),
                 slice(n_imu))
    assert win[1].i0_i.shape[0] == n_img and win[2].i0.shape[0] == n_imu
    check(host, *lane_inputs(win), win[-1], TOL[dtype])
    params = win[0]
    other = params._replace(ld=params.ld * 1.1,
                            knots_p=params.knots_p + 0.01)
    check(host, *lane_inputs(win, [params, other]), win[-1], TOL[dtype])


def test_one_slot(host, prob):
    """n = 1, a valid slot of each kind: one block, most of its threads
    idle."""
    a = int(np.flatnonzero(prob["img"].valid)[0])
    b = int(np.flatnonzero(prob["imu"].valid)[0])
    win = window(prob, torch.float64, torch.int64, False, slice(a, a + 1),
                 slice(b, b + 1))
    check(host, *lane_inputs(win), win[-1], F64_TOL)


@pytest.mark.parametrize("variant", ["32x4/8x16:rolled", "16x2/2x16"])
def test_geometry_does_not_change_the_bits(host, prob, tmp_path, variant):
    """The kernels rebuilt with another geometry (`tools/factor_geometry.
    py`'s variants: threads a slot, slots a block, the math's loops
    rolled) give the same outputs bit for bit, f32 and f64, on a slot
    count that leaves both geometries' last blocks ragged."""
    other = build(tmp_path, variant_source(
        (REPO / "ctrlvio_tpu_torch" / "csrc" / "factors.cu").read_text(),
        variant))
    assert (other.image_slots, other.imu_slots) != (host.image_slots,
                                                    host.imu_slots)
    KW, NB, dt = TCFG.KW, TCFG.NB, TCFG.dt
    for dtype in (torch.float32, torch.float64):
        win = window(prob, dtype, torch.int64, False, slice(317),
                     slice(187))
        ins_i, ins_m = lane_inputs(win)
        as_int = torch.int32 if dtype == torch.float32 else torch.int64
        for kind, ins in (("image", ins_i), ("imu", ins_m)):
            a = run(host, kind, ins, KW, NB, dt, win[-1])
            b = run(other, kind, ins, KW, NB, dt, win[-1])
            assert all(torch.equal(x.view(as_int), y.view(as_int))
                       for x, y in zip(a, b))
