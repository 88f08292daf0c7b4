"""K2's, K3's and K5's own code (`ctrlvio_tpu_torch/csrc/factors.cu`) on
the CPU:
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
give the same bits. K5 (`residual_summary`, the window's residual
summary) is held to `residual_summary_plain` the same way, each of its
five outputs within the tolerance of its largest entry: int32 and int64
indices, two lanes sharing inputs at stride 0, ragged last blocks with a
lane's slots over several blocks, one slot; its blocks arriving in other
orders (the lane's last block writes the outputs: the bits do not
change); a lane of more blocks than its finish stages at a time; every
mask off (the clamps give 0). `tools/summary_split.py`'s cuts of K5's
steps each leave a source that compiles. The harness builds with g++
into a temporary directory (~4 s a build); without g++ the tests skip."""

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
    lib.residual_summary_host_order.argtypes = [ctypes.c_int]
    geo = (ctypes.c_int * 9)()
    lib.factor_geometry(geo)
    lib.image_slots, lib.imu_slots = geo[0], geo[2]
    lib.summary_image_slots, lib.summary_imu_slots = geo[4], geo[5]
    lib.summary_finish_blocks = geo[8]
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


def summary_window(pb, dtype, index, img_slots=slice(None),
                   imu_slots=slice(None), masks=True, seed=9):
    """`window`'s factors with bias pairs (`build_problem`'s sqrt info,
    every fourth pair masked) and a prior drawn from `seed` (two thirds of
    J's rows drawn, row 5 and the rest zero; the linearization point near
    the parameters): (params, img, imu, bias, prior, ext, gravity, info,
    sqrt_info, cauchy_c). masks=False: every mask off, J and r0 zero."""
    params, img, imu, _, _, ext, grav, info, w, c = window(
        pb, dtype, index, False, img_slots, imu_slots)
    rng = np.random.default_rng(seed)
    KW, NB, C = TCFG.KW, TCFG.NB, TCFG.C

    def t(x):
        return torch.tensor(np.asarray(x), dtype=dtype)

    valid = np.arange(NB - 1) % 4 != 3
    bias = tlayout.BiasFactors(t(pb["bias"].sqrt_info), torch.tensor(valid))
    n = 2 * C // 3
    J = np.zeros((C, C))
    J[:n] = rng.normal(size=(n, C)) * 0.1
    J[5] = 0.0
    r0 = np.r_[rng.normal(size=n) * 0.1, np.zeros(C - n)]
    prior = tlayout.PriorFactor(
        J=t(J), r0=t(r0),
        knots_q0=so3.boxplus(params.knots_q, t(rng.normal(size=(KW, 3))
                                               * 0.01)),
        knots_p0=params.knots_p - t(rng.normal(size=(KW, 3)) * 0.01),
        bg0=params.bg * 0.5, ba0=params.ba * 0.5, ld0=params.ld * 0.9)
    if not masks:
        img = img._replace(valid=torch.zeros_like(img.valid))
        imu = imu._replace(valid=torch.zeros_like(imu.valid))
        bias = bias._replace(valid=torch.zeros_like(bias.valid))
        prior = prior._replace(J=torch.zeros_like(prior.J),
                               r0=torch.zeros_like(prior.r0))
    return params, img, imu, bias, prior, ext, grav, info, w, c


# the summary op's inputs that are the window's parameters: knots_q,
# knots_p, dinv, ld, bg, ba
SUMMARY_PARAMS = (0, 1, 2, 3, 17, 18)


def summary_inputs(win, params_lanes=None):
    """The summary op's inputs for one lane, or for len(params_lanes) lanes
    whose parameters are stacked and whose every other input is the lane-1
    input expanded (lane stride 0)."""
    ts = list(fk.summary_inputs(*win[:-1]))
    if params_lanes is None:
        return ts
    L = len(params_lanes)
    P = type(win[0])(*(torch.stack(f) for f in zip(*params_lanes)))
    ts = [x.expand(L, *x.shape[1:]) for x in ts]
    for k, x in zip(SUMMARY_PARAMS, (P.knots_q, P.knots_p, P.dinv, P.ld,
                                     P.bg, P.ba)):
        ts[k] = x
    return ts


def run_summary(lib, ts, c, order=0):
    """The harness's K5 on the op's inputs `ts`, its blocks in `order`
    (`residual_summary_host_order`), its scratch filled with NaN; one
    block of each lane finished it."""
    lib.residual_summary_host_order(order)
    out = fk.call_summary(lib, ts, TCFG.KW, TCFG.NB, TCFG.dt, c,
                          fill=float("nan"))
    L = ts[0].shape[0]
    finishes = (ctypes.c_int * L)()
    lib.residual_summary_host_finishes(finishes)
    assert list(finishes) == [1] * L
    return out


def check_summary(lib, ts, c, tol, order=0):
    """K5's (L, 5) outputs: finite, each column within `tol` of the
    column's largest entry of the plain version run lane by lane. Returns
    them."""
    got = run_summary(lib, ts, c, order)
    ref = fk._summary_lanes_plain(*ts, TCFG.KW, TCFG.NB, TCFG.dt, c)
    assert got.shape == ref.shape == (ts[0].shape[0], 5)
    assert got.dtype == ref.dtype and bool(torch.isfinite(got).all())
    for k in range(5):
        a, b = got[:, k].double(), ref[:, k].double()
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        assert err <= tol * max(scale, 1e-300), (k, err, scale)
    return got


def other_params(params, seed):
    """Another lane's parameters: the knots, depths and biases moved."""
    rng = np.random.default_rng(seed)
    dt = params.knots_p.dtype
    return params._replace(
        knots_q=so3.boxplus(params.knots_q, torch.tensor(
            rng.normal(size=(TCFG.KW, 3)) * 0.01, dtype=dt)),
        knots_p=params.knots_p + torch.tensor(
            rng.normal(size=(TCFG.KW, 3)) * 0.01, dtype=dt),
        dinv=params.dinv * 1.05, bg=params.bg + 1e-3, ld=params.ld * 1.1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("index", [torch.int64, torch.int32])
def test_summary_phases_match_plain_version(host, prob, dtype, index):
    """One window, every slot: K5's summary against its plain version
    (`residual_summary_plain`), the image, IMU and bias sums over the
    valid factors, the prior's over every row."""
    win = summary_window(prob, dtype, index)
    assert 0 < int(win[1].valid.sum()) < win[1].valid.numel()
    got = check_summary(host, summary_inputs(win), win[-1], TOL[dtype])
    assert bool((got[0, :4] > 0).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_summary_two_lanes_sharing_inputs_at_stride_zero(host, prob, dtype):
    """Two lanes of their own parameters, every other input shared at lane
    stride 0: each lane equals its plain version; the lanes differ."""
    win = summary_window(prob, dtype, torch.int64)
    ts = summary_inputs(win, [win[0], other_params(win[0], 6)])
    assert ts[4].stride(0) == 0 and ts[29].stride(0) == 0
    got = check_summary(host, ts, win[-1], TOL[dtype])
    assert not torch.equal(got[0], got[1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_summary_ragged_blocks_and_lanes_over_several(host, prob, dtype):
    """Slot counts that are no multiple of a block's slots, so that a
    lane's image and IMU slots span several blocks and its last of each is
    ragged, one lane and two; and one slot of each kind."""
    n_img = host.summary_image_slots * 3 + 5
    n_imu = host.summary_imu_slots + 13
    win = summary_window(prob, dtype, torch.int64, slice(n_img),
                         slice(n_imu))
    assert win[1].i0_i.shape[0] == n_img and win[2].i0.shape[0] == n_imu
    check_summary(host, summary_inputs(win), win[-1], TOL[dtype])
    check_summary(host, summary_inputs(win, [win[0], other_params(win[0],
                                                                  7)]),
                  win[-1], TOL[dtype])
    a = int(np.flatnonzero(prob["img"].valid)[0])
    b = int(np.flatnonzero(prob["imu"].valid)[0])
    win = summary_window(prob, dtype, torch.int64, slice(a, a + 1),
                         slice(b, b + 1))
    check_summary(host, summary_inputs(win), win[-1], TOL[dtype])


def test_summary_finish_over_several_steps(host, prob):
    """A lane of more blocks than the finish stages at a time (the image
    factors tiled): its sums carried from step to step, against the plain
    version, f32 and f64, in order and shuffled."""
    for dtype in (torch.float64, torch.float32):
        win = summary_window(prob, dtype, torch.int64)
        img = win[1]
        reps = -(-host.summary_finish_blocks * host.summary_image_slots
                 // img.i0_i.shape[0]) + 1
        win = (win[0], type(img)(*(torch.cat([x] * reps) for x in img)),
               *win[2:])
        ts = summary_inputs(win)
        blocks = host.residual_summary_blocks(ts[4].shape[1], ts[19].shape[1],
                                              TCFG.KW, TCFG.NB)
        assert blocks > host.summary_finish_blocks
        first = check_summary(host, ts, win[-1], TOL[dtype])
        assert torch.equal(first, check_summary(host, ts, win[-1],
                                                TOL[dtype], 2))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_summary_block_order_does_not_change_the_bits(host, prob, order):
    """The blocks arriving in another order (each lane's reversed, or
    every lane's blocks shuffled together) give the bits of the blocks in
    order, f32 and f64: the lane's last block, whichever it is, adds the
    partials in block order. A block that wrote the lane's outputs before
    every other block had written its partials (block 0 in order 0, the
    last block in order 1) would read the scratch's NaN."""
    for dtype in (torch.float64, torch.float32):
        win = summary_window(prob, dtype, torch.int32)
        ts = summary_inputs(win, [win[0], other_params(win[0], 8),
                                  other_params(win[0], 9)])
        first = check_summary(host, ts, win[-1], TOL[dtype])
        again = check_summary(host, ts, win[-1], TOL[dtype], order)
        assert torch.equal(first, again)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_summary_with_every_mask_off(host, prob, dtype):
    """No valid image, IMU or bias factor and a zero prior: the clamps
    give 0 for every RMS and the cost is 0, not NaN, as in the plain
    version."""
    win = summary_window(prob, dtype, torch.int64, masks=False)
    got = check_summary(host, summary_inputs(win), win[-1], TOL[dtype])
    assert torch.equal(got, torch.zeros_like(got))


def test_summary_split_cuts_leave_a_source_that_builds(tmp_path):
    """`tools/summary_split.py`'s cuts of K5's steps: each leaves a
    `factors.cu` the host harness compiles with (g++ -fsyntax-only), and
    cutting a function the source does not define raises."""
    from ctrlvio_tpu_torch.tools import summary_split

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' host harness")
    src = (REPO / "ctrlvio_tpu_torch" / "csrc" / "factors.cu").read_text()
    harness = HARNESS.read_text()
    for cut in summary_split.DEFAULT_CUTS.split(","):
        cu = tmp_path / f"{cut}.cu"
        cu.write_text(summary_split.cut_source(src, cut))
        cpp = tmp_path / f"{cut}.cpp"
        cpp.write_text(harness.replace(INCLUDE, f'#include "{cu.name}"'))
        subprocess.run([gxx, "-x", "c++", "-std=c++17", "-fsyntax-only",
                        str(cpp)], check=True, capture_output=True)
    assert summary_split.cut_source(src, "full") == src
    with pytest.raises(ValueError):
        summary_split.cut_source(src.replace("HD void summary_fold(",
                                             "HD void summary_fold_("),
                                 "no_trees")

