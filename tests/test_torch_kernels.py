"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions: K1 (`csrc/lk.cu`), K2 and K3 and K5 (the residual
summary; `csrc/factors.cu`), K4 (`csrc/lm_accept.cu`, the
LM's accept step, and the WHILE node whose condition it sets). Every
test here needs a CUDA
device and skips without one. The file imports neither JAX nor the JAX package, so that it runs on
a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py -q -m gpu --noconftest \
        -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from chip_smoke import (CASE_LEVELS, FACTOR_TOL, FACTOR_WINDOWS, LOOP_ITERS,
                        SEARCH_MARGIN, SUMMARY_TOL, TRACK_CASES, col_rel_err,
                        factor_calls, factor_window, k4_loop, loop_args,
                        rel_err, stack_tree, summary_calls, textured_pair,
                        track_case, tree_err)
from ctrlvio_tpu_torch.frontend import klt
from ctrlvio_tpu_torch.ops import factor_kernels as fk
from ctrlvio_tpu_torch.ops import lk
from ctrlvio_tpu_torch.ops import lm_kernels as k4
from ctrlvio_tpu_torch.parallel.batch import stack
from ctrlvio_tpu_torch.sim.windows import (ACCEPT_CASES, accept_case,
                                           summary_window)
from ctrlvio_tpu_torch.utils import graphs

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("level", [0, 1, 2])
def test_k1_matches_plain_version(cuda, level):
    """K1's one-level case at each pyramid level of a 1280x1024 pair, N=150, 10 iterations:
    within 1e-3 px of the plain version where min_eig > 1e-4, min_eig
    within 1e-4 relative, the known shift recovered within 0.15 px, and
    one launch counted."""
    dx, dy = 2.4, -1.7
    img0, img1 = textured_pair(1024, 1280, dx, dy, seed=4)
    pyr0 = klt.pyramid(torch.tensor(img0, dtype=torch.float32, device=cuda), 3)
    pyr1 = klt.pyramid(torch.tensor(img1, dtype=torch.float32, device=cuda), 3)
    rng = np.random.default_rng(0)
    pts0 = np.stack([rng.uniform(40, 1240, 150), rng.uniform(40, 984, 150)], 1)
    pts = torch.tensor(pts0 / 2 ** level, dtype=torch.float32, device=cuda)
    a, b = pyr0[level], pyr1[level]
    launches = lk.lk_level.launches
    out, eig = lk.lk_level(a, b, pts, pts, iters=10)
    ref, eig_ref = lk.lk_level_plain(a, b, pts, pts, iters=10)
    torch.cuda.synchronize()
    assert lk.lk_level.launches == launches + 1
    good = eig_ref > 1e-4
    assert int(good.sum()) >= 75
    assert float((out - ref)[good].abs().max()) <= 1e-3
    assert float(((eig - eig_ref).abs() / eig_ref.abs()).max()) <= 1e-4
    flow = (out - pts)[good].median(dim=0).values.cpu().numpy()
    np.testing.assert_allclose(flow, np.array([dx, dy]) / 2 ** level,
                               atol=0.15)


def test_k1_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    img = torch.zeros((64, 80), dtype=torch.float32, device=cuda)
    pts = torch.full((4, 2), 30.0, dtype=torch.float32, device=cuda)
    launches = lk.lk_level.launches
    with pytest.raises(TypeError):
        lk.lk_level(img.double(), img.double(), pts.double(), pts.double())
    with pytest.raises(ValueError):
        lk.lk_level(img, img[:, :40], pts, pts)
    with pytest.raises(ValueError):
        lk.lk_level(img.t(), img.t(), pts, pts)
    with pytest.raises(ValueError):
        lk.lk_level(img, img, pts.cpu(), pts)
    with pytest.raises(ValueError):
        lk.lk_level(img, img, pts, pts, win=7)
    assert lk.lk_level.launches == launches


@pytest.mark.parametrize("case", TRACK_CASES)
def test_k1_track_matches_plain_version(cuda, case):
    """The fused forward-backward track (`chip_smoke.track_case`: three
    levels of a 1280x1024 pair, N=150, 10 iterations; four levels with
    init = pts, the classic tracker's track; two levels, the command
    line's) in one launch, counted under its level count: ok as
    the plain version's except within 1e-3 px of fb_thresh or of the
    in-bounds edge, or within 1e-4 relative of min_eig; positions within
    1e-3 px where both say ok; min_eig within 1e-4 relative; the known
    shift recovered within 0.15 px. The large motion moves most features
    beyond the staged search window at the coarsest level."""
    pyr0, pyr1, pts, init, shift = track_case(case, cuda)
    cfg = klt.KLTConfig(pred_levels=3)
    args = (pyr0, pyr1, pts, init, 10, lk.HALF, cfg.fb_thresh, cfg.min_eig)
    L = len(pyr0)
    assert L == CASE_LEVELS.get(case, 3)
    launches = lk.lk_track.launches
    by_levels = lk.lk_track.launches_by_levels.get(L, 0)
    out, ok, eig = lk.lk_track(*args)
    ref, ok_ref, eig_ref = lk.lk_track_plain(*args)
    back, _ = lk.lk_pass_plain(pyr1, pyr0, ref, pts, 10)
    torch.cuda.synchronize()
    assert lk.lk_track.launches == launches + 1
    assert lk.lk_track.launches_by_levels[L] == by_levels + 1
    H, W = pyr0[0].shape
    fb = torch.linalg.vector_norm(back - pts, dim=-1)
    edge = torch.stack([ref[:, 0] - 1.0, ref[:, 0] - (W - 1.0),
                        ref[:, 1] - 1.0, ref[:, 1] - (H - 1.0)], 1)
    near = (((fb - cfg.fb_thresh).abs() < 1e-3)
            | ((eig_ref - cfg.min_eig).abs() < 1e-4 * cfg.min_eig)
            | (edge.abs() < 1e-3).any(dim=1))
    assert not bool(((ok != ok_ref) & ~near).any())
    both = ok & ok_ref
    assert int(both.sum()) >= 75
    assert float((out - ref)[both].abs().max()) <= 1e-3
    assert float(((eig - eig_ref).abs() / eig_ref.abs()).max()) <= 1e-4
    flow = (out - pts)[ok].median(dim=0).values.cpu().numpy()
    np.testing.assert_allclose(flow, np.array(shift), atol=0.15)
    if case == "large_motion":
        g, _ = lk.lk_level_plain(pyr0[-1], pyr1[-1], pts / 4, init / 4, 10)
        moved = (g - init / 4).abs().max(dim=1).values
        assert int((moved > SEARCH_MARGIN + 1).sum()) >= 75


def test_k1_track_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    img = torch.zeros((64, 80), dtype=torch.float32, device=cuda)
    pyr = [img, torch.zeros((32, 40), dtype=torch.float32, device=cuda)]
    pts = torch.full((4, 2), 30.0, dtype=torch.float32, device=cuda)
    launches = lk.lk_track.launches
    with pytest.raises(TypeError):
        lk.lk_track([p.double() for p in pyr], pyr, pts, pts)
    with pytest.raises(ValueError):
        lk.lk_track(pyr, [img, img], pts, pts)
    with pytest.raises(ValueError):
        lk.lk_track(pyr, pyr[:1], pts, pts)
    with pytest.raises(ValueError):
        lk.lk_track(pyr * 3, pyr * 3, pts, pts)
    with pytest.raises(ValueError):
        lk.lk_track([img.t()], [img.t()], pts, pts)
    with pytest.raises(ValueError):
        lk.lk_track(pyr, pyr, pts, pts.cpu())
    with pytest.raises(ValueError):
        lk.lk_track(pyr, pyr, pts, pts[:3])
    with pytest.raises(ValueError):
        lk.lk_track(pyr, pyr, pts, pts, win=7)
    assert lk.lk_track.launches == launches


DTYPES = [torch.float32, torch.float64]


@pytest.mark.parametrize("window", sorted(FACTOR_WINDOWS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("marg_mode", [False, True])
def test_factor_kernels_match_plain_versions(cuda, window, dtype, marg_mode):
    """K2 and K3 on a window of the e2e sequence (`chip_smoke.
    factor_window`): every output within FACTOR_TOL (1e-4 in f32, 1e-10 in
    f64) of its largest entry, one launch counted a call."""
    cfg = FACTOR_WINDOWS[window]
    k2, p2, k3, p3 = factor_calls(factor_window(cfg, dtype, cuda), cfg,
                                  marg_mode)
    for kern, plain, counter in ((k2, p2, fk.image_factor_rows),
                                 (k3, p3, fk.imu_factor_rows)):
        n = counter.launches
        got = kern()
        assert counter.launches == n + 1
        ref = plain()
        torch.cuda.synchronize()
        assert rel_err(got, ref) <= FACTOR_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_factor_kernels_vmapped_equal_their_lanes(cuda, dtype):
    """Under torch.func.vmap over 3 windows (factors and parameters
    batched, constants shared) each kernel launches once, and each lane
    equals its own unbatched launch bit for bit."""
    cfg = FACTOR_WINDOWS["e2e"]
    lanes = [factor_window(cfg, dtype, cuda, seed=20 + k) for k in range(3)]
    ext, grav, info, w = lanes[0][3:]
    P, IMG, IMU = (stack([ln[k] for ln in lanes]) for k in range(3))

    def both(p, img, imu):
        return (*fk.image_factor_rows(p, img, img.valid, ext, w, 2.0, cfg),
                *fk.imu_factor_rows(p, imu, imu.valid, grav, info, cfg))

    n2, n3 = fk.image_factor_rows.launches, fk.imu_factor_rows.launches
    got = torch.func.vmap(both)(P, IMG, IMU)
    assert (fk.image_factor_rows.launches, fk.imu_factor_rows.launches) == (
        n2 + 1, n3 + 1)
    for k, ln in enumerate(lanes):
        for a, b in zip(got, both(*ln[:3])):
            assert torch.equal(a[k], b)


# slot counts no block size of K2 or K3 divides (both primes)
RAGGED = (761, 251)


def cut_window(window, img_slots, imu_slots):
    """The window with its image and IMU factors cut to the slots
    `img_slots` and `imu_slots` select."""
    params, img, imu, *rest = window
    return (params, type(img)(*(x[img_slots] for x in img)),
            type(imu)(*(x[imu_slots] for x in imu)), *rest)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cut", ["ragged", "one_slot"])
def test_factor_kernels_at_cut_slot_counts(cuda, dtype, cut):
    """K2 and K3 where the last block is ragged (the e2e window cut to
    RAGGED slots) and at n = 1 (one valid slot of each kind): within
    FACTOR_TOL of the plain versions, one launch a call."""
    cfg = FACTOR_WINDOWS["e2e"]
    window = factor_window(cfg, dtype, cuda)
    if cut == "ragged":
        sl = (slice(RAGGED[0]), slice(RAGGED[1]))
    else:
        a, b = (int(torch.nonzero(f.valid)[0]) for f in window[1:3])
        sl = (slice(a, a + 1), slice(b, b + 1))
    window = cut_window(window, *sl)
    for marg_mode in (False, True):
        k2, p2, k3, p3 = factor_calls(window, cfg, marg_mode)
        for kern, plain, counter in ((k2, p2, fk.image_factor_rows),
                                     (k3, p3, fk.imu_factor_rows)):
            n = counter.launches
            got = kern()
            assert counter.launches == n + 1
            ref = plain()
            torch.cuda.synchronize()
            assert got[0].shape == ref[0].shape
            assert rel_err(got, ref) <= FACTOR_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_factor_kernels_lanes_straddling_blocks(cuda, dtype):
    """Under torch.func.vmap over 3 windows cut to RAGGED slots, every
    lane after the first starts inside a block: one launch each, each
    lane equal bit for bit to its own launch."""
    cfg = FACTOR_WINDOWS["e2e"]
    sl = (slice(RAGGED[0]), slice(RAGGED[1]))
    lanes = [cut_window(factor_window(cfg, dtype, cuda, seed=30 + k), *sl)
             for k in range(3)]
    ext, grav, info, w = lanes[0][3:]
    P, IMG, IMU = (stack([ln[k] for ln in lanes]) for k in range(3))

    def both(p, img, imu):
        return (*fk.image_factor_rows(p, img, img.valid, ext, w, 2.0, cfg),
                *fk.imu_factor_rows(p, imu, imu.valid, grav, info, cfg))

    n2, n3 = fk.image_factor_rows.launches, fk.imu_factor_rows.launches
    got = torch.func.vmap(both)(P, IMG, IMU)
    assert (fk.image_factor_rows.launches, fk.imu_factor_rows.launches) == (
        n2 + 1, n3 + 1)
    for k, ln in enumerate(lanes):
        for a, b in zip(got, both(*ln[:3])):
            assert torch.equal(a[k], b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_factor_kernels_two_launches_equal(cuda, dtype):
    """Two launches on the same inputs give the same bits: no atomics, no
    order that changes from run to run."""
    cfg = FACTOR_WINDOWS["batch"]
    k2, _, k3, _ = factor_calls(factor_window(cfg, dtype, cuda), cfg, False)
    for kern in (k2, k3):
        a, b = kern(), kern()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


EDGES = ("clamped", "dinv", "z", "equal_knots", "masked")
# f32 holds the edges whose geometry is well conditioned: a landmark at
# |dinv| < 1e-5 (a point ~1e5 m away) or at |z| < 1e-6 leaves its
# landmark column a difference of nearly equal terms, ~1e-3 of the largest
# entry in f32 in either version, and the order of operations decides it
EDGES_BY_DTYPE = {torch.float32: ("clamped", "equal_knots", "masked"),
                  torch.float64: EDGES}


def edge_window(cuda, dtype, edges):
    """The e2e window with edge slots of the kinds in `edges`: "clamped",
    one image slot's segment i and another's segment j beyond the window
    (clamped to KW - 4), an IMU slot's too; "dinv", a landmark at
    |dinv| < 1e-5 of each sign; "z", a slot observed twice at one time
    whose point lies 5e-7 in front of the camera (|z| < 1e-6);
    "equal_knots", knots 10..13 equal and an image and an IMU slot on
    them (every small-angle branch); "masked", valid slots masked."""
    cfg = FACTOR_WINDOWS["e2e"]
    params, img, imu, ext, grav, info, w = factor_window(cfg, dtype, cuda)
    a, b, c, d, e, f, g = torch.nonzero(img.valid).flatten().tolist()[:7]
    i0_i, i0_j, dinv, kq = (x.clone() for x in (img.i0_i, img.i0_j,
                                                params.dinv, params.knots_q))
    f_i, f_j, row_i, row_j, pt_i, valid_i = (x.clone() for x in (
        img.f_i, img.f_j, img.row_i, img.row_j, img.pt_i, img.valid))
    m_i0, valid_m = imu.i0.clone(), imu.valid.clone()
    mv = torch.nonzero(imu.valid).flatten().tolist()
    if "clamped" in edges:
        i0_i[a] = cfg.KW + 3
        i0_j[g] = cfg.KW + 7
        m_i0[mv[0]] = cfg.KW + 2
    if "dinv" in edges:
        dinv[img.lm_idx[b]], dinv[img.lm_idx[c]] = 3e-6, -2e-6
    if "equal_knots" in edges:
        kq[11:14] = kq[10]
        i0_i[d], i0_j[d] = 10, 10
        f_i[d] = f_j[d] = 0.25
        row_i[d] = row_j[d] = 0.0
        m_i0[mv[1]] = 10
    if "z" in edges:
        i0_j[e], f_j[e], row_j[e] = i0_i[e], f_i[e], row_i[e]
        dinv[img.lm_idx[e]] = 1.0
        pt_i[e] = torch.tensor([1e-3, 2e-3, 5e-7], dtype=dtype)
    if "masked" in edges:
        valid_i[f] = False
        valid_m[mv[2]] = False
    img = img._replace(i0_i=i0_i, i0_j=i0_j, f_i=f_i, f_j=f_j, row_i=row_i,
                       row_j=row_j, pt_i=pt_i, valid=valid_i)
    imu = imu._replace(i0=m_i0, valid=valid_m)
    params = params._replace(knots_q=kq, dinv=dinv)
    return cfg, (params, img, imu, ext, grav, info, w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_factor_kernels_at_edge_slots(cuda, dtype):
    """K2 and K3 against their plain versions at the edge slots of
    `edge_window` (`EDGES_BY_DTYPE`), marg_mode off and on: finite, within
    FACTOR_TOL, the masked slots' rows, residuals and costs zero."""
    cfg, window = edge_window(cuda, dtype, EDGES_BY_DTYPE[dtype])
    for marg_mode in (False, True):
        k2, p2, k3, p3 = factor_calls(window, cfg, marg_mode)
        for kern, plain in ((k2, p2), (k3, p3)):
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            assert all(bool(torch.isfinite(x).all()) for x in got)
            assert rel_err(got, ref) <= FACTOR_TOL[dtype]
    img, imu = window[1], window[2]
    k2, _, k3, _ = factor_calls(window, cfg, False)
    off_i, off_m = ~img.valid, ~imu.valid
    for x in k2():
        assert not bool(x[off_i].any())
    for x in k3():
        assert not bool(x[off_m].any())


def test_factor_wrappers_reject_what_the_kernels_do_not_take(cuda):
    cfg = FACTOR_WINDOWS["e2e"]
    params, img, imu, ext, grav, info, w = factor_window(
        cfg, torch.float32, cuda)
    n2, n3 = fk.image_factor_rows.launches, fk.imu_factor_rows.launches

    def k2(p=params, im=img):
        return fk.image_factor_rows(p, im, im.valid, ext, w, 2.0, cfg)

    def k3(p=params, mu=imu):
        return fk.imu_factor_rows(p, mu, mu.valid, grav, info, cfg)

    half = params._replace(**{f: getattr(params, f).half() for f in (
        "knots_q", "knots_p", "bg", "ba", "dinv", "ld")})
    with pytest.raises(TypeError):
        k2(p=half)
    with pytest.raises(TypeError):
        k3(p=half)
    with pytest.raises(TypeError):
        k2(im=img._replace(lm_idx=img.lm_idx.to(torch.int32)))
    with pytest.raises(TypeError):
        k2(im=img._replace(f_i=img.f_i.double()))
    with pytest.raises(TypeError):
        k3(mu=imu._replace(i0=imu.i0.to(torch.int16),
                           bias_idx=imu.bias_idx.to(torch.int16)))
    strided = torch.empty((3, cfg.OBS), dtype=torch.float32,
                          device=cuda).t().copy_(img.pt_i)
    with pytest.raises(ValueError):
        k2(im=img._replace(pt_i=strided))
    with pytest.raises(ValueError):
        k2(im=img._replace(pt_j=img.pt_j.cpu()))
    with pytest.raises(ValueError):
        k3(mu=imu._replace(u=imu.u[:-1]))
    with pytest.raises(ValueError):
        k2(p=params._replace(knots_q=params.knots_q[:-1]))
    assert (fk.image_factor_rows.launches,
            fk.imu_factor_rows.launches) == (n2, n3)


def cut_summary(window, img_slots, imu_slots):
    """A `summary_window` with its image and IMU factors cut."""
    params, img, imu, *rest = window
    return (params, type(img)(*(x[img_slots] for x in img)),
            type(imu)(*(x[imu_slots] for x in imu)), *rest)


@pytest.mark.parametrize("window", sorted(FACTOR_WINDOWS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_summary_kernel_matches_plain_version(cuda, window, dtype):
    """K5 on a summary window of the e2e sequence (`sim/windows.py::
    summary_window`: bias pairs and a prior), whole and cut to RAGGED
    slots (the last image and IMU blocks ragged): each of its five outputs
    within SUMMARY_TOL of the plain version's, one launch counted a
    call."""
    cfg = FACTOR_WINDOWS[window]
    whole = summary_window(cfg, dtype, cuda)
    for win in (whole, cut_summary(whole, slice(RAGGED[0]),
                                   slice(RAGGED[1]))):
        k5, p5 = summary_calls(win, cfg)
        n = fk.residual_summary.launches
        got = k5()
        assert fk.residual_summary.launches == n + 1
        ref = p5()
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (5,)
        assert bool(torch.isfinite(got).all())
        assert col_rel_err((got,), (ref,)) <= SUMMARY_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_summary_kernel_over_many_blocks(cuda, dtype):
    """K5 on the e2e summary window with its image factors tiled 6 times
    (4,608 slots: a lane of more blocks than the last block stages at a
    time): within SUMMARY_TOL of the plain version, two launches equal."""
    cfg = FACTOR_WINDOWS["e2e"]
    params, img, *rest = summary_window(cfg, dtype, cuda)
    win = (params, type(img)(*(torch.cat([x] * 6) for x in img)), *rest)
    k5, p5 = summary_calls(win, cfg)
    got, ref = k5(), p5()
    torch.cuda.synchronize()
    assert col_rel_err((got,), (ref,)) <= SUMMARY_TOL[dtype]
    assert torch.equal(got, k5())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cut", ["whole", "ragged"])
def test_summary_kernel_vmapped_equals_its_lanes(cuda, dtype, cut):
    """Under torch.func.vmap over 3 windows (parameters, factors and priors
    batched, constants shared; cut to RAGGED slots) K5 launches once, and
    each lane equals its own unbatched launch bit for bit."""
    cfg = FACTOR_WINDOWS["e2e"]
    lanes = [summary_window(cfg, dtype, cuda, seed=40 + k) for k in range(3)]
    if cut == "ragged":
        lanes = [cut_summary(ln, slice(RAGGED[0]), slice(RAGGED[1]))
                 for ln in lanes]
    ext, grav, info, w = lanes[0][5:]
    stacked = [stack([ln[k] for ln in lanes]) for k in range(5)]

    def one(*own):
        return fk.residual_summary(*own, ext, grav, info, w, 2.0, cfg)

    n = fk.residual_summary.launches
    got = torch.func.vmap(one)(*stacked)
    assert fk.residual_summary.launches == n + 1
    for k, ln in enumerate(lanes):
        assert torch.equal(got[k], one(*ln[:5]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_summary_kernel_at_edge_slots(cuda, dtype):
    """K5 at the edge slots of `edge_window` (`EDGES_BY_DTYPE`), with the
    summary window's bias pairs and prior: finite, within SUMMARY_TOL of
    the plain version, and two launches give the same bits; with every
    mask off and a zero prior, every output 0 (the clamps), not NaN."""
    cfg, window = edge_window(cuda, dtype, EDGES_BY_DTYPE[dtype])
    win = summary_window(cfg, dtype, cuda, window=window)
    k5, p5 = summary_calls(win, cfg)
    got, ref = k5(), p5()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert col_rel_err((got,), (ref,)) <= SUMMARY_TOL[dtype]
    assert torch.equal(got, k5())
    params, img, imu, bias, prior, *rest = win
    off = (params, img._replace(valid=torch.zeros_like(img.valid)),
           imu._replace(valid=torch.zeros_like(imu.valid)),
           bias._replace(valid=torch.zeros_like(bias.valid)),
           prior._replace(J=torch.zeros_like(prior.J),
                          r0=torch.zeros_like(prior.r0)), *rest)
    k5, p5 = summary_calls(off, cfg)
    got = k5()
    assert torch.equal(got, torch.zeros_like(got))
    assert torch.equal(p5(), got)


def test_residual_summary_on_the_card_matches_the_cpu(cuda):
    """`assemble.residual_rms` and `total_cost` on the card (through K5,
    one launch a call) against the same window on the CPU (the plain
    route), float64 within 1e-10 of each value; the tiny window's knots,
    biases and depths perturbed (at its ground truth the IMU residuals are
    rounding noise)."""
    from ctrlvio_tpu_torch.sim.tiny import tiny_problem
    from ctrlvio_tpu_torch.solver import assemble
    from ctrlvio_tpu_torch.solver.layout import SolveOptions

    out = {}
    for dev in ("cpu", cuda):
        pb = tiny_problem(torch.float64, device=dev)
        rng = np.random.default_rng(8)
        p = pb.params
        params = p._replace(
            knots_p=p.knots_p + torch.tensor(rng.normal(
                size=tuple(p.knots_p.shape)) * 0.01, device=dev),
            bg=p.bg + torch.tensor(rng.normal(size=tuple(p.bg.shape))
                                   * 1e-3, device=dev),
            dinv=p.dinv * 1.1)
        args = (params, pb.img, pb.imu, pb.bias, pb.prior, *pb.aux,
                pb.cfg, SolveOptions())
        n = fk.residual_summary.launches
        out[str(dev)] = (assemble.residual_rms(*args).cpu(),
                         assemble.total_cost(*args).cpu())
        assert fk.residual_summary.launches == n + (
            2 if dev == cuda else 0)
    (a, b), (c, d) = out["cpu"], out[str(cuda)]
    assert bool((a[:3] > 1e-6).all())
    torch.testing.assert_close(c, a, rtol=1e-10, atol=0)
    torch.testing.assert_close(d, b, rtol=1e-10, atol=0)


def test_summary_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cfg = FACTOR_WINDOWS["e2e"]
    params, img, imu, bias, prior, ext, grav, info, w = summary_window(
        cfg, torch.float32, cuda)
    n = fk.residual_summary.launches

    def k5(p=params, im=img, mu=imu, bi=bias, pr=prior):
        return fk.residual_summary(p, im, mu, bi, pr, ext, grav, info, w,
                                   2.0, cfg)

    half = params._replace(**{f: getattr(params, f).half() for f in (
        "knots_q", "knots_p", "bg", "ba", "dinv", "ld")})
    with pytest.raises(TypeError):
        k5(p=half)
    with pytest.raises(TypeError):
        k5(im=img._replace(lm_idx=img.lm_idx.to(torch.int32)))
    with pytest.raises(TypeError):
        k5(mu=imu._replace(u=imu.u.double()))
    with pytest.raises(TypeError):
        k5(bi=bias._replace(valid=bias.valid.float()))
    strided = torch.empty((3, cfg.MIMU), dtype=torch.float32,
                          device=cuda).t().copy_(imu.gyro)
    with pytest.raises(ValueError):
        k5(mu=imu._replace(gyro=strided))
    with pytest.raises(ValueError):
        k5(im=img._replace(pt_j=img.pt_j.cpu()))
    with pytest.raises(ValueError):
        k5(im=img._replace(f_j=img.f_j[:-1]))
    with pytest.raises(ValueError):
        k5(p=params._replace(bg=params.bg[:-1]))
    with pytest.raises(ValueError):
        k5(pr=prior._replace(J=prior.J[:-1]))
    assert fk.residual_summary.launches == n


def _accept_plain(st, trial, ne_t, cost_t, opts):
    return k4.accept_step_plain(st, trial, ne_t, cost_t, opts.lm_lambda_down,
                                opts.lm_lambda_up, opts.tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("in_place", [False, True])
def test_k4_matches_plain_version(cuda, dtype, in_place):
    """K4 at the e2e window in every accept case, the functional instance
    and the in-place one: the plain version's bits, one launch a call."""
    cfg = FACTOR_WINDOWS["e2e"]
    for case in ACCEPT_CASES:
        st, trial, ne_t, cost_t, opts = accept_case(cfg, dtype, cuda, case)
        ref = _accept_plain(st, trial, ne_t, cost_t, opts)
        work = graphs.clone(st) if in_place else st
        n = k4.accept_step.launches
        got = k4.accept_step(work, trial, ne_t, cost_t, opts,
                             in_place=in_place)
        assert k4.accept_step.launches == n + 1
        torch.cuda.synchronize()
        assert tree_err(got, ref) == 0.0, case
        assert (got is work) == in_place


@pytest.mark.parametrize("dtype", DTYPES)
def test_k4_vmapped_equals_its_lanes(cuda, dtype):
    """Under torch.func.vmap over 8 lanes of mixed cases K4 launches
    once, and each lane is the plain version's bits."""
    cfg = FACTOR_WINDOWS["e2e"]
    names = list(ACCEPT_CASES)
    lanes = [accept_case(cfg, dtype, cuda, names[k % len(names)], seed=k)
             for k in range(8)]
    opts = lanes[0][4]
    n = k4.accept_step.launches
    got = torch.func.vmap(
        lambda s, tr, ne, c: k4.accept_step(s, tr, ne, c, opts))(
        *[stack_tree([ln[k] for ln in lanes]) for k in range(4)])
    assert k4.accept_step.launches == n + 1
    for k, ln in enumerate(lanes):
        assert tree_err(graphs.tree_map(lambda t: t[k], got),
                        _accept_plain(*ln[:4], opts)) == 0.0


def test_k4_in_place_writes_nothing_on_a_rejection(cuda):
    """The in-place instance on a rejected and a done case leaves every
    leaf's bits as they were, and its arrival counter at zero."""
    cfg = FACTOR_WINDOWS["e2e"]
    for case in ("rejected", "done", "nan_cost_t"):
        st, trial, ne_t, cost_t, opts = accept_case(cfg, torch.float32,
                                                    cuda, case)
        before = graphs.clone(st)
        k4.accept_step(st, trial, ne_t, cost_t, opts, in_place=True)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in
                   zip(graphs.leaves(st)[:11], graphs.leaves(before)[:11]))
        assert int(k4._ARRIVE[st.cost.device].sum()) == 0


@pytest.mark.parametrize("converge_at", [3, LOOP_ITERS + 1])
def test_k4_sets_the_while_node_condition(cuda, converge_at):
    """A solve's iterations as a captured program (`chip_smoke.k4_loop`:
    K4 before a WHILE node and in its body) replayed twice: the plain
    loop's bits, the node's trips (counted on the card) those of the
    iterations after the first up to `iters`, K4 launched once before the
    node and once a trip."""
    args = loop_args(FACTOR_WINDOWS["e2e"], cuda)
    static = dict(max_iters=LOOP_ITERS, converge_at=converge_at)
    plain = k4_loop(*graphs.clone(args), **static, plain=True)
    prog = graphs.ProgramCache().get(k4_loop, args, cuda, static)
    iters = min(converge_at, LOOP_ITERS)
    for _ in range(2):
        graphs.reset_counts()
        k4.reset_counts()
        got = prog(*args)
        torch.cuda.synchronize()
        st_g = graphs.stats()
        assert tree_err(got, plain) == 0.0
        assert int(got.iters) == iters
        assert st_g["while_trips"] == iters - 1
        assert k4.counts()["lm_accept"] == iters


def test_k4_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """The wrapper raises on what K4 does not take, and launches
    nothing."""
    cfg = FACTOR_WINDOWS["e2e"]
    st, trial, ne_t, cost_t, opts = accept_case(cfg, torch.float32, cuda)
    n = k4.accept_step.launches
    with pytest.raises(TypeError):
        k4.accept_step(st._replace(n_acc=st.n_acc.int()), trial, ne_t,
                       cost_t, opts)
    with pytest.raises(TypeError):
        k4.accept_step(st, trial, ne_t, cost_t.double(), opts)
    with pytest.raises(ValueError):
        k4.accept_step(st, trial._replace(dinv=trial.dinv[:-1]), ne_t,
                       cost_t, opts)
    with pytest.raises(ValueError):
        k4.accept_step(st, trial, ne_t, cost_t.cpu(), opts)
    strided = st._replace(ne=(st.ne[0].t(), *st.ne[1:]))
    with pytest.raises(ValueError):
        k4.accept_step(strided, trial, ne_t, cost_t, opts, in_place=True)
    assert k4.accept_step.launches == n
