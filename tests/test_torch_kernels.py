"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions. Every test here needs a CUDA device and skips without
one. The file imports neither JAX nor the JAX package, so that it runs on
a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py -q -m gpu --noconftest \
        -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from chip_smoke import TRACK_CASES, SEARCH_MARGIN, textured_pair, track_case
from ctrlvio_tpu_torch.frontend import klt
from ctrlvio_tpu_torch.ops import lk

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
    levels of a 1280x1024 pair, N=150, 10 iterations) in one launch: ok as
    the plain version's except within 1e-3 px of fb_thresh or of the
    in-bounds edge, or within 1e-4 relative of min_eig; positions within
    1e-3 px where both say ok; min_eig within 1e-4 relative; the known
    shift recovered within 0.15 px. The large motion moves most features
    beyond the staged search window at the coarsest level."""
    pyr0, pyr1, pts, init, shift = track_case(case, cuda)
    cfg = klt.KLTConfig(pred_levels=3)
    args = (pyr0, pyr1, pts, init, 10, lk.HALF, cfg.fb_thresh, cfg.min_eig)
    launches = lk.lk_track.launches
    out, ok, eig = lk.lk_track(*args)
    ref, ok_ref, eig_ref = lk.lk_track_plain(*args)
    back, _ = lk.lk_pass_plain(pyr1, pyr0, ref, pts, 10)
    torch.cuda.synchronize()
    assert lk.lk_track.launches == launches + 1
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
