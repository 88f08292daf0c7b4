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

from ctrlvio_tpu_torch.frontend import klt
from ctrlvio_tpu_torch.ops import lk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def textured_pair(H, W, dx, dy, seed):
    """A blocky, smoothed random texture and its copy shifted by (dx, dy)."""
    from scipy.ndimage import gaussian_filter, shift

    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, size=(H // 8, W // 8))
    img = gaussian_filter(np.kron(img, np.ones((8, 8))) * 255.0, 1.5)
    return img, shift(img, (dy, dx), order=3, mode="nearest")


@pytest.mark.parametrize("level", [0, 1, 2])
def test_k1_matches_plain_version(cuda, level):
    """K1 at each pyramid level of a 1280x1024 pair, N=150, 10 iterations:
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
