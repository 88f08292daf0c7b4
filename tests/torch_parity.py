"""Helpers shared by the port's parity tests (`tests/test_torch_*.py`)."""

import numpy as np
import pytest
import torch

RTOL = 1e-9  # float64 modules: relative to the reference's largest entry


def close(a, b, rtol=RTOL):
    """b (tensor or array) equals the reference a to rtol times a's
    largest magnitude, elementwise."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().cpu().numpy() if torch.is_tensor(b) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(a).max(), 1e-300)
    np.testing.assert_allclose(b, a, rtol=0, atol=rtol * scale)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread each, so that the test workers
    sharing the machine's cores do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
