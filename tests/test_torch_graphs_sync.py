"""The synchronous path's captured programs on the CPU (≙ the JAX
package's `_ba_fused`, `_build_prior_cpu` and `_solve_predict`): the
window solve with its gauge restore and one pulled vector, the f64 prior
whose knot and bias shifts ride in its upload, and the bootstrap's predict
solve, through the test-only replay stand-in
(`tests/torch_graph_standin.py`), against the eager run: equal bit for
bit. The programs sit in one process-wide cache that every estimator of
the same configuration shares, as `jax.jit`'s cache is."""

import numpy as np
import pytest
import torch

from ctrlvio_tpu_torch.estimator import odometry
from ctrlvio_tpu_torch.utils import graphs
from tests.torch_graph_standin import (assert_same_estimate, captured,
                                       programs, replayed_programs, run)
from tests.torch_graph_standin import sim as make_sim
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def sim():
    return make_sim()


def test_sync_path_replayed_equals_eager(sim):
    """Every frame solved by the replayed window program, the prior built
    by one program at knot shifts 2 and 4, the bootstrap's predict by a
    third and its f64 BA by a fourth: the same poses, trajectory, keyframes and statistics as the
    eager run, bit for bit. Both runs rebind the gravity tensor at frame
    2, after the programs were captured; the programs read the new one.
    A second estimator of the same configuration captures nothing and
    ends where the first did."""
    vio_e, poses_e, _, shifts_e = run(sim, rebind_at=2)
    with replayed_programs():
        vio_r, poses_r, _, shifts_r = run(sim, rebind_at=2)
        keys = captured()
        replays = graphs.stats()["replays"]
        vio_2, poses_2, _, _ = run(sim, rebind_at=2)
        progs = programs(odometry._SYNC_PROGRAMS)
        assert captured() == keys
        assert graphs.stats()["replays"] == 2 * replays
    assert set(shifts_e) >= {2, 4} and shifts_r == shifts_e
    assert np.array_equal(poses_r, poses_e)
    assert_same_estimate(vio_r, vio_e)
    assert np.array_equal(poses_2, poses_e)
    assert_same_estimate(vio_2, vio_e)
    assert sorted(keys) == sorted(progs) and len(progs) == 4
    assert sorted(k.split("(")[0] for k in keys) == [
        "marg_prior", "window_solve", "window_solve", "window_solve"]
    solve = next(p for k, p in progs.items() if "restore=True" in k)
    # the rebound gravity, 1e-4 above the bootstrap's, is what the window
    # program last read
    assert torch.equal(solve.inputs[3], vio_2._gravity_j)
    assert not torch.equal(vio_2._gravity_j,
                           torch.tensor(vio_2.gravity, dtype=torch.float64))
    assert replays == (vio_r.counts["sync_solve"] + len(shifts_r) + 2)
