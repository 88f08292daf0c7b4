"""The captured programs (`ctrlvio_tpu_torch/utils/graphs.py`) on the CPU,
through the test-only replay stand-in (`tests/torch_graph_standin.py`),
against the same runs with every function run eagerly: equal bit for bit.
This file: the streamed `CtrlVIO`; `test_torch_graphs_sync.py`: the
synchronous path; `test_torch_graphs_serve.py`: the batched lanes;
`test_torch_graphs_frontend.py`: the fused front end.

The stand-in keeps a graph's semantics: outputs overwritten by the next
replay, inputs read from the buffers captured, nothing run at capture. The
card's own graphs are held to their eager calls by
`tests/test_torch_graphs_gpu.py`."""

import numpy as np
import pytest
import torch

from ctrlvio_tpu_torch.utils import graphs
from tests.torch_graph_standin import (STREAM, assert_same_estimate,
                                       captured, programs, replayed_programs,
                                       run)
from tests.torch_graph_standin import sim as make_sim
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def sim():
    return make_sim()


def test_stream_replayed_equals_eager(sim):
    """The streamed estimator (3 synchronous warmup frames, then the
    megastep; `stream_consume_every=3`, so two summaries of three wait on
    the device across later replays; a final `flush()`) with every program
    replayed: the same poses, trajectory, keyframes and solve statistics
    as the eager run, bit for bit, over MARGIN_OLD and MARGIN_SECOND_NEW
    frames. Both runs rebind the gravity tensor at frame 2, after the
    warmup's programs were captured: each call copies its inputs in, so
    the new value reaches every later call. One megastep program a slide
    branch and seed source; no capture after the first of each."""
    vio_e, poses_e, branches_e, _ = run(sim, rebind_at=2, **STREAM)
    with replayed_programs():
        vio_r, poses_r, branches_r, _ = run(sim, rebind_at=2, **STREAM)
        keys = captured()
        replays = graphs.stats()["replays"]
    assert {0, 1} <= set(branches_e) and branches_r == branches_e
    assert vio_e.cfg.stream_consume_every == 3
    assert np.array_equal(poses_r, poses_e)
    assert_same_estimate(vio_r, vio_e)
    mega = programs(vio_r._programs)
    assert {(k.split("marg_old=")[1][:4], k.split("host_seeds=")[1][:4])
            for k in mega} >= {("True", "Fals"), ("Fals", "Fals")}
    assert sum("host_seeds=True" in k for k in mega) == 1
    assert len(mega) == 3 and set(mega) <= set(keys)
    assert sorted(k.split("(")[0] for k in set(keys) - set(mega)) == [
        "marg_prior", "window_solve", "window_solve", "window_solve"]
    assert len(keys) == len(set(keys))
    assert replays > vio_r.counts["megastep"] + vio_r.counts["sync_solve"]
    # the rebound gravity is what every megastep program last read
    for prog in mega.values():
        assert torch.equal(prog.inputs[3], vio_r._gravity_j)


