"""The batched megastep as one captured program a lane count (≙ the JAX
package's `jit(vmap(megastep))`), on the CPU through the test-only replay
stand-in (`tests/torch_graph_standin.py`): two `BatchedStream` lanes whose
keyframe decisions differ, replayed, equal the eager lanes bit for bit,
and timing the program between steps (`device_steady_ms`, which replays it
on the live state) leaves the lanes where they were."""

import pytest

from ctrlvio_tpu_torch.parallel.stream_batch import BatchedStream
from ctrlvio_tpu_torch.utils import graphs
from tests.torch_graph_standin import (STREAM, assert_same_estimate,
                                       new_vio, replayed_programs)
from tests.torch_graph_standin import sim as make_sim
from tests.torch_parity import one_torch_thread  # noqa: F401

# the lanes' parallax thresholds: the second keyframes on other frames
PARALLAX = (0.05, 0.15)


@pytest.fixture(scope="module")
def sims():
    return [make_sim(seed) for seed in (11, 12)]


def serve(sims):
    """The lanes through one BatchedStream, `device_steady_ms` timed after
    the third batched step. Returns the estimators and each batched
    step's keyframe decisions."""
    vios = [new_vio(s, min_parallax=mp, **STREAM)
            for s, mp in zip(sims, PARALLAX)]
    coord = BatchedStream(vios)
    flags = []
    for k in range(min(len(s.frames) for s in sims)):
        steps = coord._n_steps
        coord.step([(s.frames[k].t_ns, s.frames[k].ids, s.frames[k].pts,
                     s.frames[k].rows) for s in sims])
        if coord._n_steps > steps:
            flags.append([v.marg_flag for v in vios])
        if coord._n_steps == 3 and steps == 2:
            assert coord.device_steady_ms(reps=2) > 0.0
    coord.flush()
    return vios, flags, coord


def test_batched_stream_replayed_equals_eager(sims):
    """MARGIN_OLD beside MARGIN_SECOND_NEW in one batched step; every
    lane's estimate bit-equal to the eager run's; one batched program,
    captured once, replayed once a step and twice more by the timing."""
    eager, flags_e, _ = serve(sims)
    with replayed_programs():
        got, flags_r, coord = serve(sims)
        keys = [c["key"] for c in graphs.stats()["graphs_captured"]]
    assert [0, 1] in flags_e and flags_r == flags_e
    for a, b in zip(got, eager):
        assert_same_estimate(a, b)
    (prog,) = coord._programs._programs.values()
    assert keys.count(prog.label) == 1
    assert prog.replays == coord._n_steps + 2
