"""The port's serve-path tools on a short CPU capture of the streaming
state (`profile_serve.capture_state`): `ne_ab`'s dense and chunked
normal equations (the same equations) and `profile_serve`'s op table
(counterparts of `tools/ne_ab.py` and `tools/profile_serve.py`)."""

import time

import pytest
import torch

from ctrlvio_tpu_torch.estimator import stream
from ctrlvio_tpu_torch.solver import lm
from ctrlvio_tpu_torch.tools import ne_ab, profile_serve
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def captured():
    """A short streaming capture on the CPU (2.5 s, 4 warmup frames)."""
    return profile_serve.capture_state(duration=2.5, warmup=4, device="cpu")


def test_ne_ab_dense_equals_chunked(captured):
    """`ne_ab` at B = 1, dense against chunked (all factors in one chunk):
    at the captured state and blob both build the same normal equations
    (within 1e-5 of each block's largest entry: f32 summation order) and
    cost; after the megastep's 12 LM iterations the starting and final
    costs agree within 1e-5 of the starting cost."""
    vio, st, blob = captured
    results, outs = ne_ab.run(vio, st, blob, [1], ["dense", "chunked"], [0],
                              ["chol"], reps=1, warm=0)
    assert [r["variant"] for r in results] == ["dense/chol", "chunked/chol"]
    assert all(r["ms_per_step"] > 0 and r["B"] == 1 for r in results)
    sums = [stream.unpack_summary(outs[(t, 1)][1][0].double().numpy(),
                                  vio.wc)
            for t in ("dense/chol", "chunked/chol")]
    c0 = sums[1]["cost0"]
    assert abs(sums[0]["cost0"] - c0) <= 1e-5 * c0
    assert abs(sums[0]["cost"] - sums[1]["cost"]) <= 1e-5 * c0
    assert all(s["cost"] <= s["cost0"] for s in sums)

    img, imu, bias, fixed = stream.unpack_stream_blob(
        torch.as_tensor(blob), vio.wc, torch.float32)[:4]
    consts = (vio._ext, vio._gravity_j, vio._imu_info, vio._sqrt_info_img)
    ne = {}
    for mode in ("dense", "chunked"):
        _, _, ne_at = lm._setup(st.params, img, imu, bias, st.prior, fixed,
                                *consts, vio.wc, vio._ba_opts, mode, None)
        ne[mode] = ne_at(st.params)
    (eq_d, cost_d), (eq_c, cost_c) = ne["dense"], ne["chunked"]
    for a, b in zip(eq_d, eq_c):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert abs(float(cost_d) - float(cost_c)) <= 1e-5 * float(cost_c)


def test_profile_serve_op_table_on_cpu(captured):
    """`op_table` over one batched megastep at B = 1 on the CPU: the ops'
    self host times, sorted by time, every count > 0, thousands of ops,
    their sum within the traced step's wall time (self times do not
    overlap on one thread)."""
    vio, st, blob = captured
    mega = profile_serve.lane_megastep(vio)
    s, blobs, consts = profile_serve.batched_inputs(vio, st, blob, 1)
    t0 = time.perf_counter()
    rows = profile_serve.op_table(mega, s, blobs, consts, 1, vio.device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    ms = [r[1] for r in rows]
    assert ms == sorted(ms, reverse=True) and ms[-1] >= 0
    assert all(r[2] > 0 for r in rows)
    assert sum(r[2] for r in rows) > 1000
    assert any(r[0] == "aten::mm" or r[0] == "aten::bmm" for r in rows)
    assert 0 < sum(ms) <= wall_ms


def test_batched_lanes_take_their_normal_equations(monkeypatch):
    """`VIOConfig.ne_mode` and `ne_chunk` reach the batched megastep that
    BatchedStream builds (as they reach the solo megastep and the
    synchronous solve), as `CTRLVIO_NE` / `_NE_CHUNK` reach every solve in
    the JAX package."""
    from ctrlvio_tpu_torch.bench import BENCH_WINDOW
    from ctrlvio_tpu_torch.estimator.odometry import CtrlVIO, VIOConfig
    from ctrlvio_tpu_torch.parallel import stream_batch

    seen = {}
    real = stream_batch.batched_megastep

    def spy(cfg, opts, caps=None, ne_mode="chunked", chunk=None):
        seen.update(ne_mode=ne_mode, chunk=chunk)
        return real(cfg, opts, caps, ne_mode, chunk)

    monkeypatch.setattr(stream_batch, "batched_megastep", spy)
    cfg = VIOConfig(window_config=BENCH_WINDOW, stream=True, ne_mode="dense",
                    ne_chunk=128)
    vios = [CtrlVIO(cfg, [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                    device="cpu") for _ in range(2)]
    stream_batch.BatchedStream(vios)
    assert seen == {"ne_mode": "dense", "chunk": 128}
