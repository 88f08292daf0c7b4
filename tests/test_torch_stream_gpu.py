"""The streaming megastep on the card: one step on the CUDA device against
the same step on the CPU, in f32, and no synchronizing CUDA call inside it;
the same for the batched megastep of the serving path over one
MARGIN_OLD lane and one MARGIN_SECOND_NEW lane.
Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so that it runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_stream_gpu.py -q -m gpu --noconftest \
        -o addopts="" -p no:cacheprovider
"""

import warnings

import numpy as np
import pytest
import torch

from ctrlvio_tpu_torch.estimator import stream
from ctrlvio_tpu_torch.estimator.odometry import SYNC_WARNING
from ctrlvio_tpu_torch.parallel import batch
from ctrlvio_tpu_torch.parallel.stream_batch import batched_megastep
from ctrlvio_tpu_torch.utils.precision import pin_f32_matmuls
# imported by its own name: on a machine where another package provides a
# top-level `tests`, `tests.torch_stream_case` does not resolve
from torch_stream_case import CFG, build_case, port_args, run_port

pytestmark = pytest.mark.gpu

# f32 on two devices: the reductions sum in different orders, and the LM
# iterations amplify that (2.1e-4 in knot position after one step of this
# case on an H100); knots and biases to 1e-3 (m, rad, m/s^2), inverse
# depths and the line delay to 1e-3 relative to the largest entry, the
# prior's information J^T J to 1e-3 of its largest entry, and its J^T r0
# to 1e-2: the prior's gradient, a small difference of large terms once
# the solve has converged (1.8e-3 on an H100)
TOL_STATE = 1e-3
TOL_REL = 1e-3
TOL_GRAD = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the megastep runs on the card")
    pin_f32_matmuls()
    return torch.device("cuda")


def _rel(a, b):
    a = a.double().cpu().numpy()
    b = b.double().cpu().numpy()
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _abs(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _agree(st_g, sum_g, st_c, sum_c):
    """Assert that a megastep's state and summary on the card agree with
    the CPU's within the tolerances above."""
    s_c = stream.unpack_summary(sum_c.double().numpy(), CFG)
    s_g = stream.unpack_summary(sum_g.double().cpu().numpy(), CFG)
    Jg, Jc = st_g.prior.J.double().cpu(), st_c.prior.J.double()
    err = {k: _abs(s_g[k], s_c[k]) for k in ("knots_q", "knots_p", "bg",
                                              "ba")}
    err.update({f"state_{i}": _abs(a.cpu(), b)
                for i, (a, b) in enumerate(zip(st_g.params[:4],
                                               st_c.params[:4]))})
    rel = {"ld_costs": _rel(sum_g[-11:-7], sum_c[-11:-7]),
           "dinv": _rel(st_g.params.dinv, st_c.params.dinv),
           "JtJ": _rel(Jg.T @ Jg, Jc.T @ Jc)}
    grad = _rel(Jg.T @ st_g.prior.r0.double().cpu(),
                Jc.T @ st_c.prior.r0.double())
    msg = {"abs": err, "rel": rel, "grad": grad,
           "accepted": (s_g["accepted"], s_c["accepted"])}
    assert s_g["accepted"] == s_c["accepted"], msg
    assert max(err.values()) <= TOL_STATE, msg
    assert max(rel.values()) <= TOL_REL, msg
    assert grad <= TOL_GRAD, msg


@pytest.mark.parametrize("marg_old", [True, False])
def test_megastep_on_the_card_matches_cpu(cuda, marg_old):
    case = build_case(marg_old)
    st_c, sum_c = run_port(case, "cpu", torch.float32)
    st_g, sum_g = run_port(case, cuda, torch.float32)
    torch.cuda.synchronize()
    _agree(st_g, sum_g, st_c, sum_c)


def _lane(t, i):
    """Lane i of a stacked (nested) named tuple of tensors."""
    return type(t)(*(_lane(x, i) if isinstance(x, tuple) else x[i]
                     for x in t))


def _batched(device):
    """The batched megastep over the two cases stacked as lanes, f32 on
    `device`: (callable, stacked states, blobs, the shared constants)."""
    pa = [port_args(build_case(m), device, torch.float32)[0]
          for m in (True, False)]
    _, _, ext, g, info, w, cfg, opts = pa[0]
    return (batched_megastep(cfg, opts), batch.stack([a[0] for a in pa]),
            torch.stack([a[1] for a in pa]), (ext, g, info, w))


def test_batched_megastep_on_the_card_matches_cpu(cuda):
    """Each lane of the batched megastep on the card against the same lane
    on the CPU."""
    out = {}
    for dev in ("cpu", cuda):
        mega, states, blobs, consts = _batched(dev)
        out[str(dev)] = mega(states, blobs, *consts)
    torch.cuda.synchronize()
    (st_c, sum_c), (st_g, sum_g) = out["cpu"], out[str(cuda)]
    for i in range(2):
        _agree(_lane(st_g, i), sum_g[i], _lane(st_c, i), sum_c[i])


def test_batched_megastep_makes_no_synchronizing_call(cuda):
    """Sync debug mode "warn" over a whole batched megastep (after a first
    call): no synchronizing call."""
    mega, states, blobs, consts = _batched(cuda)
    mega(states, blobs, *consts)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            mega(states, blobs, *consts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if SYNC_WARNING in str(w.message)]
    assert syncs == [], syncs


def test_megastep_makes_no_synchronizing_call(cuda):
    """Sync debug mode "warn" over a whole megastep, its inputs already on
    the card (after a first call that builds the blending constants): no
    synchronizing call (setting the mode itself warns that it is a
    prototype; that warning is not one)."""
    for marg_old in (True, False):
        case = build_case(marg_old)
        args, kw = port_args(case, cuda, torch.float32)
        stream.megastep(*args, **kw)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                stream.megastep(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [f"{w.filename}:{w.lineno}" for w in caught
                 if SYNC_WARNING in str(w.message)]
        assert syncs == [], (marg_old, syncs)
