"""The port's multi-process launcher on the CPU (the port of
`tests/test_multihost.py`): real python processes joined by
`torch.distributed` (gloo, a file store, one thread a rank) solving a
`seq`-sharded batch of `sim/tiny.py` windows, the multi-device dry run on
two ranks, the device and backend rules of the entry points, and (slow)
the weak-scaling efficiency at two processes."""

import os

import pytest
import torch
import torch.distributed as dist

from ctrlvio_tpu_torch.parallel import mesh, multihost
from tests.torch_parity import one_torch_thread  # noqa: F401


def test_two_process_seq_sharded_solve():
    """Two ranks, one window each (`--local-devices 1`), 2 LM iterations:
    rank 0 reads the gathered stats and the cost fell."""
    out = multihost.launch(num_processes=2, local_devices=1, device="cpu")
    assert "[multihost] 2 processes x 1 windows" in out
    assert "OK" in out


def test_dryrun_multichip_two_ranks():
    """`dryrun_multichip(2)`: mesh (1, 2), the seq-parallel batch, the full
    solve over fac = 2 within the dry run's 1e-4 gates of the unsharded
    solve (f32), and the megastep chain's cost falling."""
    rec = multihost.dryrun_multichip(2, device="cpu")
    assert rec["mesh"] == {"seq": 1, "fac": 2} and rec["backend"] == "gloo"
    s = rec["solve"]
    assert s["cost"] < s["cost0"] and s["accepted"] == s["accepted_unsharded"]
    assert max(s["max_dp"], s["max_dq"], s["dcost_over_cost0"]) < 1e-4
    assert s["ms"] > 0 and s["allreduce_bytes_per_iter"] > 0
    c0, c1, c2 = rec["megastep"]
    assert c1 < c0 and c2 == c2


@pytest.mark.parametrize("entry", ["init_distributed", "launch",
                                   "dryrun_multichip"])
def test_cuda_default_raises_without_a_card(entry, tmp_path):
    """The entry points default to `cuda` and raise without one, before
    starting any process; none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    call = {"init_distributed": lambda: mesh.init_distributed(
                0, 1, str(tmp_path)),
            "launch": lambda: multihost.launch(2),
            "dryrun_multichip": lambda: multihost.dryrun_multichip(2)}[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        call()
    assert not dist.is_initialized()


def test_backend_rules(monkeypatch):
    """NCCL for CUDA ranks, gloo for CPU ranks; NCCL asked for more ranks
    than cards raises, and so does NCCL on CPU tensors: nothing switches
    backend by itself. Two ranks on one card need gloo, named."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert mesh.resolve_backend(cuda, None, 1) == "nccl"
    assert mesh.resolve_backend(cuda, "gloo", 2) == "gloo"
    assert mesh.resolve_backend(cpu, None, 4) == "gloo"
    with pytest.raises(RuntimeError, match="nccl asked for 2 ranks"):
        mesh.resolve_backend(cuda, None, 2)
    with pytest.raises(ValueError):
        mesh.resolve_backend(cpu, "nccl", 1)
    with pytest.raises(ValueError):
        mesh.resolve_backend(cpu, "mpi", 1)


def test_single_rank_mesh(tmp_path):
    """A world of one rank: mesh (1, 1), its shardings the identity, a
    mesh larger than the world refused; no mesh before the group."""
    with pytest.raises(RuntimeError, match="init_distributed"):
        mesh.make_mesh()
    dev = mesh.init_distributed(0, 1, str(tmp_path), device="cpu")
    try:
        assert dev == torch.device("cpu")
        m = mesh.make_mesh()
        assert m.shape == {"seq": 1, "fac": 1}
        assert (m.index("seq"), m.index("fac")) == (0, 0)
        with pytest.raises(ValueError):
            mesh.make_mesh(n_seq=2)
        with pytest.raises(ValueError):
            m.index("batch")
        x = (torch.arange(6.0).reshape(3, 2), torch.arange(3))
        for shard in (mesh.seq_sharding(m), mesh.replicated(m)):
            y = shard(x)
            assert all(torch.equal(a, b) for a, b in zip(x, y))
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_weak_scaling_two_processes():
    """Weak-scaling efficiency at 2 processes, one window a rank, one
    pinned core a rank: >= 0.8 on a quiet box, >= 0.6 under load (the
    gates of `tests/test_multihost.py`), best of two attempts."""
    quiet = os.getloadavg()[0] < 2.5
    best = 0.0
    for _ in range(2):
        curve = multihost.scaling((1, 2), local_devices=1, bench_iters=20,
                                  repeats=1, device="cpu")
        best = max(best, curve[2][1])
        if best >= 0.8:
            break
    gate = 0.8 if quiet else 0.6
    assert best >= gate, (f"weak-scaling efficiency at 2 processes "
                          f"{best:.2f} < {gate} (quiet box: {quiet})")
