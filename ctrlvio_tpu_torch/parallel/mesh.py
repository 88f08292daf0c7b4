"""The ("seq", "fac") process mesh over `torch.distributed` (PyTorch port of
`ctrlvio_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a (seq, fac) mesh:

- `seq`: data parallelism over sequences (many windows solved at once,
  `parallel/batch.py`);
- `fac`: factor sharding of the Gauss-Newton assembly inside one window,
  the partial normal equations summed across the axis
  (`parallel/sharded_lm.py`), the distributed form of the reference's
  4-thread partial-Hessian sum (`marginalization_factor.cpp:209-238`).

Here each mesh position is one process (rank) of the default process
group: rank r sits at seq = r // n_fac, fac = r % n_fac, and every axis
line is a process group of its own, so a collective "over fac" is one
over the ranks that share this rank's seq index. `init_distributed` starts
the default group from a `file://` store (no TCP port to pick) with NCCL
for CUDA ranks and gloo for CPU ranks, unless the caller names a backend.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ctrlvio_tpu_torch.utils.device import resolve_device

AXES = ("seq", "fac")
# how long a collective or the rendezvous waits for a missing rank
TIMEOUT = timedelta(seconds=600)


def resolve_backend(device: torch.device, backend: Optional[str],
                    world: int) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks, unless `backend` names one.
    NCCL needs a card a rank (`torch.cuda.device_count()`) and CUDA
    tensors; asked for more ranks or for CPU tensors it raises. Nothing
    switches backend by itself."""
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend reduces CUDA tensors only")
        n = torch.cuda.device_count()
        if world > n:
            raise RuntimeError(
                f"nccl asked for {world} ranks but {n} CUDA device(s) are "
                "visible: one rank a card (two ranks sharing a card need "
                "backend='gloo')")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def init_distributed(rank: int, world: int, store: str, device="cuda",
                     backend: Optional[str] = None) -> torch.device:
    """Join the default process group as `rank` of `world`, rendezvousing
    through a file store in the directory `store` (shared by the ranks,
    fresh for each group). Returns this rank's device: `cuda` without an
    index becomes `cuda:{rank % device_count}` (ranks beyond the card
    count share cards, which only gloo allows); `cuda` without a card
    raises."""
    dev = resolve_device(device)
    backend = resolve_backend(dev, backend, world)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    os.makedirs(store, exist_ok=True)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(
            os.path.abspath(store), "rendezvous"),
        rank=rank, world_size=world, timeout=TIMEOUT,
        **kw)
    return dev


class Mesh:
    """This rank's place in a (seq, fac) mesh of processes: `shape`,
    `index(axis)` (≙ `jax.lax.axis_index`), `size(axis)` and
    `group(axis)`, the process group of this rank's line along the axis.
    A rank outside the mesh (rank >= n_seq * n_fac) has no groups."""

    def __init__(self, n_seq: int, n_fac: int, groups: dict, rank: int):
        self.shape = {"seq": n_seq, "fac": n_fac}
        self._groups = groups
        self.rank = rank

    def _check(self, axis: str):
        if axis not in AXES:
            raise ValueError(f"mesh axes are {AXES}, not {axis!r}")
        if self.rank >= self.shape["seq"] * self.shape["fac"]:
            raise RuntimeError(f"rank {self.rank} is outside the mesh "
                               f"{self.shape}")

    def index(self, axis: str) -> int:
        self._check(axis)
        n_fac = self.shape["fac"]
        return self.rank // n_fac if axis == "seq" else self.rank % n_fac

    def size(self, axis: str) -> int:
        self._check(axis)
        return self.shape[axis]

    def group(self, axis: str):
        self._check(axis)
        return self._groups[axis]


def make_mesh(n_seq: Optional[int] = None, n_fac: int = 1,
              backend: Optional[str] = None) -> Mesh:
    """A (seq, fac) mesh over the first n_seq * n_fac ranks of the
    initialized default process group (`n_seq=None`: world // n_fac), as
    the JAX package takes a prefix of its devices; ranks beyond it get no
    group. Every rank of the world must call this, in the same order as
    its other group constructions (`dist.new_group` is collective).
    `backend` defaults to the default group's."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group (init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_seq is None:
        n_seq = world // n_fac
    if n_seq < 1 or n_fac < 1 or n_seq * n_fac > world:
        raise ValueError(f"need {n_seq}x{n_fac} ranks, have {world}")
    groups = {}
    for s in range(n_seq):  # fac lines: the ranks of one seq index
        ranks = [s * n_fac + f for f in range(n_fac)]
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            groups["fac"] = g
    for f in range(n_fac):  # seq lines: the ranks of one fac index
        ranks = [s * n_fac + f for s in range(n_seq)]
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            groups["seq"] = g
    return Mesh(n_seq, n_fac, groups, rank)


def tree_map(fn, tree):
    """fn over the tensors of a (nested) tuple or named tuple."""
    if isinstance(tree, tuple):
        vals = [tree_map(fn, t) for t in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree)


def seq_sharding(mesh: Mesh):
    """Returns `shard(tree)`: this rank's contiguous slice of the leading
    (batch) axis of every tensor in `tree`, the axis split evenly over
    `seq` (≙ `NamedSharding(mesh, P("seq"))`). B must divide by n_seq."""
    n, i = mesh.size("seq"), mesh.index("seq")

    def shard(tree):
        def take(x):
            B = x.shape[0]
            if B % n:
                raise ValueError(f"batch {B} does not divide by seq={n}")
            return x[i * (B // n) : (i + 1) * (B // n)]
        return tree_map(take, tree)

    return shard


def replicated(mesh: Mesh):
    """Returns the identity: every rank holds the whole value
    (≙ `NamedSharding(mesh, P())`)."""
    return lambda tree: tree
