"""Batched window solving: B independent sliding-window problems
(different sequences, or different time windows of one) solved by one
call (PyTorch port of `ctrlvio_tpu/parallel/batch.py`).

`torch.func.vmap` over `lm.solve_window_fixed` turns each dense step of the
window solve into one batched operation over the B lanes, so the host
dispatches about as many device operations for B windows as for one. The
loop runs every iteration and freezes each lane once it has converged,
which is what the JAX package's vmapped while loop computes (it runs
until every lane is done). On the card the call is one captured program
(`utils/graphs.py`) a window configuration, options, lane count, dtype
and device (≙ `jax.jit` of the vmapped solve). Given a (seq, fac) mesh
of processes (`parallel/mesh.py`), each `seq` rank solves its B / n_seq
lanes the same way, eagerly, with no traffic between ranks, and one
`all_gather` per output hands every rank the whole batch back.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.func import vmap

from ctrlvio_tpu_torch.solver import lm
from ctrlvio_tpu_torch.solver.layout import SolveOptions, WindowConfig
from ctrlvio_tpu_torch.utils import graphs

from .mesh import Mesh, seq_sharding, tree_map


def stack(items: Sequence):
    """Stack a list of equal-shaped (nested) named tuples of tensors, or of
    tensors, into one with a leading batch axis."""
    first = items[0]
    if isinstance(first, tuple):
        return type(first)(*(stack(f) for f in zip(*items)))
    return torch.stack(list(items))


# the batched solves' programs, shared by every solver of the process
_PROGRAMS = graphs.ProgramCache()


def batched_solve(params_b, img_b, imu_b, bias_b, prior_b, fixed_b, ext,
                  gravity, imu_info, sqrt_info_img, *, cfg: WindowConfig,
                  opts: SolveOptions):
    """`lm.solve_window_fixed` vmapped over the leading lane axis of the
    first six arguments, every iteration run."""
    return vmap(partial(lm.solve_window_fixed, cfg=cfg, opts=opts,
                        exit_node=False),
                in_dims=(0,) * 6 + (None,) * 4)(
        params_b, img_b, imu_b, bias_b, prior_b, fixed_b, ext, gravity,
        imu_info, sqrt_info_img)


def make_batched_solver(cfg: WindowConfig, opts: SolveOptions,
                        mesh: Optional[Mesh] = None):
    """Returns `solve(params_b, img_b, imu_b, bias_b, prior_b, fixed_b,
    ext, gravity, imu_info, sqrt_info_img) -> (params_b, SolveStats_b)`:
    `lm.solve_window_fixed` over the leading batch axis of the first six
    arguments (`stack`), the last four shared by every lane.

    mesh: None, one process solving every lane: on the card the process's
    captured program of this configuration and B (`batched_solve`), whose
    next call overwrites the outputs it returns, eagerly on the CPU; or
    a mesh whose `seq` ranks each pass the whole batch, solve their
    contiguous B / n_seq lanes eagerly and all-gather the results (B must
    divide by n_seq)."""
    static = dict(cfg=cfg, opts=opts)
    if mesh is None:
        def solve_program(*args):
            B = args[0].knots_p.shape[0]
            return _PROGRAMS.get(
                batched_solve, args, args[0].knots_p.device, static,
                label=f"batched_solve(B={B}, solver={opts.solver})")(*args)

        return solve_program
    solve = partial(batched_solve, **static)
    shard = seq_sharding(mesh)
    group, n_seq = mesh.group("seq"), mesh.size("seq")

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(n_seq)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    def solve_sharded(params_b, img_b, imu_b, bias_b, prior_b, fixed_b,
                      ext, gravity, imu_info, sqrt_info_img):
        lanes = shard((params_b, img_b, imu_b, bias_b, prior_b, fixed_b))
        out = solve(*lanes, ext, gravity, imu_info, sqrt_info_img)
        return tree_map(gather, out)

    return solve_sharded
