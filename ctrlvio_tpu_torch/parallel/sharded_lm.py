"""Factor-sharded Gauss-Newton assembly: the distributed Schur reduction
(PyTorch port of `ctrlvio_tpu/parallel/sharded_lm.py`).

The reference splits a window's factors over 4 pthreads, each builds a
partial (H, b), and the join sums them (`marginalization_factor.cpp:
141-238`). Here the image and IMU factors split over the mesh's `fac`
ranks: each rank linearizes its contiguous shard into partial normal
equations (`assemble.accumulate_normal_equations`), one `all_reduce` over
the `fac` group sums them, and every rank then runs the identical dense
damped Schur solve on identical inputs, so no broadcast is needed.

Pinned on purpose:

- Rows every rank holds whole count once. The bias-pair rows live inside
  the accumulation, so ranks other than fac 0 mask them out before the
  sum; the marginalization prior's Gauss-Newton pieces are added after
  the sum, on every rank (`lm._setup`).
- The Schur solve is Cholesky whatever `opts.solver` says: the JAX
  package's sharded path calls `schur_solve` without a solver choice.
- The full solve is `lm.solve_window_fixed`: exactly `max_iters`
  iterations, selected on the device, no host read, and no exit node
  (every rank makes the same collectives in the same order, and nothing
  that one card skips can differ between ranks).

On a process group whose backend is NCCL, the step and the solve each run
as a captured program (`utils/graphs.py`, ≙ the JAX package's `jax.jit`
of them): NCCL's collectives are kernels on the card, which a CUDA graph
records. Gloo's collectives run on the host (a CUDA tensor goes through
host memory), which a graph cannot hold, so on gloo ranks both stay
eager.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ctrlvio_tpu_torch.solver import lm
from ctrlvio_tpu_torch.solver.layout import (SolveOptions, WindowConfig,
                                             retract)
from ctrlvio_tpu_torch.utils import graphs

from .mesh import Mesh


def shard_config(mesh: Mesh, cfg: WindowConfig) -> WindowConfig:
    """The window of one `fac` shard: OBS and MIMU divided by n_fac."""
    n_fac = mesh.size("fac")
    if cfg.OBS % n_fac or cfg.MIMU % n_fac:
        raise ValueError(f"OBS={cfg.OBS} and MIMU={cfg.MIMU} must divide "
                         f"by fac={n_fac}")
    return cfg._replace(OBS=cfg.OBS // n_fac, MIMU=cfg.MIMU // n_fac)


def local_factors(mesh: Mesh, shard_cfg: WindowConfig, img, imu, bias):
    """This rank's contiguous shard of the image and IMU factors, and the
    bias pairs masked out on every rank but fac 0."""
    f = mesh.index("fac")
    o, m = shard_cfg.OBS, shard_cfg.MIMU
    img_s = type(img)(*(x[f * o : (f + 1) * o] for x in img))
    imu_s = type(imu)(*(x[f * m : (f + 1) * m] for x in imu))
    return img_s, imu_s, bias._replace(valid=bias.valid & (f == 0))


def fac_all_reduce(mesh: Mesh):
    """Returns `reduce(tensors) -> tensors`: one sum over the `fac` group
    of a tuple of tensors of one dtype, packed into one flat buffer."""
    group = mesh.group("fac")

    def reduce(ts):
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        parts = torch.split(flat, [t.numel() for t in ts])
        return tuple(p.reshape(t.shape) for p, t in zip(parts, ts))

    return reduce


def _captured_on_nccl(mesh: Mesh, fn):
    """`fn` as a captured program (one a signature) where the `fac` group's
    backend is NCCL, else `fn` itself, run eagerly. A program's outputs are
    overwritten by its next call."""
    if dist.get_backend(mesh.group("fac")) != "nccl":
        return fn
    programs = graphs.ProgramCache()

    def run(*args):
        return programs.get(fn, args, args[0].knots_p.device)(*args)

    return run


def reduced_bytes_per_iteration(cfg: WindowConfig, dtype) -> int:
    """Bytes one LM iteration all-reduces: H (C,C), g (C,), h_ll and g_l
    (LM,), H_cl (LM,C) and the cost."""
    n = cfg.C * cfg.C + cfg.C + 2 * cfg.LM + cfg.LM * cfg.C + 1
    return n * torch.empty((), dtype=dtype).element_size()


def make_factor_sharded_step(mesh: Mesh, cfg: WindowConfig,
                             opts: SolveOptions):
    """Build a factor-sharded GN/LM step:

    step(params, img, imu, bias, prior, fixed, ext, gravity, imu_info,
         sqrt_info_img, lam) -> (new_params, cost)

    Every rank passes the whole window (factor arrays at their global
    sizes; OBS and MIMU must divide by n_fac) and gets the same step and
    the cost at `params`, summed over the shards. Captured on NCCL (see
    the module notes)."""
    shard_cfg = shard_config(mesh, cfg)
    opts = opts._replace(solver="chol")
    reduce = fac_all_reduce(mesh)

    def step(params, img, imu, bias, prior, fixed, ext, gravity, imu_info,
             sqrt_info_img, lam):
        img_s, imu_s, bias0 = local_factors(mesh, shard_cfg, img, imu, bias)
        cmask, _, ne_at = lm._setup(params, img_s, imu_s, bias0, prior,
                                    fixed, ext, gravity, imu_info,
                                    sqrt_info_img, shard_cfg, opts,
                                    "chunked", None, reduce)
        ne, cost = ne_at(params)
        dx, dx_lm = lm.schur_solve(*ne, lam, cmask)
        new = retract(params, dx, cfg, opts)
        return new._replace(dinv=params.dinv + dx_lm), cost

    return _captured_on_nccl(mesh, step)


def make_sharded_solve(mesh: Mesh, cfg: WindowConfig, opts: SolveOptions):
    """The full factor-sharded window solve:

    solve(params, img, imu, bias, prior, fixed, ext, gravity, imu_info,
          sqrt_info_img) -> (params, lm.SolveStats)

    `lm.solve_window_fixed` on this rank's factor shard with every
    reduction (landmark use, normal equations, cost) an all-reduce over
    `fac`: the same iteration math as the single-device solve, so results
    match it to reduction-order rounding, and equal it bit for bit at
    fac = 1 (on the card, under `torch.use_deterministic_algorithms`:
    CUDA's `index_add` otherwise sums in no fixed order, and two runs of
    the same solve differ by rounding). Captured on NCCL (see the module
    notes)."""
    shard_cfg = shard_config(mesh, cfg)
    opts = opts._replace(solver="chol")
    reduce = fac_all_reduce(mesh)

    def solve(params, img, imu, bias, prior, fixed, ext, gravity, imu_info,
              sqrt_info_img):
        img_s, imu_s, bias0 = local_factors(mesh, shard_cfg, img, imu, bias)
        return lm.solve_window_fixed(params, img_s, imu_s, bias0, prior,
                                     fixed, ext, gravity, imu_info,
                                     sqrt_info_img, shard_cfg, opts,
                                     reduce=reduce)

    return _captured_on_nccl(mesh, solve)
