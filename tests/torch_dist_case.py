"""One gloo rank of `tests/test_torch_parallel.py`'s launch: the port's
multi-process cases on the CPU in float64, imports neither JAX nor the JAX
package.

    python tests/torch_dist_case.py RANK WORLD DIR

reads DIR/in.npz (the window problem, its lanes and the options, written
by the test) and writes DIR/out{RANK}.npz. WORLD is 4: mesh (2, 2), the
seq-sharded batch over 4 ranks, the factor-sharded step and solve over
fac = 4, and on rank 0 alone the solve at fac = 1 beside
`lm.solve_window_fixed`.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from ctrlvio_tpu_torch.ops.factors import CamExtrinsics
from ctrlvio_tpu_torch.parallel import batch, sharded_lm
from ctrlvio_tpu_torch.parallel.mesh import init_distributed, make_mesh
from ctrlvio_tpu_torch.solver import layout
from ctrlvio_tpu_torch.solver import lm
from ctrlvio_tpu_torch.utils.convert import tensor

N_LANES = 4


def load(z, key, cls):
    return cls(*(tensor(z[f"{key}.{f}"]) for f in cls._fields))


def save(out, key, nt):
    for f, x in zip(nt._fields, nt):
        out[f"{key}.{f}"] = x.numpy()


def main(rank, world, d):
    init_distributed(rank, world, f"{d}/store", device="cpu")
    torch.set_num_threads(1)
    z = np.load(f"{d}/in.npz")
    cfg = layout.WindowConfig(*(int(v) for v in z["cfg"]), dt=float(z["dt"]))
    solve_opts = layout.SolveOptions(max_iters=int(z["max_iters"]))
    step_opts = layout.SolveOptions(max_iters=1)
    win = (load(z, "img", layout.ImageFactors),
           load(z, "imu", layout.ImuFactors),
           load(z, "bias", layout.BiasFactors),
           load(z, "prior", layout.PriorFactor), tensor(z["fixed"]))
    aux = (load(z, "ext", CamExtrinsics), tensor(z["gravity"]),
           tensor(z["info"]), tensor(z["w"]))
    lanes = [load(z, f"lane{i}", layout.WindowParams)
             for i in range(N_LANES)]
    args = (lanes[0], *win, *aux)
    out = {}

    # mesh (2, 2): place, axis sizes and the members of each axis group
    m = make_mesh(2, 2)
    out["mesh.shape"] = np.array([m.shape["seq"], m.shape["fac"]])
    out["mesh.index"] = np.array([m.index("seq"), m.index("fac")])
    out["mesh.size"] = np.array([m.size("seq"), m.size("fac")])
    out["mesh.group_size"] = np.array(
        [dist.get_world_size(m.group(a)) for a in ("seq", "fac")])
    sums = []
    for a in ("seq", "fac"):
        x = torch.tensor([float(rank)])
        dist.all_reduce(x, group=m.group(a))
        sums.append(float(x))
    out["mesh.rank_sums"] = np.array(sums)

    # the batch of lanes, sharded over seq = 4
    m41 = make_mesh(4, 1)
    solve_b = batch.make_batched_solver(cfg, solve_opts, mesh=m41)
    stacked = [batch.stack(lanes)] + [batch.stack([x] * N_LANES)
                                      for x in win]
    p_b, st_b = solve_b(*stacked, *aux)
    save(out, "batch.params", p_b)
    save(out, "batch.stats", st_b)

    # factor sharding over fac = 4: one step, the full solve, and the full
    # solve asked for CG
    m14 = make_mesh(1, 4)
    step = sharded_lm.make_factor_sharded_step(m14, cfg, step_opts)
    p_st, cost_st = step(*args, torch.tensor(1e-4, dtype=torch.float64))
    save(out, "step.params", p_st)
    out["step.cost"] = cost_st.numpy()
    for key, o in (("solve", solve_opts),
                   ("solve_cg", solve_opts._replace(solver="cg"))):
        p_sh, st_sh = sharded_lm.make_sharded_solve(m14, cfg, o)(*args)
        save(out, f"{key}.params", p_sh)
        save(out, f"{key}.stats", st_sh)

    # fac = 1 (m41's fac groups hold one rank each)
    if rank == 0:
        p1, st1 = sharded_lm.make_sharded_solve(m41, cfg, solve_opts)(*args)
        save(out, "fac1.params", p1)
        save(out, "fac1.stats", st1)
        pf, stf = lm.solve_window_fixed(*args, cfg, solve_opts)
        save(out, "fixed.params", pf)
        save(out, "fixed.stats", stf)
    np.savez(f"{d}/out{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
