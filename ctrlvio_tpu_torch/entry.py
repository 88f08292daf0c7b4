"""One sliding-window LM solve as a function and its example arguments
(counterpart of `__graft_entry__.entry()`).

    fn, args = entry()            # the card; entry(device="cpu") on the CPU
    knots_p, ld, cost = fn(*args)
"""

from __future__ import annotations

import torch

from ctrlvio_tpu_torch.sim import tiny
from ctrlvio_tpu_torch.solver import lm
from ctrlvio_tpu_torch.solver.layout import SolveOptions


def entry(device="cuda"):
    """Returns `(fn, example_args)`. `fn(params, img, imu, bias, prior,
    fixed) -> (knots_p, ld, cost)` runs `lm.solve_window` for 3 LM
    iterations in float32 on the window of `sim/tiny.py` (KW=32, NB=11,
    LM=64, OBS=256, MIMU=256), whose constants it closes over;
    `example_args` are that window's tensors on `device` (the card unless
    the caller asks for the CPU; raises without a card)."""
    prob = tiny.tiny_problem(torch.float32, device=device)
    opts = SolveOptions(max_iters=3)

    def fn(params, img, imu, bias, prior, fixed):
        out, stats = lm.solve_window(params, img, imu, bias, prior, fixed,
                                     *prob.aux, prob.cfg, opts)
        return out.knots_p, out.ld, stats.cost

    return fn, (prob.params, prob.img, prob.imu, prob.bias, prob.prior,
                prob.fixed)
