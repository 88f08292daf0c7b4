"""Batched multi-sequence streaming: B estimators on one device in lockstep
(PyTorch port of `ctrlvio_tpu/parallel/stream_batch.py`).

B independent sliding-window estimators replay B sequences frame by
frame, and every frame runs ONE batched streaming megastep over their
stacked device states: `torch.func.vmap` of
`stream.megastep_branchless`, which reads each lane's slide directives
from its own blob, so lanes that keyframe on different frames share the
call. On the card the call is one captured program (`utils/graphs.py`) a
lane count, the stacked state updated in place (≙ `jit(vmap(megastep))`).
The host side stays per sequence (feature tables, packing, mirrors);
the device side is one (B, ...) state owned by this coordinator.

    vios = [CtrlVIO(cfg, q_CtoI, p_CinI) for _ in range(B)]  # cfg.stream
    coord = BatchedStream(vios)
    ... feed IMU to each instance as usual ...
    outs = coord.step([(t_ns, ids, pts, rows), ...])   # a frame a lane
    coord.flush()

The instances share the window configuration and start together
(lockstep). The extrinsics, gravity and information weights of lane 0
serve every lane, as in the JAX package, and so do its solve options
(`_ba_opts`, `marg_caps`, `ne_mode`, `ne_chunk`).
"""

from __future__ import annotations

import time
from functools import partial
from typing import List

import numpy as np
import torch
from torch.func import vmap

from ctrlvio_tpu_torch.estimator import stream
from ctrlvio_tpu_torch.utils import graphs, spans
from ctrlvio_tpu_torch.utils.device import recorded_syncs

from .batch import stack


def batched_megastep(cfg, opts, caps=None, ne_mode="chunked", chunk=None):
    """`megastep(states, blobs, ext, gravity, imu_info, sqrt_info_img) ->
    (states, summaries)` over a leading lane axis of the stacked states
    and the (B, n) blobs, the four constants shared: `torch.func.vmap` of
    `stream.megastep_branchless` (`caps`, `ne_mode`, `chunk` as it takes
    them)."""
    return vmap(partial(stream.megastep_branchless, cfg=cfg, opts=opts,
                        caps=caps, ne_mode=ne_mode, chunk=chunk),
                in_dims=(0, 0, None, None, None, None))


class BatchedStream:
    """The lockstep coordinator. `timing` holds cumulative host seconds of
    each step's parts, each a span of `utils/spans.py`: "host_lanes"
    (every lane's `process_frame`, which packs its blob), "stack_upload"
    (the B blobs in one pinned buffer),
    "dispatch" (the batched megastep: the blobs' non-blocking copy and
    the program's replay, and on the first step its capture) and
    "complete" (each lane queues a copy of its summary row). `_n_steps`
    counts batched steps.
    With `check_dispatch_syncs` on a CUDA device, `dispatch_syncs` counts
    the synchronizing CUDA calls inside the coordinator's part of a step
    (upload, megastep, completion), their messages in `sync_warnings`."""

    def __init__(self, vios: List):
        if not vios:
            raise ValueError("BatchedStream needs at least one estimator")
        v0 = vios[0]
        for v in vios:
            if not v.cfg.stream:
                raise ValueError("BatchedStream requires cfg.stream=True")
            if v.wc != v0.wc or v.device != v0.device or v.jdt != v0.jdt:
                raise ValueError("the lanes must share the window "
                                 "configuration, device and dtype")
            v._dispatch_hook = self._on_dispatch
        self.vios = vios
        self.B = len(vios)
        self.device = v0.device
        self._lane = {id(v): i for i, v in enumerate(vios)}
        self._slots: List = [None] * self.B
        self._stacked = None
        self._last_args = None
        self._spans = spans.Recorder()
        self._span = self._spans.span
        self.timing = self._spans.timing
        self._n_steps = 0
        self.check_dispatch_syncs = False
        self.dispatch_syncs = 0
        self.sync_warnings: List[str] = []
        self._vmega = batched_megastep(v0.wc, v0._ba_opts, v0.cfg.marg_caps,
                                       v0.cfg.ne_mode, v0.cfg.ne_chunk)
        self._programs = graphs.ProgramCache()

    # ------------------------------------------------------------------
    def _on_dispatch(self, vio, blob, host_seeds, meta):
        self._slots[self._lane[id(vio)]] = (blob, meta)

    def _upload(self, blobs: List[np.ndarray]) -> torch.Tensor:
        """The B blobs as one (B, n) tensor, as the program takes it: on
        the card a fresh pinned buffer (copied into the program without
        waiting), on the CPU the tensor."""
        src = torch.from_numpy(np.stack(blobs))
        if self.device.type != "cuda":
            return src.to(self.device)
        buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        return buf

    def _program(self, args):
        """The batched megastep for these arguments' lane count: captured
        on first use on the card, eager on the CPU."""
        return self._programs.get(self._vmega, args, self.device, carry=True,
                                  label=f"batched_megastep(B={self.B})")

    # ------------------------------------------------------------------
    def step(self, frames):
        """Feed one frame per sequence; returns the lanes' `process_frame`
        outputs. Once every lane has dispatched this frame, runs the
        batched megastep once; a frame on which only some lanes dispatched
        breaks the lockstep and raises."""
        if len(frames) != self.B:
            raise ValueError(f"{len(frames)} frames for {self.B} lanes")
        self._slots = [None] * self.B
        with self._span("host_lanes"):
            outs = [v.process_frame(*f) for v, f in zip(self.vios, frames)]

        filled = [s is not None for s in self._slots]
        if not any(filled):
            return outs  # pre-init and warmup frames (synchronous path)
        if not all(filled):
            raise RuntimeError(
                "lockstep violated: only a subset of sequences dispatched "
                "this frame (mismatched init timing or warmup lengths)")
        if self._stacked is None:
            # the handoff: each lane's host state goes up once
            self._stacked = stack([v._initial_dev_state()
                                   for v in self.vios])
        with self._span("stack_upload"):
            blobs = self._upload([s[0] for s in self._slots])
            v0 = self.vios[0]
            args = (self._stacked, blobs, v0._ext, v0._gravity_j,
                    v0._imu_info, v0._sqrt_info_img)
        check = self.check_dispatch_syncs and self.device.type == "cuda"
        with self._span("dispatch"):
            step = self._program(args)  # captured before the check
            with recorded_syncs(check) as msgs:
                self._stacked, summaries = step(*args)
        with recorded_syncs(check) as more, self._span("complete"):
            for i, v in enumerate(self.vios):
                v._stream_complete(summaries[i], self._slots[i][1])
        msgs += more
        # the state after this step and the blobs on the device, for
        # device_steady_ms and cost_analysis
        on_dev = (step.inputs[1] if isinstance(step, graphs.Program)
                  else blobs.to(self.device))
        self._last_args = (self._stacked, on_dev, *args[2:])
        self.dispatch_syncs += len(msgs)
        self.sync_warnings.extend(msgs)
        self._n_steps += 1
        return outs

    # ------------------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def device_steady_ms(self, reps: int = 20):
        """Steady-state ms of one batched megastep without the host feed:
        the last step's blobs chained through the program `reps` times
        (state fed back on the device), one synchronize at the end: the
        replays' time on the card plus one launch each. The live state is
        saved first and put back after, so the lanes go on from where they
        were. None before the first batched step."""
        if self._last_args is None:
            return None
        saved = graphs.clone(self._stacked)
        step = self._program(self._last_args)
        st, blobs, *rest = self._last_args
        self._sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            st, _ = step(st, blobs, *rest)
        self._sync()
        dt = (time.perf_counter() - t0) / reps * 1e3
        self._stacked = saved
        self._last_args = (saved, blobs, *rest)
        return dt

    def cost_analysis(self):
        """Floating-point operations of ONE batched megastep (all B lanes)
        on the last step's arguments, as `torch.utils.flop_counter.
        FlopCounterMode` counts them in an eager run of the function (which
        changes no state): matrix products only, elementwise work and
        factorizations uncounted, so a lower bound. Returns {"flops": n}
        or None before the first batched step."""
        if self._last_args is None:
            return None
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as fc:
            self._vmega(*self._last_args)
        return {"flops": float(fc.get_total_flops())}

    # ------------------------------------------------------------------
    def flush(self):
        for v in self.vios:
            v.flush()
