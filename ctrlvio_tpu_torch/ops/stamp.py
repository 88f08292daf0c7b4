"""Device stamps: the stamp op and its plain version.

A stamp writes a clock reading into a ring of rows (int64): one row a
stamped run of a captured program, one slot a tag
(`utils/spans.py::StampRing` lays the row out and reads it). On the card
the kernel (`csrc/stamp.cu`) writes the card's `%globaltimer`; off it the
plain version, `stamp_plain`, writes the host's `time.time_ns()`. Modes
(`csrc/stamp.cu` says what each does): `START` (zero the head's row, then
stamp), `MARK`, `TRIP` (the next of the row's trip slots) and `END` (stamp,
then move the head on).

Both go through the mutating custom op `torch.ops.ctrlvio_tpu_torch.stamp_`,
so a profiler links each launch to the range that made it, as K4's
`lm_accept_` is linked. `stamp` is the wrapper: it stamps nothing in a
program's warm-up before its capture (a run that only readies the
libraries, which no reader expects a row of), and the plain version writes
nothing while a program is captured, as a capture on the card runs
nothing. `stamp.launches` counts the kernel's launches and
`stamp_plain.calls` the plain version's; `counts()` reads them, settled as
`utils/graphs.py` settles every registered count.
"""

from __future__ import annotations

import ctypes
import functools
import time

import torch

from ctrlvio_tpu_torch.utils import graphs

OP = "ctrlvio_tpu_torch::stamp_"
SEQ, N_TRIPS = 0, 1
START, MARK, TRIP, END = 0, 1, 2, 3


def stamp_plain(ring: torch.Tensor, head: torch.Tensor, slot: int,
                mode: int) -> None:
    """The stamp on the host's clock (see the module notes)."""
    stamp_plain.calls += 1
    if graphs.capturing():
        return
    t = time.time_ns()
    h = int(head[0])
    row = ring[h % ring.shape[0]]
    if mode == START:
        row.zero_()
        row[SEQ] = h
    if mode == TRIP:
        k = int(row[N_TRIPS])
        if slot + k < row.shape[0]:
            row[slot + k] = t
        row[N_TRIPS] = k + 1
    else:
        row[slot] = t
    if mode == END:
        head[0] = h + 1


@functools.lru_cache(maxsize=None)
def _lib():
    from ctrlvio_tpu_torch.utils import cuda_build

    lib = cuda_build.load("stamp")
    p = ctypes.c_void_p
    lib.stamp.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, p]
    lib.stamp.restype = ctypes.c_int
    return lib


def _check(ring, head, slot, mode):
    if ring.dtype != torch.int64 or head.dtype != torch.int64:
        raise TypeError("stamp: the ring and its head must be int64")
    if ring.dim() != 2 or not ring.is_contiguous():
        raise ValueError("stamp: the ring must be a contiguous (rows, "
                         "slots) tensor")
    if head.numel() != 1 or head.device != ring.device:
        raise ValueError("stamp: the head must be one value on the ring's "
                         "device")
    if not (0 <= slot < ring.shape[1]) or mode not in (START, MARK, TRIP,
                                                       END):
        raise ValueError(f"stamp: slot {slot} or mode {mode} out of range")


def _launch(ring, head, slot, mode):
    with torch.cuda.device(ring.device):
        launcher(ring, head, slot, mode)()
    stamp.launches += 1


stamp_op = torch.library.custom_op(
    OP, stamp_plain, mutates_args=("ring", "head"),
    schema="(Tensor(a!) ring, Tensor(b!) head, int slot, int mode) -> ()")
stamp_op.register_kernel("cuda")(_launch)
stamp_op.register_fake(lambda *args: None)


def stamp(ring: torch.Tensor, head: torch.Tensor, slot: int,
          mode: int) -> None:
    """One stamp into `ring` at its head's row (see the module notes): the
    kernel for CUDA tensors, the plain version for CPU ones; nothing in a
    program's warm-up."""
    if graphs.warming_up():
        return
    stamp_op(ring, head, slot, mode)


def launcher(ring: torch.Tensor, head: torch.Tensor, slot: int, mode: int):
    """A function of no arguments that makes one stamp with the least host
    work there is, for timing a stamp against the host's clock: the
    kernel's C entry point for CUDA tensors (no dispatch, not counted),
    the plain version for CPU ones."""
    if ring.device.type != "cuda":
        return functools.partial(stamp_plain, ring, head, slot, mode)
    _check(ring, head, slot, mode)
    lib = _lib()
    args = (ring.data_ptr(), head.data_ptr(), ring.shape[0], ring.shape[1],
            slot, mode, torch.cuda.current_stream(ring.device).cuda_stream)

    def launch():
        err = lib.stamp(*args)
        if err != 0:
            raise RuntimeError(f"stamp: launch failed (cudaError {err})")

    return launch


def reset_counts():
    stamp.launches = 0
    stamp_plain.calls = 0


def _counts():
    return {"stamp": stamp.launches, "stamp_plain": stamp_plain.calls}


def _add_counts(delta):
    stamp.launches += delta.get("stamp", 0)
    stamp_plain.calls += delta.get("stamp_plain", 0)


reset_counts()
counts = graphs.register_counter(_counts, _add_counts)
