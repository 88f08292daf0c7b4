"""The front end's epipolar F-RANSAC gate on the step's own state: kernel
K7 and its plain version.

The fused tracker (`frontend/fused.py`) runs the gate of the JAX
package's `ctrlvio_tpu/frontend/fransac.py::reject_with_f` inside its
step, on what the step carries from the frame before: the lifted points
(`prev_norm`), the slots it published (`prev_pub`) and those the gate
suppressed (`suppress`).
`fgate` gives, for this step's lifted points `norm` and its tracked,
refilled and live masks:

- supp1 = suppress & ~refilled (a refilled slot holds a new feature);
- same = tracked & prev_pub & ~supp1, the tracks common to both frames;
- where same holds at MIN_TRACKS slots or more, `reject_with_f` on them
  in slot order (prev_norm[same], norm[same], `thresh` in virtual px,
  seed 0), and bad = same & ~inlier; elsewhere bad is all False;
- suppress_out = supp1 | bad and prev_pub_out = live & ~suppress_out.

`reject_with_f` draws its 200 samples of 8 from `default_rng(0)` anew on
each call, so they depend on the number of tracks n alone: `sample_table`
holds them for every n up to the tracker's slots, made once.

`fgate_plain` is the plain PyTorch version (float64, `torch.linalg.svd`).
`fgate` is the wrapper: CPU tensors take the plain version; CUDA tensors
launch K7 (`csrc/fgate.cu`) once, or raise. It replaces no TPU kernel: the
JAX package runs the gate in numpy on the host (`ctrlvio_tpu/frontend/
fused.py`'s `_consume`). `fgate.launches` counts K7's launches and
`fgate_plain.calls` the plain version's runs; `counts()` reads them
(settled with `utils/graphs.py`: a launch in a captured program counts on
each replay), `reset_counts()` zeroes them.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ctrlvio_tpu_torch.utils import graphs

VIRTUAL_FOCAL = 460.0  # ≙ feature_tracker::FOCAL_LENGTH (parameters.cpp)
HYPS = 200         # hypotheses (`reject_with_f`'s iters)
SAMPLE = 8         # points a hypothesis
MIN_TRACKS = 12    # fewer common tracks: nothing is rejected
MIN_REFIT = 8      # fewer inliers: no (more) refit
REFITS = 2
MAX_N = 256        # slots K7 takes (the table's positions are uint8)
WORDS = MAX_N // 32


# ---------------------------------------------------------------------------
# the samples
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def sample_table(N: int) -> np.ndarray:
    """(N + 1, HYPS, SAMPLE) uint8: row n (MIN_TRACKS <= n <= N) the
    positions among n tracks that `reject_with_f` samples for its
    hypotheses, `np.argsort(default_rng(0).random((HYPS, n)), 1)[:, :8]`;
    the rows below MIN_TRACKS are zero. Read only."""
    if not 1 <= N <= MAX_N:
        raise ValueError(f"sample_table: N = {N} slots, the gate takes 1 to "
                         f"{MAX_N}")
    out = np.zeros((N + 1, HYPS, SAMPLE), np.uint8)
    for n in range(MIN_TRACKS, N + 1):
        draw = np.random.default_rng(0).random((HYPS, n))
        out[n] = np.argsort(draw, axis=1)[:, :SAMPLE]
    out.flags.writeable = False
    return out


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _whiten(x):
    """Hartley's normalization of points x (n, 2): (x - mu) s and T (3, 3)
    with T [x, 1] = [(x - mu) s, 1]."""
    mu = x.mean(dim=0)
    spread = torch.sqrt(((x - mu) ** 2).sum(dim=1)).mean()
    s = math.sqrt(2.0) / torch.maximum(spread, spread.new_tensor(1e-9))
    z = torch.zeros_like(s)
    T = torch.stack([torch.stack([s, z, -s * mu[0]]),
                     torch.stack([z, s, -s * mu[1]]),
                     torch.stack([z, z, torch.ones_like(s)])])
    return (x - mu) * s, T


def _system(an, bn):
    """The 8-point rows [x1 x0, x1 y0, x1, y1 x0, y1 y0, y1, x0, y0, 1]
    (..., 9) of whitened points an -> bn (..., 2)."""
    x0, y0, x1, y1 = an[..., 0], an[..., 1], bn[..., 0], bn[..., 1]
    return torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                        torch.ones_like(x0)], dim=-1)


def _epipolar_dist(F, a, b):
    """Symmetric epipolar distance (S, n) of a -> b (n, 2) under F (S, 3,
    3), as the JAX package's `fransac._epipolar_dist`."""
    one = torch.ones_like(a[:, :1])
    ah, bh = torch.cat([a, one], dim=1), torch.cat([b, one], dim=1)
    l1 = torch.einsum("sij,nj->sni", F, ah)
    l0 = torch.einsum("sji,nj->sni", F, bh)
    num = torch.abs(torch.einsum("ni,sni->sn", bh, l1))
    tiny = num.new_tensor(1e-12)
    d1 = num / torch.maximum(torch.hypot(l1[..., 0], l1[..., 1]), tiny)
    d0 = num / torch.maximum(torch.hypot(l0[..., 0], l0[..., 1]), tiny)
    return torch.maximum(d0, d1)


def gate_mask_plain(a, b, sel, thresh: float):
    """`reject_with_f`'s inliers among n tracks a -> b (n, 2, float64,
    virtual px) with the samples sel (HYPS, SAMPLE): (mask (n,), the
    distances (n,) the mask was taken from, each hypothesis's inliers
    (HYPS, n))."""
    an, T0 = _whiten(a)
    bn, T1 = _whiten(b)

    def unnorm(v):
        return torch.einsum("ji,sjk,kl->sil", T1, v.reshape(-1, 3, 3), T0)

    A = _system(an[sel], bn[sel])
    A = A / torch.clamp(torch.linalg.norm(A, dim=-1, keepdim=True), min=1e-12)
    d = _epipolar_dist(unnorm(torch.linalg.svd(A)[2][:, -1]), a, b)
    inl = d < thresh
    best = int(torch.argmax(inl.sum(dim=1)))  # the first of equals
    mask, d = inl[best], d[best]
    for _ in range(REFITS):
        if int(mask.sum()) < MIN_REFIT:
            break
        Vh = torch.linalg.svd(_system(an[mask], bn[mask]))[2]
        d = _epipolar_dist(unnorm(Vh[-1]), a, b)[0]
        mask = d < thresh
    return mask, d, inl


def fgate_plain(norm, prev_norm, tracked, refilled, live, prev_pub, suppress,
                table, thresh: float):
    """(bad, suppress_out, prev_pub_out), each (N,) bool (see the module
    notes): norm, prev_norm (N, 2) float32; the masks (N,) bool; table the
    (N + 1, HYPS, SAMPLE) uint8 of `sample_table`."""
    fgate_plain.calls += 1
    supp1 = suppress & ~refilled
    same = tracked & prev_pub & ~supp1
    bad = torch.zeros_like(same)
    idx = torch.nonzero(same).flatten()
    n = idx.numel()
    if n >= MIN_TRACKS:
        a = prev_norm[idx].to(torch.float64) * VIRTUAL_FOCAL
        b = norm[idx].to(torch.float64) * VIRTUAL_FOCAL
        mask = gate_mask_plain(a, b, table[n].long(), thresh)[0]
        bad[idx[~mask]] = True
    supp = supp1 | bad
    return bad, supp, live & ~supp


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its entry points' signatures declared, its
    constants checked against this module's."""
    from ctrlvio_tpu_torch.utils import cuda_build

    lib = cuda_build.load("fgate")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fgate.argtypes = [p, p, p, p, p, p, p, p, i, ctypes.c_double, p, p,
                          p, p, p, p, p]
    lib.fgate.restype = i
    lib.fgate_geometry.argtypes = [p]
    lib.fgate_geometry.restype = None
    lib.fgate_attributes.argtypes = [p]
    lib.fgate_attributes.restype = i
    geo = (ctypes.c_int * 7)()
    lib.fgate_geometry(geo)
    want = (HYPS, SAMPLE, MIN_TRACKS, MAX_N, WORDS)
    if tuple(geo[:5]) != want:
        raise RuntimeError(f"fgate: the kernel's constants {tuple(geo[:5])} "
                           f"are not the wrapper's {want}")
    return lib


ATTRIBUTES = ("registers", "local_bytes", "shared_bytes",
              "max_threads_per_block")


def kernel_attributes():
    """K7's resources on the card (`cudaFuncGetAttributes`) and its launch
    geometry (blocks, threads a block)."""
    out = (ctypes.c_longlong * len(ATTRIBUTES))()
    err = _lib().fgate_attributes(out)
    if err != 0:
        raise RuntimeError(f"fgate_attributes: cudaError {err}")
    geo = (ctypes.c_int * 7)()
    _lib().fgate_geometry(geo)
    return {**dict(zip(ATTRIBUTES, out)), "blocks": geo[5],
            "threads": geo[6]}


_MASKS = ("tracked", "refilled", "live", "prev_pub", "suppress")


def _check(norm, prev_norm, masks, table):
    """Raise unless the tensors are what K7 takes: one CUDA device,
    (N, 2) float32 points, (N,) bool masks, the (N + 1, HYPS, SAMPLE)
    uint8 table, all contiguous, 1 <= N <= MAX_N."""
    dev = norm.device
    if dev.type != "cuda":
        raise ValueError(f"fgate: unsupported device {dev}")
    N = norm.shape[0]
    if not 1 <= N <= MAX_N:
        raise ValueError(f"fgate: N = {N} slots, K7 takes 1 to {MAX_N}")
    want = [("norm", norm, torch.float32, (N, 2)),
            ("prev_norm", prev_norm, torch.float32, (N, 2)),
            *[(k, m, torch.bool, (N,)) for k, m in zip(_MASKS, masks)],
            ("table", table, torch.uint8, (N + 1, HYPS, SAMPLE))]
    for name, t, dtype, shape in want:
        if t.device != dev:
            raise ValueError(f"fgate: {name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"fgate: {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"fgate: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"fgate: {name} must be contiguous")


def fgate(norm, prev_norm, tracked, refilled, live, prev_pub, suppress,
          table, thresh: float):
    """(bad, suppress_out, prev_pub_out) of the gate (see `fgate_plain`).
    CPU tensors take the plain version; CUDA tensors launch K7 once, or
    raise."""
    if norm.device.type == "cpu":
        return fgate_plain(norm, prev_norm, tracked, refilled, live,
                           prev_pub, suppress, table, thresh)
    masks = (tracked, refilled, live, prev_pub, suppress)
    _check(norm, prev_norm, masks, table)
    dev, N = norm.device, norm.shape[0]
    bad, supp, pub = (torch.empty((N,), dtype=torch.bool, device=dev)
                      for _ in range(3))
    counts = torch.empty((HYPS,), dtype=torch.int32, device=dev)
    words = torch.empty((HYPS, WORDS), dtype=torch.int32, device=dev)
    ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().fgate(
            norm.data_ptr(), prev_norm.data_ptr(),
            *[m.data_ptr() for m in masks], table.data_ptr(), N,
            float(thresh), bad.data_ptr(), supp.data_ptr(), pub.data_ptr(),
            counts.data_ptr(), words.data_ptr(), ticket.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fgate: K7 launch failed (cudaError {err})")
    fgate.launches += 1
    return bad, supp, pub


def reset_counts():
    """Set K7's launch count and the plain version's call count to 0."""
    fgate.launches = 0
    fgate_plain.calls = 0


def _counts():
    return {"fgate": fgate.launches, "fgate_plain": fgate_plain.calls}


def _add_counts(delta):
    fgate.launches += delta.get("fgate", 0)
    fgate_plain.calls += delta.get("fgate_plain", 0)


reset_counts()
counts = graphs.register_counter(_counts, _add_counts)
