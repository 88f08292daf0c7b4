"""ctypes binding for the native host runtime (the port's
`ctrlvio_tpu_torch/csrc/feature_table.cpp`).

`NativeFeatureTable` has the interface of `features.FeatureTable` plus the
image-factor packing of `packing.pack_image_factors`, implemented in C++.
The library builds at first use with `g++ -O2 -shared -fPIC` into
`build/host/` at the repository root, named by a hash of the source and
the flags. There is no fallback: a failed build raises, and the caller
(`CtrlVIO` with `use_native=True`) fails with it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ctrlvio_tpu_torch.ops import so3np
from ctrlvio_tpu_torch.solver.layout import ImageFactors, WindowConfig

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "feature_table.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libfeature_table-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the host library if it is not built yet; raises on failure."""
    path = library_path()
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native feature table cannot "
                           "be built (use_native=False takes the python one)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed (rc "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The built library with its signatures, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        ip = ctypes.POINTER(ctypes.c_int)

        lib.ft_create.restype = ctypes.c_void_p
        lib.ft_create.argtypes = [ctypes.c_int, ctypes.c_double]
        lib.ft_destroy.argtypes = [ctypes.c_void_p]
        lib.ft_add_frame.restype = ctypes.c_int
        lib.ft_add_frame.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, i64p, f64p, f64p]
        lib.ft_pack.restype = ctypes.c_int
        lib.ft_pack.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                i32p, f32p, f32p, f32p, i32p, f32p, f32p, f32p,
                                i32p, u8p, u8p, f32p, ip]
        lib.ft_set_depths.argtypes = [ctypes.c_void_p, f32p]
        lib.ft_triangulate.argtypes = [ctypes.c_void_p, ctypes.c_int, f64p,
                                       f64p]
        lib.ft_slide_old.argtypes = [ctypes.c_void_p, f64p, f64p, f64p, f64p]
        lib.ft_slide_second_new.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ft_remove_failures.argtypes = [ctypes.c_void_p]
        lib.ft_slot_fids.restype = ctypes.c_int
        lib.ft_slot_fids.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int]
        lib.ft_set_depths_by_id.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            i64p, f32p]
        lib.ft_num_tracks.restype = ctypes.c_int
        lib.ft_num_tracks.argtypes = [ctypes.c_void_p]
        lib.ft_last_track_num.restype = ctypes.c_int
        lib.ft_last_track_num.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeFeatureTable:
    """C++ feature table with the python FeatureTable's interface plus
    fused factor packing. Ids are int64, points and poses f64, depths f32
    (the library's own types)."""

    def __init__(self, window_size: int = 10,
                 min_parallax: float = 10.0 / 460.0):
        self._lib = load()
        self._h = self._lib.ft_create(window_size, min_parallax)
        self.window_size = window_size

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ft_destroy(self._h)
            self._h = None

    def add_frame(self, frame_count, ids, pts, rows) -> bool:
        ids = np.ascontiguousarray(ids, np.int64)
        pts = np.ascontiguousarray(np.asarray(pts)[:, :2], np.float64)
        rows = np.ascontiguousarray(rows, np.float64)
        return bool(self._lib.ft_add_frame(self._h, int(frame_count),
                                           len(ids), ids, pts, rows))

    def pack_image_factors(self, kf_t_ns, dt: float, win_knot0: int,
                           cfg: WindowConfig, dtype=np.float32):
        """(ImageFactors of numpy arrays, dinv seeds (LM,), candidates
        packed), as `packing.pack_image_factors` returns them."""
        OBS, LM = cfg.OBS, cfg.LM
        i0_i = np.zeros(OBS, np.int32)
        f_i = np.zeros(OBS, np.float32)
        row_i = np.zeros(OBS, np.float32)
        pt_i = np.zeros((OBS, 3), np.float32)
        i0_j = np.zeros(OBS, np.int32)
        f_j = np.zeros(OBS, np.float32)
        row_j = np.zeros(OBS, np.float32)
        pt_j = np.zeros((OBS, 3), np.float32)
        lm_idx = np.zeros(OBS, np.int32)
        valid = np.zeros(OBS, np.uint8)
        marg = np.zeros(OBS, np.uint8)
        dinv = np.full(LM, 0.2, np.float32)
        ncand = ctypes.c_int(0)
        self._lib.ft_pack(
            self._h, np.ascontiguousarray(kf_t_ns, np.int64),
            np.int64(round(dt * 1e9)), np.int64(win_knot0), OBS, LM,
            i0_i, f_i, row_i, pt_i, i0_j, f_j, row_j, pt_j, lm_idx, valid,
            marg, dinv, ctypes.byref(ncand))
        fa = ImageFactors(
            i0_i=i0_i, f_i=f_i, row_i=row_i, pt_i=pt_i, i0_j=i0_j, f_j=f_j,
            row_j=row_j, pt_j=pt_j, lm_idx=lm_idx,
            valid=valid.astype(bool), marg_drop=marg.astype(bool))
        if ncand.value > LM:
            # ft_pack reports the untruncated candidate count; only LM slots
            # were packed
            import logging

            logging.getLogger(__name__).warning(
                "landmark capacity LM=%d exceeded (%d candidate tracks): "
                "dropping %d landmarks. Raise WindowConfig.LM "
                "(auto_landmark_slots(max_cnt) sizes it from the tracker "
                "cap).", LM, ncand.value, ncand.value - LM)
        return fa, dinv.astype(dtype), min(ncand.value, LM)

    def set_depths(self, dinv):
        """Inverse depths in pack slot order (LM,)."""
        self._lib.ft_set_depths(self._h,
                                np.ascontiguousarray(dinv, np.float32))

    def triangulate(self, cam_q, cam_p):
        R = np.ascontiguousarray(so3np.quat_to_matrix(np.asarray(cam_q)),
                                 np.float64)
        self._lib.ft_triangulate(self._h, len(cam_p), R,
                                 np.ascontiguousarray(cam_p, np.float64))

    def slide_old(self, marg_R, marg_p, new_R, new_p):
        self._lib.ft_slide_old(
            self._h, np.ascontiguousarray(marg_R, np.float64),
            np.ascontiguousarray(marg_p, np.float64),
            np.ascontiguousarray(new_R, np.float64),
            np.ascontiguousarray(new_p, np.float64))

    def slide_second_new(self, frame_count: int):
        self._lib.ft_slide_second_new(self._h, int(frame_count))

    def remove_failures(self):
        self._lib.ft_remove_failures(self._h)

    def slot_fids(self, cap: int) -> np.ndarray:
        """Current candidate feature ids in pack slot order."""
        out = np.zeros(cap, np.int64)
        n = self._lib.ft_slot_fids(self._h, out, cap)
        return out[:n]

    def set_depths_by_id(self, ids, dinv):
        ids = np.ascontiguousarray(ids, np.int64)
        self._lib.ft_set_depths_by_id(
            self._h, len(ids), ids, np.ascontiguousarray(dinv, np.float32))

    @property
    def n_tracks(self) -> int:
        return self._lib.ft_num_tracks(self._h)

    @property
    def last_track_num(self) -> int:
        return self._lib.ft_last_track_num(self._h)
