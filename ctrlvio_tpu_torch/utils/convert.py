"""Carry window state across from numpy into the port's tensors.

The system has no learned weights: its state is the window parameters,
the packed factor tuples, the marginalization prior, the extrinsics and the
configuration. `from_numpy` turns such a NamedTuple (the JAX package's or
the port's own, its fields taken as numpy arrays) into the port's tuple of
the same name with tensors on a given device, so both packages can be fed
the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from ctrlvio_tpu_torch.ops import factors
from ctrlvio_tpu_torch.solver import layout

TYPES = {cls.__name__: cls for cls in (
    layout.WindowParams, layout.ImageFactors, layout.ImuFactors,
    layout.BiasFactors, layout.PriorFactor, factors.CamExtrinsics)}


def tensor(x, device="cpu", dtype=None):
    """One array-like -> a new tensor (never a view of the caller's array,
    which the host code goes on mutating): floating values take `dtype`
    (default: their own), integers become int64, booleans stay boolean."""
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    elif a.dtype != np.bool_ and dtype is not None:
        return torch.tensor(a, device=device).to(dtype)
    return torch.tensor(a, device=device)


def from_numpy(obj, device="cpu", dtype=None):
    """A NamedTuple of arrays (WindowParams, ImageFactors, ImuFactors,
    BiasFactors, PriorFactor, CamExtrinsics) -> the port's NamedTuple of
    tensors on `device`, floating fields cast to `dtype` if given."""
    cls = TYPES.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"from_numpy: no port type for {type(obj).__name__}")
    return cls(*(tensor(f, device, dtype) for f in obj))


def to_dtype(obj, dtype):
    """Cast the floating tensors of a port NamedTuple to `dtype`."""
    return type(obj)(*(f.to(dtype) if f.is_floating_point() else f
                       for f in obj))
