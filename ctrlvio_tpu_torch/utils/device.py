"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a CUDA
device that is not available is an error, never a quiet CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
