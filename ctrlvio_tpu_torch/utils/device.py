"""Device selection for the port's entry points, and a count of the host
reads a piece of code makes on the card.

Entry points run on the card unless the caller asks for the CPU: a CUDA
device that is not available is an error, never a quiet CPU run.
"""

from __future__ import annotations

import contextlib
import warnings

import torch

# what torch.cuda.set_sync_debug_mode("warn") says of a synchronizing call
SYNC_WARNING = "called a synchronizing CUDA operation"


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def recorded_syncs(enabled: bool = True):
    """Yield a list that, on exit, holds "file:line: message" for each
    synchronizing CUDA call made inside (sync debug mode "warn"); empty when
    not `enabled`. Setting the mode warns that it is a prototype: that
    notice is not a sync and is not counted."""
    found = []
    if not enabled:
        yield found
        return
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    found.extend(f"{w.filename}:{w.lineno}: {w.message}" for w in caught
                 if SYNC_WARNING in str(w.message))
