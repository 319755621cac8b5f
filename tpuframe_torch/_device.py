"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``.  Asking for CUDA on a host without
    a GPU raises: an entry point never drops to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no GPU is visible; "
                           "pass device='cpu' to run on the CPU")
    return dev
