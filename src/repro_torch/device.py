"""Where the port's tensors live.

Every entry point of the port runs on the card unless the caller asks for the
CPU: ``device=None`` means ``"cuda"``. Asking for CUDA on a host without it
raises; nothing carries on quietly on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; anything else through ``torch.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the host")
    return dev
