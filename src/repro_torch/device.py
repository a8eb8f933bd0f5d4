"""Where the port's entry points run: the card unless the caller asks
for the CPU.

``resolve_device(None)`` is ``cuda`` and raises when no CUDA device is
present; it never falls back to the CPU quietly.  ``device="cpu"`` is
the explicit opt-in the CPU tests use.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
