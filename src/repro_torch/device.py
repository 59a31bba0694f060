"""Where the port's tensors live.

Entry points run on the card unless the caller asks for the CPU.  Asking
for a CUDA device where there is none raises: nothing falls back to the
CPU in silence.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA device and none is "
            f"available; pass device='cpu' to run the plain path")
    return dev
