"""Where the port's tensors live.

Entry points run on the card unless the caller asks for the CPU.  Asking
for a CUDA device where there is none raises: nothing falls back to the
CPU in silence.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA device and none is "
            f"available; pass device='cpu' to run the plain path")
    return dev


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the enclosed block only: the process's
    setting is restored on the way out."""
    on = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(on, warn_only=warn_only)
