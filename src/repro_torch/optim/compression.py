"""ω-message sizes and the fleet codec, for ``compress="none"``.

The scheduler holds one ``OmegaCodec`` per fleet; with "none" the master
sees ω exactly and there is no state to synchronize.  Top-k and QSGD
coding wait for ROADMAP.md, Queue 1, "Scheduler: async, compression,
checkpoints".
"""
from __future__ import annotations

from typing import Dict

import torch

METHODS = ("none", "topk", "qsgd")


def _check(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"compress must be one of {METHODS}, got {method!r}")
    if method != "none":
        raise NotImplementedError(
            f"compression {method!r} is not ported yet; see ROADMAP.md, "
            f"Queue 1, 'Scheduler: async, compression, checkpoints'")


def message_bytes(method: str, d: int) -> int:
    """Worker→master wire size of one (q, ω) message for a d-vector,
    including the f32 scalar q: d+1 dense f32 under "none"."""
    _check(method)
    return 4 * (d + 1)


class OmegaCodec:
    """The fleet codec's interface, for "none": ω passes unchanged."""

    def __init__(self, method: str, d: int):
        _check(method)
        self.method = method
        self.d = d

    def encode(self, lw: int, omega: torch.Tensor) -> torch.Tensor:
        return omega

    def snapshot(self) -> Dict[int, torch.Tensor]:
        """The synchronized views to roll back to (none under "none"; a
        coding method must clone them, since tensors are mutable)."""
        return {}

    def rollback_except(self, snap: Dict[int, torch.Tensor],
                        delivered) -> None:
        """Restore the pre-round view of every worker not in
        ``delivered`` (nothing to restore under "none")."""

    def reset(self):
        """Drop synchronized state (elastic rescale re-seeds the fleet)."""
