"""ω-message compression: top-k and QSGD quantization, with error feedback —
the counterpart of ``repro.optim.compression``.

The ADMM consensus message ω = x + u is compressed before the
worker→master reduce; what the coding drops is fed back into the next
round's message, so the compressed consensus stays convergent.

* **top-k** keeps the k largest-|.| coordinates; wire cost k·(value +
  index).
* **QSGD** (Alistarh et al. '17): max-norm scaled b-bit uniform
  quantization, deterministic nearest-level rounding (half to even, as
  ``jnp.round`` and ``torch.round`` both do); wire cost d·b/8 + the scale.

``OmegaCodec`` is the runtime integration: the scheduler holds one codec
per fleet, each worker transmits the coded delta against the master's
last synchronized view, and the master's lossy view is what enters the
ω-table, so compression's cost shows in the real residuals.  Compression
is expressed densely (value · mask); the wire cost is modelled.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

METHODS = ("none", "topk", "qsgd")


def topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the k largest-|.| entries along the last axis.  The
    threshold is the k-th largest |x| (a value, whatever order a top-k
    routine leaves ties in); entries at the threshold are kept in index
    order until k are kept, as the reference's cumsum prefix keeps them."""
    k = min(k, x.shape[-1])
    mag = torch.abs(x)
    thresh = torch.topk(mag, k, dim=-1).values[..., -1:]
    mask = mag >= thresh
    cum = torch.cumsum(mask.to(torch.int32), dim=-1)
    return mask & (cum <= k)


def topk_compress(x: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (compressed dense vector, residual)."""
    comp = torch.where(topk_mask(x, k), x, torch.zeros_like(x))
    return comp, x - comp


def topk_decompress(comp: torch.Tensor) -> torch.Tensor:
    return comp


def ef_init(d: int, device=None) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


def ef_compress_update(x: torch.Tensor, err: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback step: compress (x + carried error), carry the rest."""
    return topk_compress(x + err, k)


def wire_bytes(d: int, k: int, *, dense_bytes_per_elem: int = 4,
               index_bytes: int = 4) -> Tuple[int, int]:
    """(dense message bytes, compressed message bytes) for the cost model."""
    return d * dense_bytes_per_elem, k * (dense_bytes_per_elem + index_bytes)


# ---------------------------------------------------------------------------
# QSGD-style uniform quantization
# ---------------------------------------------------------------------------


def qsgd_compress(x: torch.Tensor, bits: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(signed integer levels, scale): nearest-level b-bit quantization of
    x/max|x|.  Levels lie in [-s, s] with s = 2^(b-1) - 1."""
    s = (1 << (bits - 1)) - 1
    scale = torch.max(torch.abs(x))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    levels = torch.round(x / safe * s)
    return levels.to(torch.int32), scale


def qsgd_decompress(levels: torch.Tensor, scale: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """levels · scale / s, in the scale's dtype (the reference widens its
    float32 levels, exact integers, to a float64 scale the same way)."""
    s = (1 << (bits - 1)) - 1
    return levels.to(scale.dtype) * (scale / s)


def qsgd_bytes(d: int, bits: int) -> int:
    """Wire size of one quantized message: packed levels + f32 scale."""
    return -(-d * bits // 8) + 4


def message_bytes(method: str, d: int, *, topk_frac: float = 0.05,
                  qsgd_bits: int = 4, topk_k: Optional[int] = None) -> int:
    """Worker→master wire size of one (q, ω) message for a d-vector under
    the given codec, including the f32 scalar q."""
    if method == "topk":
        k = topk_k if topk_k is not None else max(int(d * topk_frac), 1)
        return wire_bytes(d, k)[1] + 4
    if method == "qsgd":
        return qsgd_bytes(d, qsgd_bits) + 4
    if method == "none":
        return 4 * (d + 1)
    raise ValueError(f"unknown compression method {method!r}")


# ---------------------------------------------------------------------------
# Runtime integration: the fleet codec
# ---------------------------------------------------------------------------


class OmegaCodec:
    """Stateful codec for a fleet of logical workers.

    Both endpoints track the master's last synchronized view ``sent[lw]``;
    each round worker lw transmits code(ω - sent[lw]) and both sides apply
    ``sent[lw] += decode(code)``.  ``encode`` returns the master's updated,
    lossy view, which the scheduler copies into its ω-table.  Views are
    never written in place, and ``snapshot`` clones them, so a rollback
    restores exactly what the master had ingested.
    """

    METHODS = METHODS

    def __init__(self, method: str, d: int, *, topk_frac: float = 0.05,
                 qsgd_bits: int = 4):
        if method not in METHODS:
            raise ValueError(f"compress must be one of {METHODS}, "
                             f"got {method!r}")
        self.method = method
        self.d = d
        self.k = max(int(d * topk_frac), 1)
        self.bits = qsgd_bits
        self._sent: Dict[int, torch.Tensor] = {}

    def encode(self, lw: int, omega: torch.Tensor) -> torch.Tensor:
        if self.method == "none":
            return omega
        sent = self._sent.get(lw)
        if sent is None:
            sent = torch.zeros_like(omega)
        delta = omega - sent
        if self.method == "topk":
            delta_hat, _ = topk_compress(delta, self.k)
        else:
            delta_hat = qsgd_decompress(*qsgd_compress(delta, self.bits),
                                        self.bits)
        new = sent + delta_hat
        self._sent[lw] = new
        return new

    def snapshot(self) -> Dict[int, torch.Tensor]:
        """Copies of the synchronized views, for rolling back undelivered
        messages (partial barriers)."""
        return {lw: v.clone() for lw, v in self._sent.items()}

    def rollback_except(self, snap: Dict[int, torch.Tensor],
                        delivered) -> None:
        """Restore the pre-round view for every worker NOT in
        ``delivered``: a message the master never ingested must not
        advance the shared state, or later deltas would smuggle the
        dropped content inside a k-sized wire budget."""
        if self.method == "none":
            return
        for lw in list(self._sent):
            if lw not in delivered:
                if lw in snap:
                    self._sent[lw] = snap[lw]
                else:
                    del self._sent[lw]

    def reset(self):
        """Drop synchronized state (elastic rescale re-seeds the fleet)."""
        self._sent.clear()
