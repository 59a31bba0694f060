"""The card's peaks, and the least time a piece of work could take on it.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity), which hold at the card's full power limit of 700 W: HBM3 at
3.35 TB/s; 67 TFLOP/s in float32 outside the tensor cores (what a
float32 matrix product runs at with TF32 off), 495 in TF32, 989 in bf16;
67 TFLOP/s in float64 on the tensor cores (34 outside them: the higher
rate is taken, so a share is never overstated).  The run prints the
card's name and power limit beside every share.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {
    "float32": 67e12,
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float64": 67e12,
}


@dataclasses.dataclass
class Work:
    """Operations by precision and bytes that some work needs."""
    flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        flops = dict(self.flops)
        for k, v in other.flops.items():
            flops[k] = flops.get(k, 0.0) + v
        return Work(flops, self.bytes + other.bytes)

    def scaled(self, n: float) -> "Work":
        return Work({k: v * n for k, v in self.flops.items()},
                    self.bytes * n)


def least_seconds(work: Work) -> float:
    """The larger of the compute time (each precision's operations over
    its peak, summed: the parts depend on one another) and the bytes over
    the memory rate."""
    compute = sum(v / FLOPS_PER_S[k] for k, v in work.flops.items())
    return max(compute, work.bytes / HBM_BYTES_PER_S)
