"""Fused ADMM z-update on the card.

The CUDA source, ``csrc/soft_threshold.cu``, replaces the TPU kernel
``repro/kernels/soft_threshold.py:_kernel``: z = S(ω̄; thr),
||z - z_old||² and nnz(z) in one sweep over ``plan(D, n_sms)`` blocks,
combined in the same launch with a fixed-order float64 sum (rounded once
to float32) and an exact count.
The wrapper checks its operands, allocates outputs and scratch with
``torch.empty``, launches on PyTorch's current stream, raises if the
launch failed, and counts the launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import build

LAUNCHES = {"soft_threshold": 0}
BODY = "blocks"
THREADS = 256                 # kThreads in the source
# per device, the arrival counter; zero between calls
_ARRIVALS: Dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    LAUNCHES["soft_threshold"] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("soft_threshold")
    lib.soft_threshold_f32.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
        + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p])
    lib.soft_threshold_f32.restype = ctypes.c_int
    lib.empty_launch.argtypes = [ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int
    return lib


def plan(D: int, n_sms: int) -> int:
    """Blocks for a length-D update: one per 4 * THREADS elements (a
    float4 per thread), at most one per SM.  The kernel indexes elements
    with int32, so a thread's last index plus the grid's stride must stay
    below 2^31 (granite_moe's 3.46e8-element expert leaves are far
    inside)."""
    if D < 1 or n_sms < 1:
        raise ValueError(f"plan needs D >= 1 and n_sms >= 1, got {D}, "
                         f"{n_sms}")
    blocks = min(-(-D // (4 * THREADS)), n_sms)
    if D > 2 ** 31 - blocks * THREADS:
        raise ValueError(f"plan: D = {D} overflows the kernel's int32 "
                         f"element index")
    return blocks


def _arrivals(dev) -> torch.Tensor:
    buf = _ARRIVALS.get(dev)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("soft_threshold_cuda: call it once outside "
                               "CUDA graph capture first, to allocate its "
                               "arrival counter")
        buf = torch.zeros((1,), dtype=torch.int32, device=dev)
        _ARRIVALS[dev] = buf
    return buf


def soft_threshold_cuda(omega, z_old, thr: float):
    """omega, z_old (D,) float32 contiguous CUDA tensors; thr is rounded
    to float32.  Returns (z_new (D,), ssq () float32, nnz () int64)."""
    dev = omega.device
    if dev.type != "cuda":
        raise ValueError(f"soft_threshold_cuda needs CUDA tensors, got {dev}")
    for name, t in (("omega", omega), ("z_old", z_old)):
        if t.device != dev or t.dtype != torch.float32 or t.dim() != 1:
            raise ValueError(f"{name} must be a float32 vector on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    D = omega.shape[0]
    if z_old.shape[0] != D or D == 0:
        raise ValueError(f"omega and z_old must share a length > 0, got "
                         f"{D} and {z_old.shape[0]}")
    blocks = plan(D, torch.cuda.get_device_properties(dev)
                  .multi_processor_count)
    z = torch.empty((D,), dtype=torch.float32, device=dev)
    ssq = torch.empty((), dtype=torch.float32, device=dev)
    nnz = torch.empty((), dtype=torch.int64, device=dev)
    # float64 ssq partials, then int32 nnz partials
    part = torch.empty((3 * blocks,), dtype=torch.int32, device=dev)
    arrivals = _arrivals(dev)
    with torch.cuda.device(dev):
        rc = _lib().soft_threshold_f32(
            omega.data_ptr(), z_old.data_ptr(), float(thr), z.data_ptr(),
            ssq.data_ptr(), nnz.data_ptr(), part.data_ptr(),
            part[2 * blocks:].data_ptr(), arrivals.data_ptr(), D, blocks,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"soft_threshold_f32 launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["soft_threshold"] += 1
    return z, ssq, nnz


def empty_launch(device="cuda") -> None:
    """Launches an empty kernel (not counted): timed in a CUDA graph it is
    the launch floor of any small kernel."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        rc = _lib().empty_launch(torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty_launch failed with CUDA error {rc}")
