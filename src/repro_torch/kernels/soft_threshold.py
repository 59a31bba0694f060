"""Fused ADMM z-update on the card.

The CUDA source, ``csrc/soft_threshold.cu``, replaces the TPU kernel
``repro/kernels/soft_threshold.py:_kernel``: z = S(ω̄; thr),
||z - z_old||² and nnz(z) in one sweep, with a fixed-order sum and an
exact count.  The wrapper checks its operands, allocates outputs with
``torch.empty``, launches on PyTorch's current stream, raises if the
launch failed, and counts the launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

LAUNCHES = {"soft_threshold": 0}


def reset_launches() -> None:
    LAUNCHES["soft_threshold"] = 0


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("soft_threshold").soft_threshold_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    z = torch.empty((D,), dtype=torch.float32, device=dev)
    ssq = torch.empty((), dtype=torch.float32, device=dev)
    nnz = torch.empty((), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _fn()(omega.data_ptr(), z_old.data_ptr(), float(thr),
                   z.data_ptr(), ssq.data_ptr(), nnz.data_ptr(), D,
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"soft_threshold_f32 launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["soft_threshold"] += 1
    return z, ssq, nnz
