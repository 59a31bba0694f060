"""Fused margin-loss value+gradient on the card (logistic and hinge).

The CUDA source, ``csrc/logistic_vjp.cu``, replaces the TPU kernel
``repro/kernels/logistic_vjp.py:_margin_kernel`` and says how its design
meets the H100's memory bound.  This module binds it: the wrapper checks
its operands, allocates outputs and scratch with ``torch.empty``, launches
on PyTorch's current stream, raises if the launch failed, and counts the
launch.  Two losses share the one kernel body, as on the TPU:

  * ``logistic`` — l(m) = log(1 + exp(-m)), the paper's workload;
  * ``hinge``    — the smoothed hinge of width ``gamma`` (the svm loss).

The kernel masks the ragged row and column edges itself, so shards are
staged once, unpadded, and no call copies A.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# launches per loss since the last reset (a launch = one wrapper call)
LAUNCHES = {"logistic": 0, "hinge": 0}
_LOSS_KIND = {"logistic": 0, "hinge": 1}
_COLS_PER_BLOCK = 1024        # kColsPerBlock in the source
_MIN_ROWS_PER_SPLIT = 64
_MAX_GRID_YZ = 65535


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("logistic_vjp").margin_vjp_f32
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def row_splits(W: int, N: int, D: int, n_sms: int) -> int:
    """Row ranges per lane in the gradient pass: enough blocks for about
    two waves of 8 blocks on each SM, each range at least 64 rows."""
    col_blocks = -(-D // _COLS_PER_BLOCK)
    want = -(-2 * 8 * n_sms // (col_blocks * W))
    return max(1, min(want, -(-N // _MIN_ROWS_PER_SPLIT), _MAX_GRID_YZ))


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def margin_vjp_cuda(A, b, mask, x, *, loss: str, gamma: float = 0.0):
    """A (W, N, D), b and mask (W, N), x (W, D): float32, contiguous, on one
    CUDA device.  Returns (loss (W,), grad (W, D))."""
    if loss not in _LOSS_KIND:
        raise ValueError(f"unknown margin loss {loss!r}")
    if A.dim() != 3:
        raise ValueError(f"A must be (W, N, D), got {tuple(A.shape)}")
    dev = A.device
    if dev.type != "cuda":
        raise ValueError(f"margin_vjp_cuda needs CUDA tensors, got {dev}")
    W, N, D = A.shape
    if not (0 < W <= _MAX_GRID_YZ and D > 0):
        raise ValueError(f"unsupported shape (W, N, D) = {(W, N, D)}")
    _check("A", A, (W, N, D), dev)
    _check("b", b, (W, N), dev)
    _check("mask", mask, (W, N), dev)
    _check("x", x, (W, D), dev)
    splits = row_splits(W, N, D,
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    f = torch.empty((W,), dtype=torch.float32, device=dev)
    grad = torch.empty((W, D), dtype=torch.float32, device=dev)
    coef = torch.empty((W, N), dtype=torch.float32, device=dev)
    val = torch.empty((W, N), dtype=torch.float32, device=dev)
    partial = torch.empty((splits * W * D if splits > 1 else 1,),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _fn()(A.data_ptr(), b.data_ptr(), mask.data_ptr(), x.data_ptr(),
                   f.data_ptr(), grad.data_ptr(), coef.data_ptr(),
                   val.data_ptr(), partial.data_ptr(), W, N, D, splits,
                   _LOSS_KIND[loss], float(gamma),
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"margin_vjp_f32 launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES[loss] += 1
    return f, grad
