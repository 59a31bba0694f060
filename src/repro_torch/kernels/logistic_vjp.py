"""Fused margin-loss value+gradient on the card (logistic and hinge).

The CUDA source, ``csrc/logistic_vjp.cu``, replaces the TPU kernel
``repro/kernels/logistic_vjp.py:_margin_kernel`` and says how its design
meets the H100's memory bound: one launch that reads each row of A once.
This module binds it.  ``plan`` sizes the launch on the host (row ranges,
threads, column chunks, cluster width, ring stages) and is what the CPU
tests check; the wrapper checks its operands, allocates outputs and
scratch with ``torch.empty``, launches on PyTorch's current stream, raises
if the launch failed, and counts the launch.  Two losses share the one
kernel body, as on the TPU:

  * ``logistic`` — l(m) = log(1 + exp(-m)), the paper's workload;
  * ``hinge``    — the smoothed hinge of width ``gamma`` (the svm loss).

The kernel masks the ragged row and column edges itself, so shards are
staged once, unpadded, and no call copies A.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build

# launches per loss since the last reset (a launch = one wrapper call)
LAUNCHES = {"logistic": 0, "hinge": 0}
BODY = "one_pass"
_LOSS_KIND = {"logistic": 0, "hinge": 1}
MAX_THREADS = 512             # kMaxThreads in the source
# float4 column chunks per thread at most, by loader (bulk copy or
# cp.async, whose loader and masked loads take more registers): at 512
# threads ptxas has 128 registers, and these caps build without a spill
MAX_CHUNKS = {True: 5, False: 4}
MAX_CLUSTER = 8               # blocks that share a row range
STAGE_BYTES = 48 * 1024       # rows per ring stage: as many as fit
RING_BYTES = 200 * 1024       # of the 227 KB a block may hold
MAX_STAGES = 8                # kMaxStages
# per device, the (lane, cluster rank) arrival counters; zero between calls
_ARRIVALS: Dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("logistic_vjp").margin_vjp_f32
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: ``groups`` contiguous ranges of the W N flattened rows,
    each read by a cluster of ``cluster`` blocks of ``threads`` threads;
    block rank c owns columns [c cols, min(D, (c + 1) cols)), held as
    ``chunks`` float4 chunks per thread; rows stream through ``stages``
    ring stages of ``rows_per_stage`` rows, by bulk copy (``bulk``) or
    by 4-byte cp.async."""
    W: int
    N: int
    D: int
    groups: int
    cluster: int
    cols: int
    threads: int
    chunks: int
    rows_per_stage: int
    stages: int
    bulk: bool

    def ranges(self) -> List[Tuple[int, int]]:
        """[start, end) of each range over the flattened rows, as the
        kernel computes them: the first R % G ranges one row longer."""
        q, rem = divmod(self.W * self.N, self.groups)
        starts = [g * q + min(g, rem) for g in range(self.groups + 1)]
        return list(zip(starts[:-1], starts[1:]))

    def touchers(self, w: int) -> List[int]:
        """The ranges that touch lane w, in the order the kernel sums
        their partials (scratch slot g + w each)."""
        return [g for g, (s, e) in enumerate(self.ranges())
                if s < (w + 1) * self.N and e > w * self.N]

    @property
    def scratch_slots(self) -> int:
        return self.groups + self.W - 1

    @property
    def smem_bytes(self) -> int:
        return 4 * self.stages * self.rows_per_stage * (-(-self.cols // 4) * 4)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def max_d(bulk: bool) -> int:
    """The widest row a launch takes: ``MAX_CLUSTER`` blocks of
    ``MAX_THREADS`` threads holding ``MAX_CHUNKS[bulk]`` float4 chunks
    each."""
    return MAX_CLUSTER * 4 * MAX_THREADS * MAX_CHUNKS[bulk]


@functools.lru_cache(maxsize=256)
def plan(W: int, N: int, D: int, n_sms: int, bulk: bool = None) -> Plan:
    """The launch for A (W, N, D) on a card with ``n_sms`` SMs, rows by
    bulk copy or not (``bulk``; by default when D % 4 == 0).  A row wider
    than one block holds is split over a cluster of 2, 4 or 8 blocks;
    threads are the fewest warps (a power of two, 32 to 512) that hold a
    block's columns in at most 4 chunks each, up to ``MAX_CHUNKS`` at 512
    threads.  Raises ValueError above ``max_d(bulk)`` columns."""
    if bulk is None:
        bulk = D % 4 == 0
    if W < 1 or N < 1 or D < 1 or n_sms < 1 or (bulk and D % 4):
        raise ValueError(f"plan needs positive sizes (and D % 4 == 0 for "
                         f"bulk copies), got (W, N, D) = {(W, N, D)}, "
                         f"n_sms={n_sms}, bulk={bulk}")
    per_block = 4 * MAX_THREADS * MAX_CHUNKS[bulk]
    if D > max_d(bulk):
        raise ValueError(f"margin kernel: D = {D} columns exceeds the limit "
                         f"of {max_d(bulk)} ({MAX_CLUSTER} blocks of "
                         f"{per_block} columns)")
    cluster = 1
    while -(-D // cluster) > per_block:
        cluster *= 2
    # a cluster's blocks own columns in whole float4 chunks
    cols = D if cluster == 1 else -(-D // (4 * cluster)) * 4
    chunks4 = -(-cols // 4)
    threads = min(MAX_THREADS, max(32, _pow2_at_least(-(-chunks4 // 4))))
    chunks = -(-chunks4 // threads)
    row_bytes = 4 * (-(-cols // 4) * 4)
    rows_per_stage = max(1, STAGE_BYTES // row_bytes)
    stages = min(MAX_STAGES, RING_BYTES // (rows_per_stage * row_bytes))
    groups = max(1, min(n_sms // cluster, W * N))
    return Plan(W, N, D, groups, cluster, cols, threads, chunks,
                rows_per_stage, stages, bulk)


def bulk_loader(A, x) -> bool:
    """Whether rows can go by bulk copy: 16-byte aligned rows and x."""
    D = A.shape[-1]
    return D % 4 == 0 and A.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _arrivals(dev, n: int) -> torch.Tensor:
    buf = _ARRIVALS.get(dev)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("margin_vjp_cuda: call it once outside CUDA "
                               "graph capture first, to allocate its arrival "
                               "counters")
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _ARRIVALS[dev] = buf
    return buf


def device_plan(W: int, N: int, D: int, device, bulk: bool = None) -> Plan:
    """``plan`` for these shapes on the card ``device``."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return plan(W, N, D,
                torch.cuda.get_device_properties(index).multi_processor_count,
                bulk)


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
    if not (W > 0 and D > 0):
        raise ValueError(f"unsupported shape (W, N, D) = {(W, N, D)}")
    _check("A", A, (W, N, D), dev)
    _check("b", b, (W, N), dev)
    _check("mask", mask, (W, N), dev)
    _check("x", x, (W, D), dev)
    f = torch.empty((W,), dtype=torch.float32, device=dev)
    grad = torch.empty((W, D), dtype=torch.float32, device=dev)
    p = device_plan(W, max(N, 1), D, dev, bulk_loader(A, x))
    part_grad = torch.empty((p.scratch_slots * D,), dtype=torch.float32,
                            device=dev)
    part_loss = torch.empty((p.scratch_slots,), dtype=torch.float32,
                            device=dev)
    arrivals = _arrivals(dev, W * p.cluster)
    with torch.cuda.device(dev):
        rc = _fn()(A.data_ptr(), b.data_ptr(), mask.data_ptr(), x.data_ptr(),
                   f.data_ptr(), grad.data_ptr(), part_grad.data_ptr(),
                   part_loss.data_ptr(), arrivals.data_ptr(), W, N, D,
                   p.groups, p.cluster, p.cols, p.threads, p.chunks,
                   p.rows_per_stage, p.stages, int(p.bulk),
                   _LOSS_KIND[loss],
                   float(gamma), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"margin_vjp_f32 launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES[loss] += 1
    return f, grad
