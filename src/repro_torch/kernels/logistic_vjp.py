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

The rows mode (``margin_rows_cuda``, planned by ``rows_plan``) takes the
same rows sparse, as ``problems.base.SparseRows`` stages them: a fixed k
nonzeros a row (ELL) and a column-major copy of each lane (CSC).  One
launch, one cluster of blocks per lane: the rows give each row's
coefficient, the CSC copy sums the gradient column by column in a fixed
order.  Its launches count under ``logistic_rows`` and ``hinge_rows``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build

# launches per loss since the last reset (a launch = one wrapper call)
LAUNCHES = {"logistic": 0, "hinge": 0, "logistic_rows": 0, "hinge_rows": 0}
BODY = "one_pass"
ROWS_BODY = "rows_csc"
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
# the rows mode: blocks of 1 024 threads, one an SM, while a wave holds
# every cluster; else blocks of 512, two an SM (the kernel's launch bounds
# give each thread 64 registers).  Shared memory a block may take in each
# case (x and a chunk of row coefficients), less 1 KB for the system's
# own per block and the kernel's static arrays
ROWS_THREADS = (1024, 512)
ROWS_SMEM = {1024: 227 * 1024 - 2048, 512: 114 * 1024 - 2048}
# the rows mode needs room for at least this many rows a chunk (or all N)
ROWS_MIN_CHUNK = 1024
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


@dataclasses.dataclass(frozen=True)
class RowsPlan:
    """One rows-mode launch: W clusters of ``cluster`` blocks of
    ``threads`` threads, one cluster a lane.  A lane's rows go in chunks
    of ``chunk_rows`` (all N when they fit), each split evenly over the
    cluster's blocks; block rank c sums the gradient over columns [c cols,
    min(d, (c + 1) cols))."""
    W: int
    N: int
    d: int
    cluster: int
    threads: int
    chunk_rows: int

    @property
    def cols(self) -> int:
        return -(-self.d // self.cluster)

    @property
    def chunks(self) -> int:
        return -(-self.N // self.chunk_rows)

    @property
    def x_floats(self) -> int:
        return -(-self.d // 4) * 4

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.x_floats + self.chunk_rows)


def rows_cluster(W: int, n_sms: int) -> int:
    """Blocks a lane: the largest power of two at most min(8, n_sms // W),
    and at least 1."""
    c = 1
    while c * 2 <= min(MAX_CLUSTER, n_sms // W):
        c *= 2
    return c


@functools.lru_cache(maxsize=256)
def rows_plan(W: int, N: int, d: int, n_sms: int) -> RowsPlan:
    """The rows-mode launch for W lanes of N rows over d columns on a card
    with ``n_sms`` SMs.  Blocks of 1 024 threads while
    W x cluster blocks fit one an SM, else 512 (two an SM) if x and
    ``ROWS_MIN_CHUNK`` rows fit half an SM's shared memory; the chunk as
    many rows as shared memory holds beside x.  Raises ValueError where x
    and ``ROWS_MIN_CHUNK`` rows do not fit one block."""
    if W < 1 or N < 0 or d < 1 or n_sms < 1:
        raise ValueError(f"rows_plan needs W, d, n_sms >= 1 and N >= 0, "
                         f"got (W, N, d) = {(W, N, d)}, n_sms={n_sms}")
    cluster = rows_cluster(W, n_sms)
    x_bytes = 4 * (-(-d // 4) * 4)
    need = 4 * min(max(N, 1), ROWS_MIN_CHUNK)
    fits = [t for t in ROWS_THREADS if ROWS_SMEM[t] - x_bytes >= need]
    if not fits:
        raise ValueError(f"margin rows mode: x of d = {d} floats and "
                         f"{need // 4} rows do not fit one block's "
                         f"{ROWS_SMEM[ROWS_THREADS[0]]} bytes of shared "
                         f"memory")
    threads = fits[0] if W * cluster <= n_sms else fits[-1]
    chunk_rows = min(max(N, 1), (ROWS_SMEM[threads] - x_bytes) // 4)
    return RowsPlan(W, N, d, cluster, threads, chunk_rows)


def device_rows_plan(W: int, N: int, d: int, device) -> RowsPlan:
    """``rows_plan`` for these shapes on the card ``device``."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return rows_plan(W, N, d, torch.cuda.get_device_properties(
        index).multi_processor_count)


def bulk_loader(A, x) -> bool:
    """Whether rows can go by bulk copy: 16-byte aligned rows and x."""
    D = A.shape[-1]
    return D % 4 == 0 and A.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}, got "
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


@functools.lru_cache(maxsize=None)
def _rows_fn():
    fn = build.load("logistic_vjp").margin_rows_f32
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def margin_rows_cuda(rows, mask, x, *, loss: str, gamma: float = 0.0):
    """The rows mode: ``rows`` a batched ``problems.base.SparseRows`` (idx,
    vals (W, N, k); b (W, N); col_ptr (W, d + 1); csc_row, csc_val (W,
    S)), mask (W, N) and x (W, d), contiguous, on one CUDA device; indices
    int32, the rest float32.  Returns (loss (W,), grad (W, d))."""
    if loss not in _LOSS_KIND:
        raise ValueError(f"unknown margin loss {loss!r}")
    idx, vals, b, col_ptr, csc_row, csc_val = rows
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"margin_rows_cuda needs CUDA tensors, got {dev}")
    if idx.dim() != 3 or x.dim() != 2 or csc_row.dim() != 2:
        raise ValueError(f"rows must be batched (W, N, k) with x (W, d), "
                         f"got idx {tuple(idx.shape)}, x {tuple(x.shape)}")
    W, N, k = idx.shape
    d = x.shape[1]
    S = csc_row.shape[1]
    _check("idx", idx, (W, N, k), dev, torch.int32)
    _check("vals", vals, (W, N, k), dev)
    _check("b", b, (W, N), dev)
    _check("mask", mask, (W, N), dev)
    _check("col_ptr", col_ptr, (W, d + 1), dev, torch.int32)
    _check("csc_row", csc_row, (W, S), dev, torch.int32)
    _check("csc_val", csc_val, (W, S), dev)
    _check("x", x, (W, d), dev)
    f = torch.empty((W,), dtype=torch.float32, device=dev)
    grad = torch.empty((W, d), dtype=torch.float32, device=dev)
    p = device_rows_plan(W, N, d, dev)
    with torch.cuda.device(dev):
        rc = _rows_fn()(idx.data_ptr(), vals.data_ptr(), b.data_ptr(),
                        mask.data_ptr(), col_ptr.data_ptr(),
                        csc_row.data_ptr(), csc_val.data_ptr(),
                        x.data_ptr(), f.data_ptr(), grad.data_ptr(),
                        W, N, k, d, S, p.cluster, p.threads, p.chunk_rows,
                        _LOSS_KIND[loss], float(gamma),
                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"margin_rows_f32 launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES[f"{loss}_rows"] += 1
    return f, grad
