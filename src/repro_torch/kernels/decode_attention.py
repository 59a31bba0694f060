"""Single-token GQA decode attention on the card.

The CUDA source, ``csrc/decode_attention.cu``, replaces the TPU kernel
``repro/kernels/decode_attention.py:_kernel``.  It reads the KV cache in the
model's layout (B, Smax, KV, hd) — no per-call transpose of the cache — and
writes o in (B, 1, H, hd).  One wrapper call is one launch of one kernel:
split-KV blocks that read K and V in one pass, the last live split of each
(b, kv) merging the partials in split order (an integer arrival counter,
reset by the kernel itself, so a CUDA graph replays it).  ``split_plan``
sizes the splits on the host from the cache length, the SM count and the
kernel's occupancy.  The wrapper checks its operands, allocates the output
and the split partials with ``torch.empty``, launches on PyTorch's current
stream and raises if the launch failed.  Its plain version is
``models/attention.decode_attention``.

``decode_attention_partial_cuda`` is the same kernel's partial mode, for a
cache whose slot axis is split over ranks: the caches hold slots
[slot_offset, slot_offset + S) of an ``s_total``-slot cache, liveness
follows the global positions and ring rule, and the launch writes the
shard's float32 softmax state (o normalised by its own l, m, l) for
``models/attention.combine_partials`` to merge across the shards.  Its
plain version is ``models/attention.decode_attention_partial``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = {"decode_attention": 0, "decode_attention_partial": 0}
BODY = "split_kv"
MAX_HEAD_DIM = 128
MAX_GROUP = 8
MAX_GRID_Y = 65535
# fewest slots a split takes: below this a block's warps run out of tiles
MIN_SPLIT = 32
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
# per device, the (b, kv) arrival counters; zero between calls
_ARRIVALS: Dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    part = lib.decode_attention_partial_fwd
    part.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                     + [ctypes.c_int] * 9
                     + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                        ctypes.c_void_p])
    part.restype = ctypes.c_int
    lib.decode_attention_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    lib.decode_attention_blocks_per_sm.restype = ctypes.c_int
    return lib


def split_plan(n_bkv: int, Smax: int, n_sm: int,
               per_sm: int) -> Tuple[int, int]:
    """(n_split, split_len) for ``n_bkv`` = B * KV sequences-and-heads over
    an ``Smax``-slot cache, on ``n_sm`` SMs that each hold ``per_sm``
    blocks: as many splits as fill one wave of resident blocks, at least
    ``MIN_SPLIT`` slots each, all of one length (the last may be shorter),
    covering [0, Smax) exactly once."""
    if n_bkv < 1 or Smax < 1 or n_sm < 1 or per_sm < 1:
        raise ValueError(f"split_plan needs positive sizes, got n_bkv="
                         f"{n_bkv}, Smax={Smax}, n_sm={n_sm}, per_sm="
                         f"{per_sm}")
    n_split = max(1, min(n_sm * per_sm // n_bkv, Smax // MIN_SPLIT))
    split_len = -(-Smax // n_split)
    return -(-Smax // split_len), split_len


def device_plan(dtype, B: int, KV: int, G: int, hd: int, Smax: int,
                device) -> Tuple[int, int]:
    """``split_plan`` for these shapes on the card ``device``."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _plan(index, _TYPES[dtype], B * KV, G, hd, Smax)


@functools.lru_cache(maxsize=None)
def _plan(index: int, is_bf16: int, n_bkv: int, G: int, hd: int,
          Smax: int) -> Tuple[int, int]:
    # cached: the host's cost per decode step is part of its latency
    with torch.cuda.device(index):
        per_sm = _lib().decode_attention_blocks_per_sm(is_bf16, G, hd)
    if per_sm <= 0:
        raise RuntimeError(f"decode_attention_blocks_per_sm failed with CUDA "
                           f"error {-per_sm}")
    n_sm = torch.cuda.get_device_properties(index).multi_processor_count
    return split_plan(n_bkv, Smax, n_sm, per_sm)


def _arrivals(dev, n: int) -> torch.Tensor:
    buf = _ARRIVALS.get(dev)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attention_cuda: call it once outside "
                               "CUDA graph capture first, to allocate its "
                               "arrival counters")
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=dev)
        _ARRIVALS[dev] = buf
    return buf


def _checked(name, q, k_cache, v_cache, positions):
    """(B, Smax, KV, G, hd) of operands the kernel takes; raises on any
    other."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if q.dtype not in _TYPES:
        raise ValueError(f"decode attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    vec = 16 // q.element_size()          # 16-byte copies
    for what, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != dev or t.dtype != q.dtype or t.dim() != 4:
            raise ValueError(f"{what} must be a 4-d {q.dtype} tensor on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: the head dim must be contiguous and "
                             f"the other strides multiples of {vec}, from a "
                             f"16-byte aligned base; got {t.stride()}")
    B, one, H, hd = q.shape
    _, Smax, KV, _ = k_cache.shape
    if one != 1 or tuple(k_cache.shape) != (B, Smax, KV, hd) \
            or tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"need q (B, 1, H, hd) and caches (B, Smax, KV, "
                         f"hd); got {tuple(q.shape)}, {tuple(k_cache.shape)}"
                         f", {tuple(v_cache.shape)}")
    if KV == 0 or H % KV or H // KV > MAX_GROUP or hd > MAX_HEAD_DIM \
            or hd % vec or Smax == 0 or B * KV > MAX_GRID_Y:
        raise ValueError(f"need H = G * KV with G <= {MAX_GROUP}, hd <= "
                         f"{MAX_HEAD_DIM} a multiple of {vec}, Smax > 0 and "
                         f"B * KV <= {MAX_GRID_Y}; got B={B}, H={H}, KV={KV},"
                         f" hd={hd}, Smax={Smax}")
    if positions.device != dev or positions.dtype != torch.int32 \
            or tuple(positions.shape) != (B,) or not positions.is_contiguous():
        raise ValueError(f"positions must be a contiguous ({B},) int32 tensor "
                         f"on {dev}")
    return B, Smax, KV, H // KV, hd


def _scratch(q, B, Smax, KV, G, hd):
    """The split plan, its partials' scratch and the arrival counters."""
    n_split, split_len = device_plan(q.dtype, B, KV, G, hd, Smax, q.device)
    part = torch.empty((B * KV * n_split * G * (hd + 2),),
                       dtype=torch.float32, device=q.device)
    return n_split, split_len, part, _arrivals(q.device, B * KV)


def decode_attention_cuda(q, k_cache, v_cache, positions) -> torch.Tensor:
    """q (B, 1, H, hd), caches (B, Smax, KV, hd), positions (B,) int32 ->
    o (B, 1, H, hd); CUDA tensors, q and the caches of one type (float32
    or bfloat16), H = G * KV with G <= 8, hd <= 128."""
    B, Smax, KV, G, hd = _checked("decode_attention_cuda", q, k_cache,
                                  v_cache, positions)
    dev = q.device
    lib = _lib()
    o = torch.empty((B, 1, KV * G, hd), dtype=q.dtype, device=dev)
    n_split, split_len, part, arrivals = _scratch(q, B, Smax, KV, G, hd)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(2), *k_cache.stride()[:3],
        *v_cache.stride()[:3], o.stride(0), o.stride(2))
    with torch.cuda.device(dev):
        rc = lib.decode_attention_fwd(
            _TYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), positions.data_ptr(), o.data_ptr(),
            part.data_ptr(), arrivals.data_ptr(), B, Smax, KV, G, hd,
            n_split, split_len, strides, hd ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention_fwd launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["decode_attention"] += 1
    return o


def decode_attention_partial_cuda(q, k_cache, v_cache, positions,
                                  slot_offset: int, s_total: int):
    """The partial mode: caches (B, S, KV, hd) holding slots [slot_offset,
    slot_offset + S) of an ``s_total``-slot cache, q and positions as
    ``decode_attention_cuda`` -> (o (B, 1, H, hd), m (B, 1, H), l (B, 1,
    H)), float32: the shard's output normalised by its own l, its score
    max (natural-log units, floored at -1e30) and its sum of exponentials
    (0 where no slot of the shard is live, o 0 there)."""
    B, S, KV, G, hd = _checked("decode_attention_partial_cuda", q, k_cache,
                               v_cache, positions)
    slot_offset, s_total = int(slot_offset), int(s_total)
    if slot_offset < 0 or slot_offset + S > s_total:
        raise ValueError(f"slots [{slot_offset}, {slot_offset + S}) are not "
                         f"inside a cache of {s_total}")
    dev = q.device
    lib = _lib()
    H = KV * G
    o = torch.empty((B, 1, H, hd), dtype=torch.float32, device=dev)
    m = torch.empty((B, 1, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, 1, H), dtype=torch.float32, device=dev)
    n_split, split_len, part, arrivals = _scratch(q, B, S, KV, G, hd)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(2), *k_cache.stride()[:3],
        *v_cache.stride()[:3], o.stride(0), o.stride(2))
    with torch.cuda.device(dev):
        rc = lib.decode_attention_partial_fwd(
            _TYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), positions.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), part.data_ptr(), arrivals.data_ptr(),
            B, S, KV, G, hd, n_split, split_len, slot_offset, s_total,
            strides, hd ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention_partial_fwd launch failed with "
                           f"CUDA error {rc}")
    LAUNCHES["decode_attention_partial"] += 1
    return o, m, l
