"""Single-token GQA decode attention on the card.

The CUDA source, ``csrc/decode_attention.cu``, replaces the TPU kernel
``repro/kernels/decode_attention.py:_kernel``.  It reads the KV cache in the
model's layout (B, Smax, KV, hd) — no per-call transpose of the cache — and
writes o in (B, 1, H, hd).  One wrapper call is one launch of the kernel
pair (the chunked pass and its fixed-order combine) and counts once.  The
wrapper checks its operands, allocates the output and the chunk partials
with ``torch.empty``, launches on PyTorch's current stream and raises if
the launch failed.  Its plain version is ``models/attention.decode_attention``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

LAUNCHES = {"decode_attention": 0}
MAX_HEAD_DIM = 128
MAX_GROUP = 8
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("decode_attention")
    fn = lib.decode_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.decode_attention_scratch.argtypes = [ctypes.c_int] * 5
    lib.decode_attention_scratch.restype = ctypes.c_longlong
    return lib


def decode_attention_cuda(q, k_cache, v_cache, positions) -> torch.Tensor:
    """q (B, 1, H, hd), caches (B, Smax, KV, hd), positions (B,) int32 ->
    o (B, 1, H, hd); CUDA tensors, q and the caches of one type (float32
    or bfloat16), H = G * KV with G <= 8, hd <= 128."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got "
                         f"{dev}")
    if q.dtype not in _TYPES:
        raise ValueError(f"decode attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    vec, align = 4, 4 * q.element_size()     # one 4-element load a lane
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != dev or t.dtype != q.dtype or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d {q.dtype} tensor on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % align:
            raise ValueError(f"{name}: the head dim must be contiguous and "
                             f"the other strides multiples of {vec}, from a "
                             f"{align}-byte aligned base; got {t.stride()}")
    B, one, H, hd = q.shape
    _, Smax, KV, _ = k_cache.shape
    if one != 1 or tuple(k_cache.shape) != (B, Smax, KV, hd) \
            or tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"need q (B, 1, H, hd) and caches (B, Smax, KV, "
                         f"hd); got {tuple(q.shape)}, {tuple(k_cache.shape)}"
                         f", {tuple(v_cache.shape)}")
    if KV == 0 or H % KV or H // KV > MAX_GROUP or hd > MAX_HEAD_DIM \
            or hd % 4 or Smax == 0:
        raise ValueError(f"need H = G * KV with G <= {MAX_GROUP}, hd <= "
                         f"{MAX_HEAD_DIM} a multiple of 4 and Smax > 0; got "
                         f"H={H}, KV={KV}, hd={hd}, Smax={Smax}")
    if positions.device != dev or positions.dtype != torch.int32 \
            or tuple(positions.shape) != (B,) or not positions.is_contiguous():
        raise ValueError(f"positions must be a contiguous ({B},) int32 tensor "
                         f"on {dev}")
    G = H // KV
    lib = _lib()
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=dev)
    scratch = torch.empty((lib.decode_attention_scratch(B, Smax, KV, G, hd),),
                          dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(2), *k_cache.stride()[:3],
        *v_cache.stride()[:3], o.stride(0), o.stride(2))
    with torch.cuda.device(dev):
        rc = lib.decode_attention_fwd(
            _TYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), positions.data_ptr(), o.data_ptr(),
            scratch.data_ptr(), B, Smax, KV, G, hd, strides, hd ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention_fwd launch failed with CUDA "
                           f"error {rc}")
    LAUNCHES["decode_attention"] += 1
    return o
