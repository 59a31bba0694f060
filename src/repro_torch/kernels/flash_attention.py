"""GQA flash attention (prefill) on the card: causal, windowed, or with
``causal=False`` (the VLM's cross-attention over its image tokens, Skv
keys for S queries), each instantiation's launches counted apart.

The CUDA source, ``csrc/flash_attention.cu``, replaces the TPU kernel
``repro/kernels/flash_attention.py:_kernel``.  It takes the model's layouts
as they are — q (B, S, H, hd), k/v (B, Skv, KV, hd) — and writes o in
(B, S, H, hd), so no call transposes or copies q, k or v.  The wrapper
checks its operands, allocates the output with ``torch.empty``, launches on
PyTorch's current stream, raises if the launch failed, and counts the
launch.  Its plain version is ``models/attention.block_attention``.

Two bodies (``body``): bf16 at head dim 64 or 128, the serving path, runs
the warp-specialised wgmma body, whose K and V tiles come in by TMA through
tensor maps encoded at each call over k and v as they lie (16-byte aligned
bases and strides, which ``_check_rows`` enforces); float32 and other head
dims run the scalar float32 body.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

# causal (or windowed) launches, and the causal=False instantiation's
LAUNCHES = {"flash_attention": 0, "flash_attention_noncausal": 0}
MAX_HEAD_DIM = 128
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def body(dtype, hd: int) -> str:
    """The kernel body a call with this type and head dim runs (the CUDA
    source dispatches the same way)."""
    return "wgmma" if dtype == torch.bfloat16 and hd in (64, 128) \
        else "scalar"


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_rows(name, t, dev, dtype, vec):
    """Last dim contiguous, other strides and the base 16-byte aligned."""
    if t.device != dev or t.dtype != dtype or t.dim() != 4:
        raise ValueError(f"{name} must be a 4-d {dtype} tensor on {dev}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: the head dim must be contiguous and the "
                         f"other strides multiples of {vec} elements, from a "
                         f"16-byte aligned base; got strides {t.stride()}")


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, Skv, KV, hd) -> o (B, S, H, hd), all CUDA
    tensors of one type (float32 or bfloat16); H a multiple of KV and
    hd <= 128.  Query head h = kv * G + g attends with KV head kv."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if q.dtype not in _TYPES:
        raise ValueError(f"flash attention takes float32 or bfloat16, got "
                         f"{q.dtype}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t, dev, q.dtype, vec)
    B, S, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    if tuple(k.shape) != (B, Skv, KV, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, Skv, KV, hd) = "
                         f"({B}, Skv, KV, {hd}); got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if KV == 0 or H % KV or hd > MAX_HEAD_DIM or hd % vec:
        raise ValueError(f"need H % KV == 0, hd <= {MAX_HEAD_DIM} and hd a "
                         f"multiple of {vec}; got H={H}, KV={KV}, hd={hd}")
    if B * KV > 65535:
        raise ValueError(f"B * KV = {B * KV} exceeds the grid's 65535")
    if window is not None and not causal:
        raise ValueError("a window needs causal=True")
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o)
                                         for s in t.stride()[:3]))
    with torch.cuda.device(dev):
        rc = _fn()(_TYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   o.data_ptr(), B, S, Skv, KV, H // KV, hd, strides,
                   hd ** -0.5, int(causal), int(window or 0),
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with error "
                           f"{rc} (CUDA's; 10000 + the driver's when a "
                           f"tensor map could not be encoded)")
    LAUNCHES["flash_attention" if causal else
             "flash_attention_noncausal"] += 1
    return o
