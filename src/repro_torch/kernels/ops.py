"""Public wrappers around the hand-written kernels.

Dispatch goes by the tensor's device and nothing else: a CPU tensor runs
the plain version in ``ref.py``; a CUDA tensor launches the kernel, and a
kernel that cannot build or launch raises.  Nothing falls back.
``fused_softmax_vjp`` has no kernel, here as in the reference: it runs its
plain version on either device.

The margin wrappers take a leading worker axis: A (W, N, D), b and mask (W, N),
x (W, D) give (loss (W,), grad (W, D)); the unbatched forms drop W.  Shards
are staged unpadded; the kernels mask ragged edges themselves, so no call
copies A.  The ``_rows`` twins take the same rows sparse, as
``problems.base.SparseRows`` (what the batched solver stages for
``kernel="cuda"``), and launch the margin kernel's rows mode.

The attention kernels have no backward and autograd does not see a ctypes
launch: on the card, ``flash_attention`` and ``decode_attention`` raise when
grad mode is on and an input requires grad, rather than return a result
whose inputs would silently get no gradient.

DTensor inputs (a sharded step, ``launch/steps.py``): a DTensor has no
storage of its own, so the wrappers marked ``on_shards`` follow the rules
of ``parallel/shards.py``.  On the card an attention kernel runs on each
rank's local shards where that is exact: the batch or the heads split
alike on every operand, and for ``decode_attention`` also the cache's
slot axis, where each rank runs ``decode_attention_partial`` on its own
slots and the ranks combine their softmax states with two all-reduces
(on either device).  Any other placement raises with the placements
named: a split head dim, a query split by batch where the cache splits
its slots, K/V heads that do not split alike with the query's; nothing
of a cache is gathered to run a kernel.  Otherwise, on the CPU, the
plain attention runs on the DTensors.  The z-update takes any placement
on either device.

Each kernel call reports its operations and bytes to the hooks in
``KERNEL_HOOKS`` (``launch/op_analysis.py`` installs one while it counts a
step): a ctypes launch is invisible to PyTorch's dispatcher.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import logistic_vjp as lv_k
from repro_torch.kernels import ref
from repro_torch.kernels import soft_threshold as st_k
from repro_torch.models import attention as attn_mod
from repro_torch.parallel.shards import on_shards

# callables hook(name, flops, n_bytes), called once per kernel call on the
# card (per rank for DTensor operands)
KERNEL_HOOKS = []


def _nbytes(*tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def _report(name: str, flops: float, n_bytes: float) -> None:
    for hook in KERNEL_HOOKS:
        hook(name, float(flops), float(n_bytes))


def flash_flops(B: int, S: int, Skv: int, H: int, hd: int, causal: bool,
                window=None) -> float:
    """4 B H hd times the (query, key) pairs the kernel computes: every
    pair without a mask; under the causal mask, query i (of the last S of
    Skv positions) sees min(i + 1 + Skv - S, window) keys."""
    if not causal:
        return 4.0 * B * H * hd * S * Skv
    off = Skv - S
    pairs = sum(min(i + 1 + off, window or i + 1 + off) for i in range(S))
    return 4.0 * B * H * hd * pairs


def decode_flops(B: int, H: int, hd: int, live: float) -> float:
    """4 H hd per live cache slot of each row; ``live`` summed over rows."""
    return 4.0 * H * hd * live


def _margin(A, b, x, mask, *, loss: str, gamma: float):
    single = A.dim() == 2
    if single:
        A, b, x = A[None], b[None], x[None]
        mask = None if mask is None else mask[None]
    if mask is None:
        mask = torch.ones(A.shape[:2], dtype=torch.float32, device=A.device)
    # the kernel runs in float32 whatever the caller's dtype, as the
    # reference's wrapper casts A, b, mask and x into float32 buffers; the
    # results stay float32 (a float64 caller's arithmetic widens them).
    # Callers stage A, b and mask in float32 once, so only x is cast here
    A, b, mask, x = (t.to(torch.float32) for t in (A, b, mask, x))
    if A.is_cuda:
        f, g = lv_k.margin_vjp_cuda(A, b.contiguous(), mask.contiguous(),
                                    x.contiguous(), loss=loss, gamma=gamma)
    elif loss == "logistic":
        f, g = ref.logistic_vjp_ref(A, b, mask, x)
    else:
        f, g = ref.svm_vjp_ref(A, b, mask, x, gamma)
    return (f[0], g[0]) if single else (f, g)


def fused_logistic_vjp(A, b, x, *, mask=None):
    """Loss+grad of sum_n mask_n * log1p(exp(-b_n <a_n, x>)).

    A (N, D), b (N,) ±1, x (D,); ``mask`` an optional {0,1} row mask
    (masked rows contribute exactly zero).  A leading worker axis batches:
    A (W, N, D), b/mask (W, N), x (W, D) -> (loss (W,), grad (W, D)).
    Computed in float32 and returned in float32 for any input dtype."""
    return _margin(A, b, x, mask, loss="logistic", gamma=0.0)


def fused_svm_vjp(A, b, x, *, gamma: float, mask=None):
    """Smoothed-hinge twin of ``fused_logistic_vjp`` (``gamma`` the
    smoothing width).  Same shapes, batching and masking."""
    return _margin(A, b, x, mask, loss="hinge", gamma=float(gamma))


def rows_work(rows) -> float:
    """A rows-mode evaluation's operations: a multiply-add for the margin
    and one for the gradient per stored nonzero, 5 a row (the loss, its
    derivative and the mask)."""
    W, N, k = rows.idx.shape
    return 4.0 * W * N * k + 5.0 * W * N


def _margin_rows(rows, x, mask, *, loss: str, gamma: float):
    single = rows.idx.dim() == 2
    if single:
        rows = type(rows)(*(t[None] for t in rows))
        x = x[None]
        mask = None if mask is None else mask[None]
    if mask is None:
        mask = torch.ones(rows.b.shape, dtype=torch.float32, device=x.device)
    # float32 whatever the caller's dtype, as the dense entries: the rows
    # are staged in float32 once, so only x (and a caller's mask) is cast
    mask, x = mask.to(torch.float32), x.to(torch.float32)
    if x.is_cuda:
        f, g = lv_k.margin_rows_cuda(rows, mask.contiguous(), x.contiguous(),
                                     loss=loss, gamma=gamma)
        if KERNEL_HOOKS:          # FISTA calls this every evaluation
            _report(f"margin_rows_{loss}", rows_work(rows),
                    _nbytes(*rows, mask, x, f, g))
    elif loss == "logistic":
        f, g = ref.logistic_vjp_rows_ref(rows.idx, rows.vals, rows.b, mask, x)
    else:
        f, g = ref.svm_vjp_rows_ref(rows.idx, rows.vals, rows.b, mask, x,
                                    gamma)
    return (f[0], g[0]) if single else (f, g)


def fused_logistic_vjp_rows(rows, x, *, mask=None):
    """``fused_logistic_vjp`` over sparse rows: ``rows`` a
    ``problems.base.SparseRows`` ((W, N, k) rows, or (N, k) unbatched),
    x (W, d) or (d,), an optional {0,1} row mask.  On the card the margin
    kernel's rows mode, one launch; on the CPU its plain version (gather
    and ``add_at``).  Float32 results for any input dtype."""
    return _margin_rows(rows, x, mask, loss="logistic", gamma=0.0)


def fused_svm_vjp_rows(rows, x, *, gamma: float, mask=None):
    """Smoothed-hinge twin of ``fused_logistic_vjp_rows``."""
    return _margin_rows(rows, x, mask, loss="hinge", gamma=float(gamma))


def logistic_value_and_grad(A, b):
    """Drop-in for ``data.logreg.logistic_value_and_grad`` that routes a
    dense shard through the margin kernel: x -> (loss, grad)."""
    def vg(x):
        return fused_logistic_vjp(A, b, x)
    return vg


def fused_softmax_vjp(A, y, x, *, n_classes: int, mask=None):
    """Multinomial value+grad with the margin wrappers' contract: A (N, D),
    y (N,) int labels, x the flattened (D·C,) variable, an optional row
    mask; a leading worker axis batches (A (W, N, D), y/mask (W, N), x
    (W, D·C) -> (loss (W,), grad (W, D·C))).

    The reference has no Pallas body here: its wrapper runs the jnp oracle
    in every mode (C is small and the (N, D) @ (D, C) pair needs no kernel
    of its own).  So this runs the plain version, ``ref.softmax_vjp_ref``,
    on CPU and CUDA tensors alike, by design and not as a fallback."""
    if mask is None:
        mask = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    X = x.reshape(x.shape[:-1] + (A.shape[-1], n_classes))
    f, g = ref.softmax_vjp_ref(A, y, mask, X)
    return f, g.reshape(x.shape)


@on_shards("z_update")
def fused_z_update(omega_bar, z_old, thr):
    """z_new = S(omega_bar; thr), ||z_new - z_old||² and nnz(z_new).

    omega_bar, z_old of one shape (a vector for the kernel, or any shape,
    flattened in memory order); thr a scalar (a float or a 0-d tensor),
    rounded to float32 — on the card it is the kernel's argument, read
    back to the host."""
    if omega_bar.is_cuda:
        omega, z = omega_bar.contiguous(), z_old.contiguous()
        zn, ssq, nnz = st_k.soft_threshold_cuda(omega.view(-1), z.view(-1),
                                                float(thr))
        _report("soft_threshold", 0.0, _nbytes(omega, z, zn))
        return zn.view(omega.shape), ssq, nnz
    return ref.soft_threshold_ref(
        omega_bar, z_old, torch.as_tensor(thr, dtype=torch.float32))


def refuse_autograd(name: str, *tensors) -> None:
    """Raise if autograd would have to differentiate a kernel that has no
    backward: grad mode on and an input that requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            f"grad; differentiate through attention.block_attention (what "
            f"model.loss_fn runs) or call it under torch.no_grad()")


@on_shards("kernel")
def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q (B,S,H,hd), k/v (B,Skv,KV,hd) -> (B,S,H,hd), in the model's layout
    (no transpose on either path)."""
    if q.is_cuda:
        refuse_autograd("flash_attention", q, k, v)
        o = fa_k.flash_attention_cuda(q, k, v, causal=causal, window=window)
        _report("flash_attention", flash_flops(
            q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3],
            causal, window), _nbytes(q, k, v, o))
        return o
    return attn_mod.block_attention(q, k, v, causal=causal, window=window)


@on_shards("kernel")
def cross_attention(q, k, v):
    """q (B, Sq, H, hd), k/v (B, T, KV, hd) -> (B, Sq, H, hd), every query
    over all T keys.  On the card a prefill (Sq > 1) runs the flash
    kernel with ``causal=False``, and one query runs the decode kernel
    with every slot live (position T - 1)."""
    if q.is_cuda:
        refuse_autograd("cross_attention", q, k, v)
        B, S, H, hd = q.shape
        if S == 1:
            last = torch.full((B,), k.shape[1] - 1, dtype=torch.int32,
                              device=q.device)
            o = dec_k.decode_attention_cuda(q, k, v, last)
            _report("decode_attention", decode_flops(B, H, hd,
                                                     B * k.shape[1]),
                    _nbytes(q, k, v, o))
            return o
        o = fa_k.flash_attention_cuda(q, k, v, causal=False)
        _report("flash_attention_noncausal",
                flash_flops(B, S, k.shape[1], H, hd, False),
                _nbytes(q, k, v, o))
        return o
    return attn_mod.cross_attention(q, k, v)


def _report_decode(name, q, k_cache, pos, outs, live) -> None:
    """A decode launch's FLOPs and bytes: ``live`` (B,) the slots it read
    per row."""
    if KERNEL_HOOKS:
        n = float(live.sum())
        row = 2 * k_cache.shape[2] * k_cache.shape[3] * k_cache.element_size()
        _report(name, decode_flops(q.shape[0], q.shape[2], q.shape[3], n),
                _nbytes(q, pos, *outs) + n * row)


@on_shards("decode")
def decode_attention(q, k_cache, v_cache, positions):
    """q (B,1,H,hd), caches (B,Smax,KV,hd), positions (B,) -> (B,1,H,hd).
    On the card the cache is read in place; positions go as int32."""
    if q.is_cuda:
        refuse_autograd("decode_attention", q, k_cache, v_cache)
        pos = positions.to(torch.int32).contiguous()
        o = dec_k.decode_attention_cuda(q, k_cache, v_cache, pos)
        _report_decode("decode_attention", q, k_cache, pos, (o,),
                       torch.clamp(pos.long() + 1, max=k_cache.shape[1]))
        return o
    return attn_mod.decode_attention(q, k_cache, v_cache, positions)


def decode_attention_partial(q, k_cache, v_cache, positions,
                             slot_offset: int, s_total: int):
    """One rank's shard of a decode over a slot-split cache: caches (B, S,
    KV, hd) holding slots [slot_offset, slot_offset + S) of ``s_total``,
    global positions (B,) -> the shard's float32 (o, m, l), which
    ``attention.combine_partials`` merges across the shards.  On the card
    the decode kernel's partial mode, reporting the shard's live slots;
    on the CPU (or meta) its plain version."""
    if q.is_cuda:
        refuse_autograd("decode_attention_partial", q, k_cache, v_cache)
        pos = positions.to(torch.int32).contiguous()
        out = dec_k.decode_attention_partial_cuda(q, k_cache, v_cache, pos,
                                                  slot_offset, s_total)
        live = torch.clamp(torch.clamp(pos.long() + 1, max=s_total)
                           - slot_offset, 0, k_cache.shape[1])
        _report_decode("decode_attention_partial", q, k_cache, pos, out, live)
        return out
    return attn_mod.decode_attention_partial(q, k_cache, v_cache, positions,
                                             slot_offset, s_total)
