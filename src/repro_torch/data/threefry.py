"""JAX's threefry2x32 PRNG in PyTorch, draw-for-draw.

The reference generates every shard from ``jax.random`` with the
``jax_threefry_partitionable`` layout, so the port carries its own copy of
the pieces the data path uses: ``prng_key``, ``fold_in``, ``split``, the
32-bit random bits, and the uniform, bernoulli and normal transforms.

PyTorch has no unsigned 32-bit shifts on the CPU, so every 32-bit word
lives in an int64 tensor and is masked with ``& 0xFFFFFFFF`` after each
add and shift.  A key is a pair ``(k0, k1)`` of such tensors; broadcasting
between keys and counters gives the batched forms (one key per row, many
counters per key) that ``jax.vmap`` gives the reference.

In the partitionable layout a draw of shape ``S`` from key ``k`` hashes
the 64-bit flat index ``i`` of each element as the counter pair
``(i >> 32, i & 0xFFFFFFFF)``; ``split(k, n)[j]`` is the hash of ``(0, j)``,
which is also ``fold_in(k, j)``.
"""
from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[torch.Tensor, torch.Tensor]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & MASK32) | (v >> (32 - r))


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 block cipher (20 rounds) on int64-held words;
    key words and counters broadcast against each other."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device=None) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32)."""
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return (torch.zeros((), dtype=torch.int64, device=device),
            torch.tensor(seed, dtype=torch.int64, device=device))


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``; ``data`` may be a tensor of indices, which
    gives one key per index (the reference's ``vmap(fold_in)``)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key[0].device)
    return threefry2x32(key, torch.zeros_like(data), data & MASK32)


def split(key: Key, num: int = 2) -> Key:
    """``jax.random.split(key, num)``: keys stacked on a new last axis."""
    j = torch.arange(num, dtype=torch.int64, device=key[0].device)
    k0, k1 = key
    return threefry2x32((k0[..., None], k1[..., None]), torch.zeros_like(j), j)


def split_key(keys: Key, j: int) -> Key:
    """The j-th key of a ``split`` result."""
    return keys[0][..., j], keys[1][..., j]


def random_bits(key: Key, n: int) -> torch.Tensor:
    """32-bit draws of shape ``key_shape + (n,)`` (``n`` = 0 draws a
    scalar per key): the XOR of the two hash words."""
    k0, k1 = key
    if n == 0:
        i = torch.zeros((), dtype=torch.int64, device=k0.device)
    else:
        i = torch.arange(n, dtype=torch.int64, device=k0.device)
        k0, k1 = k0[..., None], k1[..., None]
    y0, y1 = threefry2x32((k0, k1), i >> 32, i & MASK32)
    return y0 ^ y1


def mantissa(bits: torch.Tensor) -> torch.Tensor:
    """The 23 mantissa bits a uniform draw keeps; u = m * 2**-23 exactly."""
    return bits >> 9


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1), as ``jax.random.uniform`` builds it (the
    mantissa bits over an exponent of 1, minus 1; exact in float32)."""
    return mantissa(bits).to(torch.float32) * (2.0 ** -23)


def uniform(key: Key, n: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1)."""
    return bits_to_uniform(random_bits(key, n))


def bernoulli_half(key: Key) -> torch.Tensor:
    """``jax.random.bernoulli(key, 0.5)`` (scalar per key)."""
    return uniform(key) < 0.5


def randint(key: Key, span: int, bits: int = 32) -> torch.Tensor:
    """``jax.random.randint(key, (), 0, span)`` (scalar per key), drawn as
    JAX's ``_randint`` draws it: two keys from ``split(key)``, one word of
    ``bits`` random bits from each (high, low), and the value
    ``(hi % span · m + lo % span) % span`` with m = (2**(bits/2) % span)²
    % span, the remainder of the 2·bits-bit integer hi·2**bits + lo.

    ``bits`` is the width of JAX's default int: 32, or 64 when
    ``jax_enable_x64`` is on (a 64-bit word is ``(w0 << 32) | w1`` of the
    hash, not their XOR).  For a span up to 2**16 no product of the
    reference's unsigned arithmetic wraps, and the int64 words hold it."""
    if bits not in (32, 64) or not 1 <= span <= 1 << 16:
        raise ValueError(f"randint takes bits 32 or 64 and a span in "
                         f"[1, 2**16], got {bits}, {span}")
    keys = split(key, 2)
    words = []
    for j in range(2):
        k0, k1 = split_key(keys, j)
        zero = torch.zeros((), dtype=torch.int64, device=k0.device)
        y0, y1 = threefry2x32((k0, k1), zero, zero)
        # a 64-bit word held as its remainder: (y0·2**32 + y1) % span
        words.append(y0 ^ y1 if bits == 32
                     else ((y0 % span) * ((1 << 32) % span) + y1) % span)
    hi, lo = words
    mult = pow(1 << (bits // 2), 2, span)
    return ((hi % span) * mult + lo % span) % span


# Giles' single-precision erfinv, the polynomial XLA lowers erf_inv to.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv.  log1p runs in float64 and each Horner step as a
    float64 multiply-add rounded once to float32: that tracks XLA's fused
    float32 code to within 2 ulp (a plain float32 chain can land on the
    other side of the w = 5 branch and miss by thousands of ulp)."""
    w = (-torch.log1p(-(x * x).double())).to(torch.float32)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(x.dtype)
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, lo, hi).to(x.dtype)
        p = (c.double() + p.double() * w).to(torch.float32)
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, p * x)


_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
_SQRT2_F32 = float(torch.tensor(2.0 ** 0.5, dtype=torch.float32))


def normal(key: Key, n: int) -> torch.Tensor:
    """``jax.random.normal(key, (n,), float32)``: sqrt(2)·erfinv(u) with u
    uniform on (-1, 1), built as the reference builds it (scale 2 is
    exact in float32, then the offset, then a floor at the lower end)."""
    u = bits_to_uniform(random_bits(key, n))
    u = torch.clamp_min(u * 2.0 + _NORMAL_LO, _NORMAL_LO)
    return erfinv_f32(u) * _SQRT2_F32
