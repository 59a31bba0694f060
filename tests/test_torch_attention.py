"""The attention kernels' plain versions against the JAX package.

On the CPU the port's wrappers (``kernels/ops.py``) run the plain versions
in ``repro_torch/models/attention.py``, because their tensors lie on the
CPU; the CUDA kernels themselves are held against those plain versions on
the card by ``chip_smoke.py``.  Here the plain versions are held against
the reference's Pallas kernels in interpret mode
(``flash_attention_pallas``, ``decode_attention_pallas``) and its oracles
(``ref.flash_attention_ref``, ``ref.decode_attention_ref``), on GQA, MHA
and MQA heads, a window, lengths off the tile, differing positions and a
ring cache that has wrapped.  Inputs are made with numpy and handed to
both packages.  Tolerance 1e-5 in float32: the sums run in other orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import decode_attention as j_dec           # noqa: E402
from repro.kernels import flash_attention as j_fa             # noqa: E402
from repro.kernels import ref as j_ref                        # noqa: E402
from repro.models import attention as j_attn                  # noqa: E402
from repro_torch.kernels import decode_attention as t_dec     # noqa: E402
from repro_torch.kernels import flash_attention as t_fa       # noqa: E402
from repro_torch.kernels import ops as t_ops                  # noqa: E402
from repro_torch.kernels import ref as t_ref                  # noqa: E402
from repro_torch.models import attention as t_attn            # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, shape):
    # distinct values per head, so a head indexed as g*KV + kv shows
    return (rng.randn(*shape) * 0.5).astype(np.float32)


def _pallas_flash(q, k, v, window, block):
    B, S, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qr = (q.reshape(B, S, KV, G, hd).transpose(0, 2, 3, 1, 4)
          .reshape(B * KV, G * S, hd))
    kr = k.transpose(0, 2, 1, 3).reshape(B * KV, Skv, hd)
    vr = v.transpose(0, 2, 1, 3).reshape(B * KV, Skv, hd)
    o = j_fa.flash_attention_pallas(
        jnp.asarray(qr), jnp.asarray(kr), jnp.asarray(vr), seq_q=S,
        causal=True, window=window, block_q=block, block_kv=block,
        interpret=True)
    return (np.asarray(o).reshape(B, KV, G, S, hd).transpose(0, 3, 1, 2, 4)
            .reshape(B, S, H, hd))


# (B, S, H, KV, hd, window): tests/test_kernels.py's sweep plus a length
# off the tile (200 against the 128 block and the port's 64-row tiles)
FLASH = [
    (1, 256, 4, 4, 64, None),         # MHA
    (2, 256, 4, 2, 64, None),         # GQA
    (1, 512, 2, 2, 64, 128),          # sliding window
    (1, 256, 8, 1, 64, None),         # MQA
    (2, 200, 8, 2, 32, 40),           # GQA G = 4, ragged, window
]


@pytest.mark.parametrize("B,S,H,KV,hd,window", FLASH)
def test_flash_plain_matches_pallas_interpret_and_oracle(B, S, H, KV, hd,
                                                         window):
    rng = np.random.RandomState(S + H + KV)
    q = _rand(rng, (B, S, H, hd))
    k = _rand(rng, (B, S, KV, hd))
    v = _rand(rng, (B, S, KV, hd))
    got = t_ops.flash_attention(*map(torch.as_tensor, (q, k, v)),
                                window=window).numpy()
    np.testing.assert_allclose(got, _pallas_flash(q, k, v, window, 128),
                               **TOL)
    oracle = j_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), window=window)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)
    t_oracle = t_ref.flash_attention_ref(*map(torch.as_tensor, (q, k, v)),
                                         window=window)
    np.testing.assert_allclose(t_oracle.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("chunk", [512, 64, 48])
def test_block_attention_matches_the_reference_sweep(chunk):
    """The port's sweep, with chunks that do and do not divide the length,
    against the reference's ``block_attention`` (GQA, window, q offset 0)."""
    rng = np.random.RandomState(chunk)
    B, S, H, KV, hd = 2, 96, 8, 2, 16
    q, k, v = (_rand(rng, (B, S, n, hd)) for n in (H, KV, KV))
    for window in (None, 20):
        got = t_attn.block_attention(*map(torch.as_tensor, (q, k, v)),
                                     window=window, chunk=chunk)
        want = j_attn.block_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), window=window,
                                      chunk=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (B, Smax, H, KV, hd, positions): tests/test_kernels.py's sweep, then a
# cache off the tile with position 0, and a ring cache that has wrapped
DECODE = [
    (2, 512, 4, 4, 64, [170, 511]),
    (2, 512, 8, 2, 64, [170, 511]),
    (1, 1024, 4, 1, 128, [341]),
    (3, 300, 8, 2, 32, [0, 299, 57]),
    (2, 300, 4, 1, 16, [349, 12]),    # sequence 0 wrapped: pos >= Smax
]


@pytest.mark.parametrize("B,Smax,H,KV,hd,positions", DECODE)
def test_decode_plain_matches_pallas_interpret_and_oracle(B, Smax, H, KV, hd,
                                                          positions):
    rng = np.random.RandomState(Smax + H)
    q = _rand(rng, (B, 1, H, hd))
    kc = _rand(rng, (B, Smax, KV, hd))
    vc = _rand(rng, (B, Smax, KV, hd))
    pos = np.asarray(positions, np.int32)
    got = t_ops.decode_attention(*map(torch.as_tensor, (q, kc, vc, pos)))
    G = H // KV
    pallas = j_dec.decode_attention_pallas(
        jnp.asarray(q.reshape(B, KV, G, hd)),
        jnp.asarray(kc.transpose(0, 2, 1, 3)),
        jnp.asarray(vc.transpose(0, 2, 1, 3)), jnp.asarray(pos),
        block_s=128, interpret=True)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(pallas).reshape(B, 1, H, hd), **TOL)
    oracle = j_ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(kc),
                                        jnp.asarray(vc), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    t_oracle = t_ref.decode_attention_ref(
        *map(torch.as_tensor, (q, kc, vc, pos)))
    np.testing.assert_allclose(t_oracle.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("ring", [False, True])
def test_update_cache_writes_in_place_like_the_reference(ring):
    rng = np.random.RandomState(3)
    cache = _rand(rng, (3, 8, 2, 4))
    new = _rand(rng, (3, 1, 2, 4))
    pos = np.asarray([0, 7, 13 if ring else 5], np.int32)
    want = j_attn.update_cache(jnp.asarray(cache), jnp.asarray(new),
                               jnp.asarray(pos), ring=ring)
    t_cache = torch.as_tensor(cache.copy())
    out = t_attn.update_cache(t_cache, torch.as_tensor(new),
                              torch.as_tensor(pos), ring=ring)
    assert out is t_cache
    np.testing.assert_array_equal(t_cache.numpy(), np.asarray(want))


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    t_fa.reset_launches()
    t_dec.reset_launches()
    rng = np.random.RandomState(0)
    q = torch.as_tensor(_rand(rng, (1, 8, 4, 16)))
    kv = torch.as_tensor(_rand(rng, (1, 8, 2, 16)))
    t_ops.flash_attention(q, kv, kv)
    t_ops.decode_attention(q[:, :1], kv, kv, torch.tensor([5]))
    assert t_fa.LAUNCHES == {"flash_attention": 0}
    assert t_dec.LAUNCHES == {"decode_attention": 0}
    # the kernels' wrappers take CUDA tensors only, and never fall back
    with pytest.raises(ValueError, match="CUDA"):
        t_fa.flash_attention_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        t_dec.decode_attention_cuda(q[:, :1], kv, kv,
                                    torch.tensor([5], dtype=torch.int32))
