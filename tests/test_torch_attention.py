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
    t_ops.cross_attention(q, kv, kv)
    t_ops.cross_attention(q[:, :1], kv, kv)
    assert t_fa.LAUNCHES == {"flash_attention": 0,
                             "flash_attention_noncausal": 0}
    assert t_dec.LAUNCHES == {"decode_attention": 0,
                              "decode_attention_partial": 0}
    assert t_dec._ARRIVALS == {}        # no arrival counters allocated
    # the kernels' wrappers take CUDA tensors only, and never fall back
    with pytest.raises(ValueError, match="CUDA"):
        t_fa.flash_attention_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        t_dec.decode_attention_cuda(q[:, :1], kv, kv,
                                    torch.tensor([5], dtype=torch.int32))


# ---------------------------------------------------------------------------
# host-side logic of the kernels, checked without a card
# ---------------------------------------------------------------------------

def _chip_smoke():
    """chip_smoke.py's shape tables (the module imports the standard
    library only until main() runs)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_library_path_changes_when_a_shared_header_changes(tmp_path,
                                                           monkeypatch):
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    first = build.library_path("k")
    assert build.library_path("k") == first           # stable
    assert first.parent == tmp_path / "out"
    (csrc / "h.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first                             # header edited
    (csrc / "other.cuh").write_text("// new\n")
    third = build.library_path("k")
    assert third not in (first, second)                # header added
    (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, second, third)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "other.cuh").unlink()
    assert build.library_path("k") != second           # flags hashed too


def _plan_cases():
    smoke = _chip_smoke()
    shapes = [(smoke.SERVE_B, smoke.SERVE_P + smoke.SERVE_GEN, 8)]
    shapes += [(B, Smax, KV) for B, Smax, _, KV, _, _ in smoke.DECODE_SMALL]
    shapes += [(B, Smax, KV) for B, Smax, _, KV, _ in smoke.DECODE_BOUNDARY]
    return shapes


@pytest.mark.parametrize("B,Smax,KV", _plan_cases())
def test_decode_split_plan_covers_the_cache_once_within_the_grid(B, Smax,
                                                                 KV):
    for n_sm in (1, 114, 132):
        for per_sm in (1, 2, 3, 4, 6, 8):
            n_split, split_len = t_dec.split_plan(B * KV, Smax, n_sm, per_sm)
            splits = [(j * split_len, min((j + 1) * split_len, Smax))
                      for j in range(n_split)]
            assert all(lo < hi for lo, hi in splits)       # none empty
            assert splits[0][0] == 0 and splits[-1][1] == Smax
            assert all(a[1] == b[0] for a, b in zip(splits, splits[1:]))
            # equal lengths but the last, which is shorter by less than one
            assert all(hi - lo == split_len for lo, hi in splits[:-1])
            assert 1 <= n_split < 2 ** 31 and B * KV <= t_dec.MAX_GRID_Y
            assert split_len >= min(Smax, t_dec.MIN_SPLIT) or n_split == 1
            if B * KV <= n_sm * per_sm:                     # one wave
                assert n_split * B * KV <= n_sm * per_sm


def test_decode_split_plan_at_the_serving_shape():
    # B * KV = 64 over 2 112 slots on 132 SMs holding 4 blocks each: 8
    # splits of 264 slots, 512 blocks in one wave of 528
    assert t_dec.split_plan(64, 2112, 132, 4) == (8, 264)
    assert t_dec.split_plan(64, 2112, 132, 3) == (6, 352)
    with pytest.raises(ValueError):
        t_dec.split_plan(0, 2112, 132, 4)


def test_flash_body_by_type_and_head_dim():
    assert t_fa.body(torch.bfloat16, 128) == "wgmma"
    assert t_fa.body(torch.bfloat16, 64) == "wgmma"
    assert t_fa.body(torch.bfloat16, 80) == "scalar"
    assert t_fa.body(torch.float32, 128) == "scalar"
    smoke = _chip_smoke()
    # the chip smoke's small bf16 shapes reach both bodies, the wgmma one at
    # hd 64 and 128, G = 5 and 7, lengths off and under the 128-key tile, a
    # window under a tile and a K/V ring that wraps at least twice
    shapes = smoke.FLASH_SMALL
    bodies = {t_fa.body(torch.bfloat16, hd) for *_, hd, _ in shapes}
    assert bodies == {"wgmma", "scalar"}
    wg = [(B, S, H, KV, hd, w) for B, S, H, KV, hd, w in shapes
          if t_fa.body(torch.bfloat16, hd) == "wgmma"]
    assert {hd for *_, hd, _ in wg} == {64, 128}
    assert {5, 7} <= {H // KV for _, _, H, KV, _, _ in wg}
    assert any(S % 128 for _, S, *_ in wg) and any(S < 128 for _, S, *_ in wg)
    assert any(w is not None and w < 128 for *_, w in wg)
    stages = {64: 4, 128: 3}
    assert all(any(-(-S // 128) > 2 * stages[h] for _, S, _, _, hd, _ in wg
                   if hd == h) for h in (64, 128))

