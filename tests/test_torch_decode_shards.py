"""Decode over a cache whose slot axis is split: the port's partial decode
(``attention.decode_attention_partial``, the plain version of the decode
kernel's partial mode) and ``attention.combine_partials``, against the JAX
package's decode on the same numpy inputs; and the placement rule that
runs them on DTensors (rule "decode" of ``parallel/shards.py``).

(i) Partials over R in {1, 2, 3, 4} chunks of the cache's slots, combined
by a reduction over a stacked axis, equal ``repro.kernels.ops.
decode_attention`` in float32 at rtol 1e-5, atol 1e-6, run as the JAX
package's own tests run it: its plain path (``REPRO_PALLAS=ref``) and the
Pallas kernel in interpret mode.  The cases: a linear cache at positions 0,
Smax - 1 and between; a ring cache that has wrapped (positions past
Smax); positions that leave whole chunks with no live slot; uneven chunks;
R = 4 beside 6 query heads (R does not divide the heads).

(ii) The rule on a fake 16-rank group (shapes and counts only: its
collectives move no data): a slot split decodes with two all-reduces of
B H (hd + 2) floats and a gather of q's heads, no gather of the scores,
and the plain partial's FLOPs; placements the kernel cannot run exactly
still raise with the placements named.

The four-rank runs of whole decode steps on real gloo groups are cases of
``tests/test_torch_steps.py`` (``DECODES``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                       # noqa: E402

from repro.kernels import ops as j_ops                        # noqa: E402
from repro_torch.kernels import decode_attention as t_dec     # noqa: E402
from repro_torch.kernels import ops as t_ops                  # noqa: E402
from repro_torch.launch import op_analysis as oa              # noqa: E402
from repro_torch.models import attention as t_attn            # noqa: E402
from repro_torch.parallel import shards                       # noqa: E402
from test_torch_data import jax_config                        # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
# (name, B, Smax, H, KV, hd, positions)
CASES = [
    ("linear", 3, 24, 8, 2, 16, [0, 23, 10]),
    ("ring", 3, 24, 8, 2, 16, [24, 40, 31]),
    ("empty", 3, 24, 8, 4, 16, [0, 3, 5]),
    ("uneven", 2, 23, 6, 3, 8, [22, 7]),
    ("gqa6", 2, 32, 6, 2, 32, [31, 100]),
]


def _inputs(B, Smax, H, KV, hd, positions, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, 1, H, hd).astype(np.float32) * 2.0
    kc = rng.randn(B, Smax, KV, hd).astype(np.float32) * 0.5
    vc = rng.randn(B, Smax, KV, hd).astype(np.float32) * 0.5
    return q, kc, vc, np.asarray(positions, np.int32)


def _stacked(parts):
    """The combine over a stacked leading axis of R shards' states."""
    o, m, l = (torch.stack(t) for t in zip(*parts))
    return t_attn.combine_partials(o, m, l, lambda t: t.amax(dim=0),
                                   lambda t: t.sum(dim=0))


def _chunked(q, kc, vc, pos, R):
    """(the R shards' (o, m, l), the slot ranges) of ``np.array_split``'s
    chunks of the slot axis."""
    Smax = kc.shape[1]
    bounds = [(int(c[0]), int(c[-1]) + 1)
              for c in np.array_split(np.arange(Smax), R)]
    parts = [t_attn.decode_attention_partial(
        *map(torch.as_tensor, (q, kc[:, lo:hi], vc[:, lo:hi], pos)), lo,
        Smax) for lo, hi in bounds]
    return parts, bounds


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("R", [1, 2, 3, 4])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_combined_partials_equal_the_references_decode(case, R, mode,
                                                       monkeypatch):
    _, B, Smax, H, KV, hd, positions = case
    q, kc, vc, pos = _inputs(B, Smax, H, KV, hd, positions)
    monkeypatch.setenv("REPRO_PALLAS", mode)
    with jax_config(jax_enable_x64=False):
        want = np.asarray(j_ops.decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(pos)))
    parts, _ = _chunked(q, kc, vc, pos, R)
    got = _stacked(parts)
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    whole = t_attn.decode_attention(*map(torch.as_tensor, (q, kc, vc, pos)))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_a_shard_with_no_live_slot_writes_the_floor_and_weighs_nothing():
    """Position 3 of 24 slots in 4 chunks: chunks 1-3 hold no live slot of
    row 0, and chunk 3 none of any row.  Such a shard writes o = 0, m =
    -1e30 and l = 0; the combine stays finite, and equals the combine of
    the live chunks alone."""
    q, kc, vc, pos = _inputs(3, 24, 8, 4, 16, [3, 9, 17])
    parts, bounds = _chunked(q, kc, vc, pos, 4)
    o, m, l = parts[3]
    assert bounds[3] == (18, 24)
    assert torch.all(o == 0) and torch.all(m == t_attn.NEG_INF) \
        and torch.all(l == 0)
    assert torch.all(parts[1][2][0] == 0)         # row 0 in chunk 1
    got = _stacked(parts)
    assert torch.isfinite(got).all()
    assert torch.equal(got[0], _stacked(parts[:1])[0])
    # every shard empty (a position before the first slot): zeros, no NaN
    none = [t_attn.decode_attention_partial(
        *map(torch.as_tensor, (q, kc[:, lo:hi], vc[:, lo:hi])),
        torch.full((3,), -1), lo, 24) for lo, hi in bounds]
    assert torch.equal(_stacked(none), torch.zeros(3, 1, 8, 16))


def test_the_combine_casts_last_and_takes_two_reductions():
    q, kc, vc, pos = _inputs(2, 16, 4, 2, 8, [15, 6])
    parts, _ = _chunked(q, kc, vc, pos, 2)
    calls = []

    def reduce(kind, fn):
        def run(t):
            calls.append((kind, tuple(t.shape)))
            return fn(t)
        return run
    o, m, l = (torch.stack(t) for t in zip(*parts))
    got = t_attn.combine_partials(o, m, l, reduce("max", lambda t: t.amax(0)),
                                  reduce("sum", lambda t: t.sum(0)),
                                  dtype=torch.bfloat16)
    assert calls == [("max", (2, 2, 1, 4)), ("sum", (2, 2, 1, 4, 9))]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _stacked(parts).to(torch.bfloat16))


def test_partial_cpu_path_launches_nothing_and_the_kernel_needs_cuda():
    t_dec.reset_launches()
    q, kc, vc, pos = map(torch.as_tensor, _inputs(2, 16, 4, 2, 8, [15, 6]))
    o, m, l = t_ops.decode_attention_partial(q, kc[:, 8:], vc[:, 8:], pos,
                                             8, 16)
    want = t_attn.decode_attention_partial(q, kc[:, 8:], vc[:, 8:], pos, 8,
                                           16)
    assert all(torch.equal(a, b) for a, b in zip((o, m, l), want))
    assert t_dec.LAUNCHES == {"decode_attention": 0,
                              "decode_attention_partial": 0}
    with pytest.raises(ValueError, match="CUDA"):
        t_dec.decode_attention_partial_cuda(q, kc, vc, pos.to(torch.int32),
                                            0, 16)


# ---------------------------------------------------------------------------
# the rule on DTensors, on a fake group (counts and shapes only)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model16():
    """A fake 16-rank group and its 1-D "model" mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    try:
        yield init_device_mesh("cpu", (16,), mesh_dim_names=("model",))
    finally:
        dist.destroy_process_group()


B, SMAX, H, KV, HD = 4, 256, 32, 8, 16


def _operands(mesh, q_place, kv_place, v_place=None):
    from torch.distributed.tensor import distribute_tensor
    q, kc, vc, pos = map(torch.as_tensor,
                         _inputs(B, SMAX, H, KV, HD, [100, 255, 0, 300]))
    return (distribute_tensor(q, mesh, [q_place]),
            distribute_tensor(kc, mesh, [kv_place]),
            distribute_tensor(vc, mesh, [v_place or kv_place]), pos)


def test_slot_split_decodes_with_two_all_reduces_and_no_score_gather(
        model16):
    """q split by heads (the column-parallel projection), the caches by
    slots over 16 ranks: rank 0 gathers q's heads (B H hd floats), runs the
    plain partial on its 16 slots (4 B H hd 16 FLOPs) and all-reduces m
    (B H floats) and the packed (o w, w) (B H (hd + 1)); nothing of size
    B H Smax is gathered.  The output comes back split by heads."""
    from torch.distributed.tensor import Shard
    q, k, v, pos = _operands(model16, Shard(2), Shard(1))
    out, s = oa.cost_summary(t_ops.decode_attention, q, k, v, pos)
    f = 15 / 16
    assert out.placements == (Shard(2),) and tuple(out.shape) == (B, 1, H,
                                                                   HD)
    assert s["by_type"]["all-reduce"] == pytest.approx(
        2 * f * 4 * (B * H + B * H * (HD + 1)))
    assert s["by_type"]["all-gather"] == pytest.approx(f * 4 * B * H * HD)
    assert s["n_collective_ops"] == 3
    assert s["flops_per_chip"] == 4 * B * H * HD * (SMAX // 16)


def test_a_split_head_dim_still_raises_on_the_kernel_path(model16):
    """The card's path (``kernel_on_shards``) runs no kernel on a head dim
    split over ranks, and names the placements."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    q, k, v, pos = _operands(model16, Shard(3), Shard(3))
    pos = distribute_tensor(pos, model16, [Replicate()])
    with pytest.raises(ValueError, match=r"Shard\(dim=3\)"):
        shards.kernel_on_shards(lambda *a: a[0], q, k, v, pos)


@pytest.mark.parametrize("case", ["batch_beside_slots", "v_not_split_alike"])
def test_a_slot_split_the_partial_cannot_run_exactly_raises(model16, case):
    """On either device: q split by batch on the mesh dim that splits the
    slots, or v not split like k there."""
    from torch.distributed.tensor import Replicate, Shard
    if case == "batch_beside_slots":
        q, k, v, pos = _operands(model16, Shard(0), Shard(1))
        match = r"Shard\(dim=0\)"
    else:
        q, k, v, pos = _operands(model16, Replicate(), Shard(1), Replicate())
        match = r"v_cache \(Replicate\(\),\)"
    with pytest.raises(ValueError, match=match):
        t_ops.decode_attention(q, k, v, pos)
