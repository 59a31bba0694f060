"""``launch/op_analysis.py`` (the counterpart of the reference's
``launch/hlo_analysis.py``) and the kernels' DTensor rule in
``parallel/shards.py``, on the CPU.

The counter sees each rank's own program: a DTensor operator is counted as
the local operators and collectives DTensor runs for it, never at its
global shapes (``FlopCounterMode`` wrapped around a DTensor matmul counts
the global product).  The ring formulas and the pod-crossing test are the
reference's, held against its own cases.  Exact comparisons: the counts
are integers computed from shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis as j_hlo                # noqa: E402
from repro_torch.kernels import ops                           # noqa: E402
from repro_torch.launch import op_analysis as oa              # noqa: E402
from repro_torch.parallel import shards                       # noqa: E402


@pytest.fixture
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


def test_row_parallel_matmul_counts_one_rank(model16):
    """x (256, 4096) split on its columns, w (4096, 1024) on its rows: each
    rank multiplies (256, 256) by (256, 1024), and redistributing the
    partial product to Replicate is one all-reduce of T = 256 * 1024 * 4
    bytes, 2 T 15/16 link bytes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    x = distribute_tensor(torch.randn(256, 4096), model16, [Shard(1)])
    w = distribute_tensor(torch.randn(4096, 1024), model16, [Shard(0)])

    def step(x, w):
        return (x @ w).redistribute(model16, [Replicate()])
    out, s = oa.cost_summary(step, x, w)
    T = 256 * 1024 * 4
    assert s["flops_per_chip"] == 2 * 256 * 256 * 1024
    assert s["n_collective_ops"] == 1
    assert s["by_type"] == {"all-reduce": 2 * T * 15 / 16}
    assert s["per_chip_link_bytes"] == 2 * T * 15 / 16
    assert s["dcn_link_bytes"] == 0.0 and s["unknown_trip_loops"] == 0
    assert s["arg_bytes"] == (256 * 256 + 256 * 1024) * 4
    # the trap: the stock counter sees the DTensor-level product
    with FlopCounterMode(display=False) as fc:
        step(x, w)
    assert fc.get_total_flops() == 2 * 256 * 4096 * 1024


def test_bytes_views_and_peak():
    """Operand + result bytes of each operator that is not a view; the
    peak of live bytes counts the arguments and what is still held."""
    a = torch.ones(1000)

    def step(a):
        b = a * 2.0                        # 4000 in, 4000 out
        v = b.view(10, 100)                # a view: nothing
        c = v.sum()                        # 4000 in, 4 out
        del b
        return c, v
    (c, v), s = oa.cost_summary(step, a)
    assert s["bytes_per_chip"] == 4000 + 4000 + 4000 + 4
    assert s["flops_per_chip"] == 0
    assert s["arg_bytes"] == 4000
    assert s["peak_bytes_est"] == 4000 + 4000 + 4


def test_kernel_reports_are_counted():
    """A kernel launch is invisible to the dispatcher; its wrapper's
    report goes to the counter's hook."""
    counter = oa.OpCounter()
    with counter:
        ops._report("flash_attention", 123.0, 456.0)
    assert not ops.KERNEL_HOOKS
    s = counter.summary()
    assert s["flops_per_chip"] == 123.0 and s["bytes_per_chip"] == 456.0
    assert s["kernel_flops"] == {"flash_attention": 123.0}


def test_kernel_flop_formulas():
    B, H, hd = 2, 8, 64
    # causal: query i sees i + 1 keys
    assert ops.flash_flops(B, 5, 5, H, hd, True) == 4 * B * H * hd * 15
    # windowed: at most 2 keys
    assert ops.flash_flops(B, 5, 5, H, hd, True, 2) == 4 * B * H * hd * 9
    # non-causal: every pair
    assert ops.flash_flops(B, 5, 7, H, hd, False) == 4 * B * H * hd * 35
    assert ops.decode_flops(B, H, hd, 30) == 4 * H * hd * 30


@pytest.mark.parametrize("T,n", [(1024, 16), (4096, 2), (7, 1)])
def test_link_bytes_match_the_reference(T, n):
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
        assert oa._link_bytes(op, T, n) == j_hlo._link_bytes(op, T, n)
    assert oa._link_bytes("all-reduce", T, n) == (
        2 * T * (n - 1) / n if n > 1 else 0.0)


def test_crosses_pod_matches_the_reference():
    assert not oa._crosses_pod(range(16), 256)
    assert not j_hlo._crosses_pod("replica_groups=[32,16]<=[512]", 256)
    assert oa._crosses_pod([0, 256], 256)
    assert j_hlo._crosses_pod("replica_groups={{0,256},{1,257}}", 256)
    assert oa._crosses_pod(range(512), 256)
    assert j_hlo._crosses_pod("replica_groups=[1,512]<=[512]", 256)


def test_dtype_bytes_match_the_reference():
    for t, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32"),
                    (torch.int32, "s32"), (torch.int64, "s64"),
                    (torch.bool, "pred"), (torch.float64, "f64")):
        assert oa._DTYPE_BYTES[t] == j_hlo._DTYPE_BYTES[name]


# ---------------------------------------------------------------------------
# the kernels' rule on DTensors: local shards only where that is exact
# ---------------------------------------------------------------------------


def _attn_operands(mesh, q_place, kv_place, pos_place):
    from torch.distributed.tensor import distribute_tensor
    B, Smax, H, KV, hd = 4, 32, 32, 16, 8
    q = distribute_tensor(torch.randn(B, 1, H, hd), mesh, [q_place])
    k = distribute_tensor(torch.randn(B, Smax, KV, hd), mesh, [kv_place])
    v = distribute_tensor(torch.randn(B, Smax, KV, hd), mesh, [kv_place])
    pos = distribute_tensor(torch.full((B,), 5), mesh, [pos_place])
    return q, k, v, pos


def test_local_call_runs_on_heads_split_alike(model16):
    from torch.distributed.tensor import Replicate, Shard
    seen = []

    def kernel(q, k, v, pos):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(pos.shape)))
        return q * 2.0
    q, k, v, pos = _attn_operands(model16, Shard(2), Shard(2), Replicate())
    o = shards.kernel_on_shards(kernel, q, k, v, pos)
    assert seen == [((4, 1, 2, 8), (4, 32, 1, 8), (4,))]
    assert o.placements == (Shard(2),) and tuple(o.shape) == (4, 1, 32, 8)
    np.testing.assert_array_equal(o.to_local().numpy(),
                                  (q.to_local() * 2.0).numpy())


def test_local_call_refuses_a_sequence_sharded_cache(model16):
    """The decode cache's slot axis split over "model" (what
    ``cache_spec_tree`` gives) needs a softmax combine across ranks: the
    wrapper names the placements and runs nothing."""
    from torch.distributed.tensor import Replicate, Shard
    q, k, v, pos = _attn_operands(model16, Replicate(), Shard(1),
                                  Replicate())
    with pytest.raises(ValueError, match=r"Shard\(dim=1\)"):
        shards.kernel_on_shards(lambda *a: a[0], q, k, v, pos)
