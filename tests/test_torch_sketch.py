"""The port's sketched linear algebra (``repro_torch.core.sketch``) against
the JAX package's, live, in the same process.

The maps are numpy in both packages: count-sketch buckets and signs, the
SRHT rows, the dense sketches and the plan's code ``B`` must be bitwise
equal.  The block algebra runs on torch tensors against the reference's
jnp: ``apply_all``, ``apply_block``, ``block_grams``, ``sketch``, ``gram``,
``encode`` and ``decode_sum`` over every straggler subset (as
``tests/test_sketch.py`` decodes), within 1e-12 of the largest magnitude in
float64 (x64 on the JAX side; measured 4.2e-14) and within 1e-5 in float32
(summation order, magnified by cyclic decode coefficients up to about 20;
measured 1.0e-6).  The sparse-row route, (idx,
vals) with per-row weights, equals the dense route on the same matrix bit
for bit.
"""
import contextlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro.core import sketch as j_sketch                     # noqa: E402
from repro_torch.core import sketch as t_sketch               # noqa: E402

TOL = {"float64": 1e-12, "float32": 1e-5}
# (n_rows, m, seed): the reference tests' operator shapes and seeds
MAPS = [(100, 30, 0), (50, 10, 4), (16, 16, 0), (48, 32, 1), (20, 5, 0),
        (200, 8, [7, 3]), (64, 5, [9, 4])]
# (n_tasks, redundancy): the reference's exhaustive straggler grid
PLANS = [(6, 1), (8, 2), (7, 2), (5, 0)]


@contextlib.contextmanager
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def close(got, want, dtype, what):
    """Within TOL[dtype] of the largest magnitude of ``want``."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert gap <= TOL[dtype], f"{what}: {gap:.3e} of the largest magnitude"


@pytest.mark.parametrize("n,m,seed", MAPS)
def test_maps_bitwise_equal(n, m, seed):
    for a, b in zip(t_sketch.count_sketch_map(n, m, seed),
                    j_sketch.count_sketch_map(n, m, seed)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for method in ("count", "srht"):
        a = t_sketch.sketch_matrix(method, n, m, seed)
        b = j_sketch.sketch_matrix(method, n, m, seed)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (t_sketch.count_sketch_matrix(n, m, seed).tobytes()
            == j_sketch.count_sketch_matrix(n, m, seed).tobytes())
    assert (t_sketch.srht_matrix(n, m, seed).tobytes()
            == j_sketch.srht_matrix(n, m, seed).tobytes())


@pytest.mark.parametrize("method", ["count", "srht"])
def test_sketched_gram_bitwise_equal(rng, method):
    A = rng.randn(256, 16).astype(np.float32)
    for m in (32, 512):
        assert (t_sketch.sketched_gram(A, m, method=method, seed=3).tobytes()
                == j_sketch.sketched_gram(A, m, method=method,
                                          seed=3).tobytes())


@pytest.mark.parametrize("kw", [
    dict(n_tasks=8, sketch_dim=30, redundancy=2),
    dict(n_tasks=8, sketch_dim=30, redundancy=2, coded=False),
    dict(n_tasks=8, sketch_dim=16, redundancy=1),
    dict(n_tasks=7, sketch_dim=16, redundancy=1),
    dict(n_tasks=8, sketch_dim=16, redundancy=1, scheme="cyclic"),
    dict(n_tasks=64, sketch_dim=512, redundancy=8),
    dict(n_tasks=5, sketch_dim=15, redundancy=1, method="srht", seed=9),
])
def test_plan_structure_bitwise_equal(kw):
    n_rows = 100
    tp = t_sketch.BlockSketch(n_rows, **kw)
    jp = j_sketch.BlockSketch(n_rows, **kw)
    for attr in ("n_blocks", "block_rows", "sketch_dim", "coded"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    for attr in ("B", "buckets", "signs", "_S"):
        a, b = getattr(tp, attr), getattr(jp, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), attr
    assert tp.blocks_per_task() == jp.blocks_per_task()
    for w in range(tp.n_tasks):
        np.testing.assert_array_equal(tp.blocks_of_task(w),
                                      jp.blocks_of_task(w))


def test_plan_errors_match_jax():
    cases = [(dict(n_tasks=4, sketch_dim=10, redundancy=4), "redundancy"),
             (dict(n_tasks=4, sketch_dim=0), "sketch_dim"),
             (dict(n_tasks=0, sketch_dim=10), "n_tasks"),
             (dict(n_tasks=4, sketch_dim=10, method="gauss"),
              "unknown sketch method"),
             (dict(n_tasks=8, sketch_dim=16, scheme="reed"),
              "unknown coding scheme")]
    for kw, msg in cases:
        for mod in (t_sketch, j_sketch):
            with pytest.raises(ValueError, match=msg):
                mod.BlockSketch(100, **kw)
    for mod in (t_sketch, j_sketch):
        with pytest.raises(ValueError, match="srht needs n_rows"):
            mod.srht_matrix(0, 4)
        with pytest.raises(ValueError, match="unknown sketch method"):
            mod.sketch_matrix("gauss", 20, 5, 0)
    plan = t_sketch.BlockSketch(100, 4, sketch_dim=10)
    with pytest.raises(ValueError, match="expected 4 block values"):
        plan.encode(torch.zeros((5, 3)))
    uncoded = t_sketch.BlockSketch(100, 8, sketch_dim=48, redundancy=2,
                                   coded=False)
    with pytest.raises(ValueError, match="ignore-extra-blocks"):
        uncoded.decode_sum(np.arange(5), torch.zeros((5, 3)))


def test_srht_plan_refused_past_its_size():
    """The SRHT plan's dense maps grow as n_tasks x block_rows x n_rows;
    past SRHT_MAX_ELEMENTS the port refuses it, and says why."""
    n = t_sketch.SRHT_MAX_ELEMENTS // 64 + 1
    with pytest.raises(ValueError, match="srht plan would hold"):
        t_sketch.BlockSketch(n, 8, sketch_dim=64, method="srht")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("W,s", PLANS)
@pytest.mark.parametrize("method", ["count", "srht"])
def test_block_algebra_matches_jax(rng, method, W, s, dtype):
    """apply_all, apply_block, block_grams, sketch, gram, the coded
    messages and the decoded Gram under every subset of s dropped blocks,
    against the reference on the same A."""
    A = rng.randn(200, 12).astype(dtype)
    At = torch.as_tensor(A)
    kw = dict(sketch_dim=24, redundancy=s, method=method, seed=7)
    tp = t_sketch.BlockSketch(200, W, **kw)
    with x64():
        jp = j_sketch.BlockSketch(200, W, **kw)
        SA = tp.apply_all(At)
        assert SA.dtype == At.dtype
        close(SA, jp.apply_all(A), dtype, "apply_all")
        close(tp.apply_block(W - 1, At), jp.apply_block(W - 1, A), dtype,
              "apply_block")
        grams = tp.block_grams(At)
        close(grams, jp.block_grams(A), dtype, "block_grams")
        close(tp.sketch(At), jp.sketch(A), dtype, "sketch")
        close(tp.gram(At), jp.gram(A), dtype, "gram")
        msgs_j = jp.encode(np.asarray(jp.block_grams(A)).reshape(W, -1))
        msgs = tp.encode(grams.reshape(W, -1))
        close(msgs, msgs_j, dtype, "encode")
        for drop in itertools.combinations(range(W), s):
            resp = np.array([i for i in range(W) if i not in drop])
            total, n_used = tp.decode_sum(resp, torch.as_tensor(msgs_j[resp]))
            want, n_want = jp.decode_sum(resp, msgs_j[resp])
            assert n_used == n_want
            close(total, want, dtype, f"decode_sum drop={drop}")


def test_uncoded_decode_matches_jax(rng):
    """ignore-extra-blocks: the plain sum of what arrived, and its count."""
    A = rng.randn(200, 12)
    kw = dict(sketch_dim=48, redundancy=2, coded=False, seed=1)
    tp = t_sketch.BlockSketch(200, 8, **kw)
    with x64():
        jp = j_sketch.BlockSketch(200, 8, **kw)
        vals = tp.block_grams(torch.as_tensor(A)).reshape(8, -1)
        assert tp.encode(vals) is vals
        for resp in (np.arange(6), np.arange(2, 8), np.arange(8)):
            total, n = tp.decode_sum(resp, vals[resp])
            want, n_want = jp.decode_sum(resp, vals[resp].numpy())
            assert n == n_want == len(resp)
            close(total, want, "float64", f"uncoded {resp}")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("method", ["count", "srht"])
def test_sparse_rows_equal_dense_rows(dtype, method):
    """(idx, vals) rows with per-row weights sketch to exactly what the
    dense weighted rows give: the count sketch sums each bucket's rows in
    row order on both routes, SRHT densifies."""
    g = torch.Generator().manual_seed(5)
    n, d, k = 300, 40, 4
    idx = torch.stack([torch.randperm(d, generator=g)[:k] for _ in range(n)])
    vals = torch.randn((n, k), generator=g, dtype=getattr(torch, dtype))
    weights = torch.rand((n,), generator=g, dtype=vals.dtype)
    dense = torch.zeros((n, d), dtype=vals.dtype)
    dense.scatter_(1, idx, vals)
    plan = t_sketch.BlockSketch(n, 6, sketch_dim=20, redundancy=1,
                                method=method, seed=3)
    got = plan.apply_all((idx, vals), weights=weights, n_cols=d)
    assert torch.equal(got, plan.apply_all(weights[:, None] * dense))
    assert torch.equal(plan.apply_all(dense, weights=weights), got)
    assert torch.equal(
        plan.apply_block(2, (idx, vals), weights=weights, n_cols=d), got[2])
    with pytest.raises(ValueError, match="n_cols"):
        plan.apply_all((idx, vals))


def test_count_sketch_chunks_equal_one_pass(monkeypatch):
    """The count sketch scatters a few blocks per call at size; the chunk
    boundaries change nothing."""
    g = torch.Generator().manual_seed(2)
    A = torch.randn((90, 7), generator=g, dtype=torch.float64)
    plan = t_sketch.BlockSketch(90, 9, sketch_dim=30, redundancy=2, seed=4)
    whole = plan.apply_all(A)
    monkeypatch.setattr(t_sketch, "SCATTER_CHUNK", 90 * 7 * 2)
    assert torch.equal(plan.apply_all(A), whole)
