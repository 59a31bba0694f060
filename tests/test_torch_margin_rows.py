"""The margin kernel's rows mode: its staging (``problems.base.
stage_sparse_rows``), its plan, its plain version on the CPU, and, on a
card, the kernel itself against that plain version.

The CPU tests hold the staging against ``densify_sparse_rows`` and the
plain version against the batched solver's own masked loss.  The tests
marked ``cuda`` skip without a card; on one they hold the kernel against
its plain version on ragged shapes, in chunks, and at the paper's shapes,
check that two calls and a CUDA graph's replay agree bit for bit, and
count the launches of the batched solver."""
from __future__ import annotations

import pytest
import torch

from repro_torch import problems as t_problems
from repro_torch import trace
from repro_torch.kernels import logistic_vjp as t_lv
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.problems import base as t_base

LOSSES = ("logistic", "hinge")
GAMMA = 0.5


def _ragged_rows(W, N, k, d, *, seed, dup=False, device="cpu",
                 zero_lanes=()):
    """Gather-format rows of W ragged lanes (lane w holds N - w % 3 rows,
    the rest padded as ``batch_shards`` pads them), with ``dup`` a
    repeated index in some rows.  Returns (idx, vals, b, mask)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.stack([torch.stack([torch.randperm(d, generator=g)[:k]
                                    for _ in range(N)]) for _ in range(W)])
    if dup and k > 1:
        idx[:, ::3, 1] = idx[:, ::3, 0]
    vals = torch.randn((W, N, k), generator=g)
    b = torch.where(torch.rand((W, N), generator=g) < 0.5, -1.0, 1.0)
    mask = torch.ones((W, N))
    for w in range(W):
        n = max(0, N - w % 3)
        mask[w, n:] = 0.0
        idx[w, n:] = 0
        vals[w, n:] = 0.0
        b[w, n:] = 0.0
    mask[list(zero_lanes)] = 0.0
    return tuple(t.to(device) for t in (idx, vals, b, mask))


def _plain(loss, idx, vals, b, mask, x):
    if loss == "logistic":
        return t_ref.logistic_vjp_rows_ref(idx, vals, b, mask, x)
    return t_ref.svm_vjp_rows_ref(idx, vals, b, mask, x, GAMMA)


def _fused(loss, rows, x, mask):
    if loss == "logistic":
        return t_ops.fused_logistic_vjp_rows(rows, x, mask=mask)
    return t_ops.fused_svm_vjp_rows(rows, x, gamma=GAMMA, mask=mask)


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W,N,k,d,dup", [(4, 13, 3, 16, False),
                                         (3, 7, 4, 5, True),
                                         (1, 20, 2, 9, True),
                                         (5, 1, 1, 3, False)])
def test_rows_staging_matches_densify(W, N, k, d, dup):
    """col_ptr rises to each lane's nonzero count; entries run by (column,
    row) with no key twice; padded rows are masked and absent from the
    CSC copy; duplicates are summed: the CSC copy is the dense rows that
    ``densify_sparse_rows`` builds, row for row under the mask."""
    idx, vals, b, mask = _ragged_rows(W, N, k, d, seed=W + N + d, dup=dup)
    rows = t_base.stage_sparse_rows(idx, vals, b, mask, d)
    dense = t_base.densify_sparse_rows(idx, vals, d) * mask[..., None]
    assert rows.idx.dtype == rows.col_ptr.dtype == rows.csc_row.dtype \
        == torch.int32
    assert rows.vals.dtype == rows.csc_val.dtype == rows.b.dtype \
        == torch.float32
    assert torch.equal(rows.idx.long(), idx) and torch.equal(rows.vals, vals)
    ptr = rows.col_ptr.long()
    assert torch.all(ptr[:, 0] == 0) and torch.all(ptr[:, 1:] >= ptr[:, :-1])
    for w in range(W):
        n_live = int(mask[w].sum())
        assert torch.all(mask[w, n_live:] == 0)
        assert torch.all(rows.vals[w, n_live:] == 0)
        keys = set()
        for r in range(n_live):
            keys |= {(int(j), r) for j in idx[w, r]}
        assert int(ptr[w, -1]) == len(keys)
        got = torch.zeros((N, d))
        order = []
        for j in range(d):
            lo, hi = int(ptr[w, j]), int(ptr[w, j + 1])
            r = rows.csc_row[w, lo:hi].long()
            assert torch.all(r < n_live)
            got[r, j] = rows.csc_val[w, lo:hi]
            order += [(j, int(x)) for x in r]
        assert order == sorted(keys)
        assert torch.equal(got, dense[w])
        assert torch.all(rows.csc_val[w, int(ptr[w, -1]):] == 0)


def test_rows_staging_sums_duplicates_in_row_order():
    idx = torch.tensor([[[2, 2, 0], [1, 2, 1]]])
    vals = torch.tensor([[[0.5, 0.25, 1.0], [3.0, -1.0, 4.0]]])
    b, mask = torch.ones((1, 2)), torch.ones((1, 2))
    rows = t_base.stage_sparse_rows(idx, vals, b, mask, 3)
    assert rows.col_ptr.tolist() == [[0, 1, 2, 4]]
    assert rows.csc_row[0].tolist() == [0, 1, 0, 1]
    assert rows.csc_val[0].tolist() == [1.0, 7.0, 0.75, -1.0]


def test_rows_staging_refuses_out_of_range_indices():
    idx, vals, b, mask = _ragged_rows(2, 4, 2, 6, seed=1)
    with pytest.raises(ValueError, match="column indices"):
        t_base.stage_sparse_rows(idx, vals, b, mask, 5)


@pytest.mark.parametrize("name", ["logreg", "svm"])
def test_kernel_batch_is_the_rows_staging_cached_per_w(name):
    p = t_problems.make(name, device="cpu", n_samples=50, n_features=16,
                        density=0.2)
    rows, mask = p.kernel_batch_shards(4)
    assert isinstance(rows, t_base.SparseRows)
    assert p.kernel_batch_shards(4)[0] is rows
    (idx, vals, b), m = p.batch_shards(4)
    want = t_base.stage_sparse_rows(idx, vals, b, m, 16)
    for got, exp in zip(rows, want):
        assert torch.equal(got, exp)
    assert torch.equal(mask, m.float())
    # the dense staging keeps a slot of its own beside it
    (A, _), _ = t_base.dense_kernel_batch(p, 4)
    assert A.shape == (4, 13, 16)
    assert p.kernel_batch_shards(4)[0] is rows


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W,n_sms,cluster", [
    (64, 132, 2), (256, 132, 1), (1, 132, 8), (16, 132, 8), (17, 132, 4),
    (32, 132, 4), (33, 132, 4), (34, 132, 2), (66, 132, 2), (67, 132, 1),
    (132, 132, 1), (4, 16, 4), (3, 16, 4), (2, 7, 2)])
def test_rows_cluster_by_w_and_sms(W, n_sms, cluster):
    assert t_lv.rows_cluster(W, n_sms) == cluster
    assert t_lv.rows_plan(W, 100, 1000, n_sms).cluster == cluster


def test_rows_plan_at_the_papers_shapes():
    p64 = t_lv.rows_plan(64, 9375, 10_000, 132)
    assert (p64.cluster, p64.threads, p64.chunk_rows, p64.chunks) == \
        (2, 1024, 9375, 1)
    assert p64.cols == 5000
    p256 = t_lv.rows_plan(256, 2344, 10_000, 132)
    assert (p256.cluster, p256.threads, p256.chunk_rows, p256.chunks) == \
        (1, 512, 2344, 1)
    # two blocks an SM at W = 256: each within half an SM's shared memory
    assert p256.smem_bytes <= t_lv.ROWS_SMEM[512]
    assert p64.smem_bytes <= t_lv.ROWS_SMEM[1024]


def test_rows_plan_chunks_a_lane_too_long_for_shared_memory():
    p = t_lv.rows_plan(1, 600_000, 10_000, 132)
    assert (p.cluster, p.threads) == (8, 1024)
    assert p.smem_bytes <= t_lv.ROWS_SMEM[1024]
    assert p.chunk_rows == (t_lv.ROWS_SMEM[1024] - 40_000) // 4
    assert p.chunks == -(-600_000 // p.chunk_rows) > 1
    # x too wide to leave room for the rows of a chunk
    with pytest.raises(ValueError, match="shared"):
        t_lv.rows_plan(1, 5000, 60_000, 132)
    # wide x: blocks of 1 024, one an SM, even where W x C exceeds the SMs
    assert t_lv.rows_plan(256, 2344, 40_000, 132).threads == 1024
    with pytest.raises(ValueError):
        t_lv.rows_plan(0, 10, 10, 132)


# ---------------------------------------------------------------------------
# the plain version (what a CPU tensor runs)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,loss", [("logreg", "logistic"),
                                       ("svm", "hinge")])
@pytest.mark.parametrize("W", [1, 4])
def test_rows_plain_equals_the_masked_loss(name, loss, W):
    """The ops entry on the CPU (the rows' plain version) against the
    batched solver's masked loss on the same float32 shards, to float32
    rounding (the plain version sums each margin in the kernel's order):
    batched, and with a lane's mask zeroed (exactly 0 there); each lane
    unbatched bit for bit equal to its batched lane."""
    kw = dict(n_samples=50, n_features=16, density=0.2)
    if name == "svm":
        kw["smoothing"] = GAMMA
    p = t_problems.make(name, device="cpu", **kw)
    rows, mask = p.kernel_batch_shards(W)
    batch, m = p.batch_shards(W)
    X = torch.randn((W, 16), generator=torch.Generator().manual_seed(W)) * .4
    whole = p._masked_kernel_loss_value_and_grad(rows, mask)(X)
    for lane_off in ((), (W - 1,)):
        mk, mb = mask.clone(), m.clone()
        mk[list(lane_off)] = 0.0
        mb[list(lane_off)] = 0.0
        f, g = p._masked_kernel_loss_value_and_grad(rows, mk)(X)
        f0, g0 = p._masked_loss_value_and_grad(batch, mb)(X)
        assert f.dtype == g.dtype == torch.float32
        torch.testing.assert_close(f, f0, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(g, g0, rtol=1e-6, atol=1e-6)
        for lane in lane_off:
            assert float(f[lane]) == 0.0 and not torch.any(g[lane] != 0)
    for w in range(W):
        one = t_base.SparseRows(*(t[w] for t in rows))
        f1, g1 = _fused(loss, one, X[w], mask[w])
        assert f1.shape == () and g1.shape == (16,)
        assert torch.equal(f1, whole[0][w]) and torch.equal(g1, whole[1][w])


@pytest.mark.parametrize("loss", LOSSES)
def test_rows_plain_matches_the_dense_plain_version(loss):
    """Over rows with repeated indices: the sparse plain version against
    the dense one on ``densify_sparse_rows``'s matrix."""
    idx, vals, b, mask = _ragged_rows(3, 11, 4, 9, seed=5, dup=True,
                                      zero_lanes=(1,))
    x = torch.randn((3, 9), generator=torch.Generator().manual_seed(2))
    f, g = _plain(loss, idx, vals, b, mask, x)
    A = t_base.densify_sparse_rows(idx, vals, 9)
    f0, g0 = (t_ref.logistic_vjp_ref(A, b, mask, x) if loss == "logistic"
              else t_ref.svm_vjp_ref(A, b, mask, x, GAMMA))
    torch.testing.assert_close(f, f0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g, g0, rtol=1e-5, atol=1e-6)
    assert float(f[1]) == 0.0 and not torch.any(g[1] != 0)


@pytest.mark.parametrize("name,loss", [("logreg", "logistic"),
                                       ("svm", "hinge")])
def test_cuda_kernel_solve_runs_the_rows_plain_version_on_the_cpu(name,
                                                                  loss):
    """solve_all(kernel="cuda") on the CPU is FISTA over the rows' plain
    version, bit for bit, with no launch; and close to kernel="torch"."""
    kw = dict(n_samples=60, n_features=12, density=0.25)
    p = t_problems.make(name, device="cpu", **kw)
    W, d = 4, 12
    g = torch.Generator().manual_seed(7)
    xs, us = torch.randn((W, d), generator=g), torch.randn((W, d),
                                                          generator=g)
    us = us * 0.1
    z = torch.randn((d,), generator=g)
    t_lv.reset_launches()
    x_k, k_k = p.solve_all(xs, us, z, 0.7, kernel="cuda")
    assert set(t_lv.LAUNCHES.values()) == {0}
    rows, mask = p.kernel_batch_shards(W)
    x_p, k_p = t_base.solve_augmented(
        lambda X: _plain(loss, rows.idx, rows.vals, rows.b, mask, X), xs,
        z[None, :] - us, torch.tensor(0.7), p.fixed_inner, p.fista)
    assert torch.equal(x_k, x_p) and k_k.tolist() == k_p.tolist()
    x_t, _ = p.solve_all(xs, us, z, 0.7, kernel="torch")
    torch.testing.assert_close(x_k, x_t, rtol=1e-3, atol=1e-4)


def test_rows_cuda_wrapper_needs_cuda_tensors():
    idx, vals, b, mask = _ragged_rows(2, 5, 2, 6, seed=3)
    rows = t_base.stage_sparse_rows(idx, vals, b, mask, 6)
    with pytest.raises(ValueError, match="CUDA"):
        t_lv.margin_rows_cuda(rows, mask, torch.zeros((2, 6)),
                              loss="logistic")
    with pytest.raises(ValueError, match="unknown"):
        t_lv.margin_rows_cuda(rows, mask, torch.zeros((2, 6)), loss="l2")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rows mode is a CUDA kernel with "
                    "no interpret mode")


def _card_rows(W, N, k, d, seed, dup=False, zero_lanes=()):
    """Rows drawn on the card (a ragged tail per lane; indices drawn with
    replacement, so some rows repeat one), staged, and x."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.randint(0, d, (W * N, k), generator=g, device="cuda")
    idx = idx.view(W, N, k).contiguous()
    if dup and k > 1:
        idx[:, ::3, 1] = idx[:, ::3, 0]
    vals = torch.randn((W, N, k), generator=g, device="cuda")
    b = torch.where(torch.rand((W, N), generator=g, device="cuda") < 0.5,
                    -1.0, 1.0)
    mask = torch.ones((W, N), device="cuda")
    tail = torch.arange(W, device="cuda") % 3
    pad = torch.arange(N, device="cuda")[None, :] >= (N - tail)[:, None]
    mask[pad] = 0.0
    idx[pad] = 0
    vals[pad] = 0.0
    b[pad] = 0.0
    mask[list(zero_lanes)] = 0.0
    x = torch.randn((W, d), generator=g, device="cuda") * 0.2
    return t_base.stage_sparse_rows(idx, vals, b, mask, d), mask, x


def _hold(loss, rows, mask, x):
    """The kernel against its plain version; returns the kernel's result."""
    f, g = t_lv.margin_rows_cuda(rows, mask, x, loss=loss, gamma=GAMMA)
    f0, g0 = _plain(loss, rows.idx, rows.vals, rows.b, mask, x)
    scale_f = max(1.0, float(f0.abs().max()))
    scale_g = max(1.0, float(g0.abs().max()))
    assert float((f - f0).abs().max()) <= 1e-5 * scale_f
    assert float((g - g0).abs().max()) <= 1e-5 * scale_g
    return f, g


@pytest.mark.cuda
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("W,N,k,d,dup,zero", [
    (3, 111, 7, 70, False, (0,)), (2, 300, 10, 129, True, (1,)),
    (130, 17, 3, 64, False, (5,)), (1, 2048, 10, 128, False, ()),
    (1, 1, 1, 5, False, ()), (5, 1001, 10, 10_000, True, (2,)),
    (1, 70_000, 4, 50_000, False, ())])
def test_rows_kernel_matches_plain_on_the_card(loss, W, N, k, d, dup, zero):
    """Ragged lanes, zero-mask lanes (exactly 0), repeated indices, a
    cluster of 8, many lanes to a wave, and a lane in chunks (x of 50 000
    floats leaves room for a few thousand rows); a second call bit for bit
    equal to the first."""
    _need_card()
    rows, mask, x = _card_rows(W, N, k, d, seed=W + N + d, dup=dup,
                               zero_lanes=zero)
    f, g = _hold(loss, rows, mask, x)
    f2, g2 = t_lv.margin_rows_cuda(rows, mask, x, loss=loss, gamma=GAMMA)
    assert torch.equal(f, f2) and torch.equal(g, g2)
    for lane in zero:
        assert float(f[lane]) == 0.0 and not torch.any(g[lane] != 0)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("W", [64, 256])
def test_rows_kernel_at_the_papers_shapes(loss, W):
    """600 000 rows of 10 nonzeros over 10 000 columns in W lanes, against
    the plain version; two calls and a CUDA graph's replay bit for bit."""
    _need_card()
    N = -(-600_000 // W)
    rows, mask, x = _card_rows(W, N, 10, 10_000, seed=W)
    f, g = _hold(loss, rows, mask, x)
    f2, g2 = t_lv.margin_rows_cuda(rows, mask, x, loss=loss, gamma=GAMMA)
    assert torch.equal(f, f2) and torch.equal(g, g2)
    x_in = x.clone()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            f_g, g_g = t_lv.margin_rows_cuda(rows, mask, x_in, loss=loss,
                                             gamma=GAMMA)
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(2):
        x_in.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(f_g, f) and torch.equal(g_g, g)


@pytest.mark.cuda
@pytest.mark.parametrize("name,loss", [("logreg", "logistic"),
                                       ("svm", "hinge")])
def test_solve_all_launches_the_rows_kernel_once_an_evaluation(name, loss):
    """solve_all(kernel="cuda"): one rows-mode launch per ``fista.evals``,
    the dense kernel never; and its iterates close to kernel="torch"."""
    _need_card()
    p = t_problems.make(name, device="cuda", n_samples=20_000,
                        n_features=2_000, density=0.005)
    W, d = 16, 2_000
    g = torch.Generator(device="cuda").manual_seed(3)
    xs = torch.randn((W, d), generator=g, device="cuda") * 0.01
    us = torch.randn((W, d), generator=g, device="cuda") * 0.01
    z = torch.zeros((d,), device="cuda")
    p.kernel_batch_shards(W)
    t_lv.reset_launches()
    trace.enable()
    try:
        with trace.span("round"):
            x_k, _ = p.solve_all(xs, us, z, 1.0, kernel="cuda")
        evals = trace.rounds()[0].counters["fista.evals"]
    finally:
        trace.disable()
        trace.reset()
    assert evals > 0
    assert t_lv.LAUNCHES[f"{loss}_rows"] == evals
    assert t_lv.LAUNCHES["logistic"] == t_lv.LAUNCHES["hinge"] == 0
    x_t, _ = p.solve_all(xs, us, z, 1.0, kernel="torch")
    assert float((x_k - x_t).norm() / x_t.norm()) < 1e-2
