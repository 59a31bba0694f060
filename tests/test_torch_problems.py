"""The port's first-order workloads beyond logreg (svm, lasso, softmax,
logreg_l2), its ω codec and its ADMM driver, against the JAX package in
the same process.

Shards are drawn by both packages from the same seeds (JAX in its
partitionable threefry layout); losses, codecs and solvers get the same
numpy inputs.  Tolerances, with what they were measured against:

* labels and sparse indices (svm, logreg_l2, softmax) bit-identical;
* normal draws within 3 ulp (``test_torch_data``): lasso's A and
  softmax's class means are normal draws (measured 3 ulp); the sparse vals are nu + normal and softmax's A
  is sep·mu_y + noise·normal, so each is held within 3 spacings of the
  normal's magnitude bound (|vals| + 1, |A| + sep·|mu_y|; measured 3.0);
  lasso's b = A x_true + noise·eps inherits A's gap (measured 9.2e-8
  relative, held at 1e-6);
* float32 losses and gradients on carried shards: rtol 1e-5, atol 1e-5
  (summation order only, as ``test_torch_kernels``);
* the codec bit for bit (the same float32 operations in the same order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro import problems as j_problems                      # noqa: E402
from repro.configs.logreg_paper import scaled as j_scaled     # noqa: E402
from repro.core import admm as j_admm                         # noqa: E402
from repro.core import prox as j_prox                         # noqa: E402
from repro.core.fista import FistaOptions as JFista           # noqa: E402
from repro.data import logreg as j_data                       # noqa: E402
from repro.kernels import ops as j_ops                        # noqa: E402
from repro.optim import compression as j_comp                 # noqa: E402
from repro_torch import api as t_api                          # noqa: E402
from repro_torch import problems as t_problems                # noqa: E402
from repro_torch.core import admm as t_admm                   # noqa: E402
from repro_torch.core import prox as t_prox                   # noqa: E402
from repro_torch.core.fista import FistaOptions               # noqa: E402
from repro_torch.kernels import logistic_vjp as t_lv          # noqa: E402
from repro_torch.kernels import ops as t_ops                  # noqa: E402
from repro_torch.optim import compression as t_comp           # noqa: E402
from repro_torch.problems import base as t_base               # noqa: E402
from repro_torch.runtime import PoolConfig, SchedulerConfig   # noqa: E402
from test_problems import SMALL                               # noqa: E402
from test_torch_data import jax_config, partitionable         # noqa: E402
from test_torch_slice import _pallas_mode                     # noqa: E402

NEW = ["lasso", "logreg_l2", "softmax", "svm"]
# tests/test_engine.py::WORKLOADS; logreg_l2 on logreg's instance there
ENGINE_KW = {
    "svm": dict(n_samples=50, n_features=16),
    "lasso": dict(n_samples=50, n_features=16),
    "softmax": dict(n_samples=50, n_features=8, n_classes=3),
    "logreg_l2": dict(n_samples=50, n_features=24, density=0.2),
}
TOL = dict(rtol=1e-5, atol=1e-5)


def test_registry_lists_the_first_order_workloads():
    """The first-order workloads, double_ml (the cluster slice) and, since
    the second-order slice, newton_sketch: every name the reference
    registers."""
    assert t_problems.available() == ["double_ml", "lasso", "logreg",
                                      "logreg_l2", "newton_sketch",
                                      "softmax", "svm"]
    assert t_problems.available() == sorted(j_problems.available())


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------


def _both_shards(name, kw, W, x64=False):
    with jax_config(jax_threefry_partitionable=True, jax_enable_x64=x64):
        pj = j_problems.make(name, **kw)
        sj = [[np.asarray(a) for a in pj._shard(w, W)] for w in range(W)]
    pt = t_problems.make(name, device="cpu", **kw)
    st = [[a.numpy() for a in pt._shard(w, W)] for w in range(W)]
    return pj, pt, sj, st


def _f32(a):
    return np.asarray(a, np.float32)


def _ulps(a, b):
    return np.abs(_f32(a).view(np.int32).astype(np.int64)
                  - _f32(b).view(np.int32).astype(np.int64))


def _within_spacings(got, want, mag, n=3):
    assert np.all(np.abs(got - want) <= n * np.spacing(_f32(mag)))


@pytest.mark.parametrize("name", ["svm", "logreg_l2"])
def test_sparse_shards_match_jax(name):
    """The registry's default instances, W=3: idx and b bit-identical."""
    _, _, sj, st = _both_shards(name, {}, 3)
    for (ij, vj, bj), (it, vt, bt) in zip(sj, st):
        np.testing.assert_array_equal(ij.astype(np.int64), it)
        np.testing.assert_array_equal(bj, bt)
        _within_spacings(vt, vj, np.abs(vj) + 1)


def test_svm_shards_are_logregs():
    """svm reads the logreg generator on the same ``scaled`` config: for
    equal arguments its shards are logreg's."""
    kw = dict(n_samples=300, n_features=40, density=0.1, seed=4)
    svm = t_problems.make("svm", device="cpu", **kw)
    logreg = t_problems.make("logreg", device="cpu", **kw)
    for w in range(3):
        for a, b in zip(svm._shard(w, 3), logreg._shard(w, 3)):
            assert torch.equal(a, b)


def test_lasso_shards_match_jax():
    pj, pt, sj, st = _both_shards("lasso", {}, 3)
    with partitionable():
        xj = np.asarray(pj.x_true())
    np.testing.assert_array_equal(pt.x_true().numpy(), xj)
    assert np.count_nonzero(xj) == round(0.1 * 96)
    for (Aj, bj), (At, bt) in zip(sj, st):
        assert _ulps(At, Aj).max() <= 3
        np.testing.assert_allclose(bt, bj, rtol=1e-6,
                                   atol=1e-6 * np.abs(bj).max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_softmax_shards_match_jax(dtype):
    """Labels bit-identical; a float64 problem draws 64-bit labels, as
    the reference does under jax_enable_x64 (the only way it runs
    float64)."""
    kw = dict(dtype=dtype)
    pj, pt, sj, st = _both_shards("softmax", kw, 3,
                                  x64=dtype == "float64")
    with partitionable():
        mj = np.asarray(pj.class_means())
    assert _ulps(pt.class_means().numpy(), mj).max() <= 3
    for (Aj, yj), (At, yt) in zip(sj, st):
        np.testing.assert_array_equal(yj.astype(np.int64), yt)
        _within_spacings(At, Aj, np.abs(Aj) + 1.5 * np.abs(mj[yt]))
    assert len(np.unique(np.concatenate([s[1] for s in st]))) == 8


# ---------------------------------------------------------------------------
# losses on carried shards
# ---------------------------------------------------------------------------


def _carried(name, W=4):
    """Both problems on the engine instance, the port holding JAX's shards
    (and so the same stacked, padded and densified batches)."""
    kw = ENGINE_KW[name]
    with partitionable():
        pj = j_problems.make(name, **kw)
        for w in range(W):
            pj._shard(w, W)
        shards = {k: tuple(np.asarray(a) for a in v)
                  for k, v in pj._shard_cache.items()}
    pt = t_problems.make(name, device="cpu", **kw)
    t_problems.carry_shards(pt, shards)
    return pj, pt


def _x(d, W=None, seed=0):
    shape = (d,) if W is None else (W, d)
    return (np.random.RandomState(seed).randn(*shape) * 0.3).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **TOL)


@pytest.mark.parametrize("name", NEW)
def test_loss_value_and_grad_on_carried_shards(name):
    """The loop engine's loss (per worker), the batched engine's masked
    loss over the padded stack (W=4 over 50 rows: lanes of 13 and 12),
    and the kernel hook over the kernel's staging (on the CPU the fused
    wrappers run their plain versions; JAX's run its Pallas bodies in
    interpret mode), each at a seeded x."""
    W = 4
    pj, pt = _carried(name, W)
    d = pt.n_features
    for w in range(W):
        x = _x(d, seed=w)
        with partitionable():
            fj = pj.local_value(w, W, jnp.asarray(x))
        _close(pt.local_value(w, W, torch.as_tensor(x)), fj)
        if name != "logreg_l2":          # logreg's loop loss is the data's
            with partitionable():
                fj, gj = pj._loss_value_and_grad(pj._shard(w, W))(
                    jnp.asarray(x))
            ft, gt = pt._loss_value_and_grad(pt._shard(w, W))(
                torch.as_tensor(x))
            _close(ft, fj)
            _close(gt, gj)
    X = _x(d, W, seed=9)
    for kernel, hook_j, hook_t, batch_j, batch_t in (
            ("xla", pj._masked_loss_value_and_grad,
             pt._masked_loss_value_and_grad, pj.batch_shards,
             pt.batch_shards),
            ("pallas", pj._masked_kernel_loss_value_and_grad,
             pt._masked_kernel_loss_value_and_grad, pj.kernel_batch_shards,
             pt.kernel_batch_shards)):
        with partitionable(), _pallas_mode(kernel):
            bj, mj = batch_j(W)
            fj, gj = jax.vmap(lambda s, m, x: hook_j(s, m)(x))(
                bj, mj, jnp.asarray(X))
        bt, mt = batch_t(W)
        ft, gt = hook_t(bt, mt)(torch.as_tensor(X))
        _close(ft, fj)
        _close(gt, gj)


def test_fused_softmax_vjp_matches_jax_wrapper():
    """Unbatched and batched (a zero-mask lane, ragged row masks), against
    ``repro.kernels.ops.fused_softmax_vjp``."""
    rng = np.random.RandomState(3)
    W, N, D, C = 3, 37, 11, 5
    A = rng.randn(W, N, D).astype(np.float32)
    y = rng.randint(0, C, (W, N)).astype(np.int32)
    mask = (rng.rand(W, N) < 0.7).astype(np.float32)
    mask[1] = 0.0
    x = (rng.randn(W, D * C) * 0.2).astype(np.float32)
    fj, gj = j_ops.fused_softmax_vjp(jnp.asarray(A), jnp.asarray(y),
                                     jnp.asarray(x), n_classes=C,
                                     mask=jnp.asarray(mask))
    ft, gt = t_ops.fused_softmax_vjp(torch.as_tensor(A),
                                     torch.as_tensor(y).long(),
                                     torch.as_tensor(x), n_classes=C,
                                     mask=torch.as_tensor(mask))
    _close(ft, fj)
    _close(gt, gj)
    assert float(ft[1]) == 0.0 and not torch.any(gt[1] != 0)
    fj, gj = j_ops.fused_softmax_vjp(jnp.asarray(A[0]), jnp.asarray(y[0]),
                                     jnp.asarray(x[0]), n_classes=C)
    ft, gt = t_ops.fused_softmax_vjp(torch.as_tensor(A[0]),
                                     torch.as_tensor(y[0]).long(),
                                     torch.as_tensor(x[0]), n_classes=C)
    _close(ft, fj)
    _close(gt, gj)


def test_svm_kernel_hook_launches_nothing_on_the_cpu():
    _, pt = _carried("svm")
    t_lv.reset_launches()
    batch, mask = pt.kernel_batch_shards(4)
    pt._masked_kernel_loss_value_and_grad(batch, mask)(
        torch.zeros((4, pt.n_features)))
    assert t_lv.LAUNCHES == {"logistic": 0, "hinge": 0,
                             "logistic_rows": 0, "hinge_rows": 0}
    # the rows mode's staging: (W, N, k) rows and (W, d + 1) column starts
    assert isinstance(batch, t_base.SparseRows)
    k = pt._shard(0, 4)[0].shape[1]
    assert batch.idx.shape == batch.vals.shape == (4, 13, k)
    assert batch.col_ptr.shape == (4, 17)


def test_lasso_direct_solve_matches_jax():
    """The closed form per worker (loop) and stacked (batched), from the
    carried shards' Gram factors: V (Vᵀ rhs)/(λ + ρ) is sign-free."""
    W = 4
    pj, pt = _carried("lasso", W)
    d = pt.n_features
    xs, us, z = _x(d, W, 1), _x(d, W, 2), _x(d, seed=3)
    with partitionable():
        xj, kj = pj.solve_all(jnp.asarray(xs), jnp.asarray(us),
                              jnp.asarray(z), 0.7)
        loop_j = [np.asarray(pj.solve(w, W, jnp.asarray(xs[w]),
                                      jnp.asarray(z), jnp.asarray(us[w]),
                                      0.7)[0]) for w in range(W)]
    xt, kt = pt.solve_all(torch.as_tensor(xs), torch.as_tensor(us),
                          torch.as_tensor(z), 0.7)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4,
                               atol=1e-5)
    assert kt.tolist() == np.asarray(kj).tolist() == [1] * W
    for w in range(W):
        xw, k = pt.solve(w, W, torch.as_tensor(xs[w]), torch.as_tensor(z),
                         torch.as_tensor(us[w]), 0.7)
        assert k == 1
        np.testing.assert_allclose(xw.numpy(), loop_j[w], rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# conformance: the twin of tests/test_problems.py over the new workloads
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=NEW)
def named_problem(request):
    return request.param, t_problems.make(request.param, device="cpu",
                                          **SMALL[request.param])


def test_shard_partition_sums_to_n_samples(named_problem):
    name, p = named_problem
    total = p.n_samples(0, 1)
    assert total > 0
    for W in (2, 3, 4, 7):
        sizes = [p.n_samples(w, W) for w in range(W)]
        assert sum(sizes) == total and min(sizes) > 0, (name, W)


def test_solve_decreases_augmented_objective(named_problem):
    name, p = named_problem
    d = p.n_features
    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.normal(size=d) * 0.1, dtype=torch.float32)
    u = torch.as_tensor(rng.normal(size=d) * 0.05, dtype=torch.float32)
    x0 = torch.zeros(d)

    def aug(x):
        dx = x - (z - u)
        return p.local_value(0, 2, x) + 0.5 * float(torch.dot(dx, dx))

    x_new, iters = p.solve(0, 2, x0, z, u, 1.0)
    assert iters >= 1 and torch.all(torch.isfinite(x_new))
    assert aug(x_new) < aug(x0), name


def test_prox_h_minimizes_h_plus_quadratic(named_problem):
    name, p = named_problem
    d = p.n_features
    rng = np.random.default_rng(1)
    v = torch.as_tensor(rng.normal(size=d), dtype=torch.float32)
    t = 0.3
    pstar = p.prox_h(v, t)

    def F(y):
        dy = y - v
        return p.h_value(y) + float(torch.dot(dy, dy)) / (2 * t)

    f_star = F(pstar)
    assert f_star <= F(v) + 1e-5
    for _ in range(5):
        delta = torch.as_tensor(rng.normal(size=d) * 0.01,
                                dtype=torch.float32)
        assert f_star <= F(pstar + delta) + 1e-5, name


def test_end_to_end_four_workers_converges(named_problem):
    name, p = named_problem
    res = t_api.run(t_api.ExperimentSpec(
        problem=name, problem_kwargs=SMALL[name],
        scheduler=SchedulerConfig(n_workers=4,
                                  admm=t_admm.AdmmOptions(max_iters=12),
                                  pool=PoolConfig(seed=0))), problem=p)
    rs = [t["r_norm"] for t in res.trace]
    assert np.all(np.isfinite(rs))
    assert rs[-1] < rs[1] / 1.5, (name, rs)
    z = torch.as_tensor(res.z)
    assert p.objective(z, 4) < p.objective(torch.zeros_like(z), 4), name


def test_prox_h_matches_jax():
    v = _x(40, seed=5)
    for name in NEW:
        pj = j_problems.make(name, **SMALL[name])
        pt = t_problems.make(name, device="cpu", **SMALL[name])
        got = pt.prox_h(torch.as_tensor(v), 0.3).numpy()
        want = np.asarray(pj.prox_h(jnp.asarray(v), 0.3))
        np.testing.assert_array_equal(got, want)
        assert pt.h_value(torch.as_tensor(v)) == pytest.approx(
            pj.h_value(jnp.asarray(v)), rel=1e-6)
        assert (pt.h_l1_lam is None) == (name == "logreg_l2")


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


TIES = [
    (np.array([1., -1., 1., .5, -1., 2.], np.float32), 2),
    (np.array([1., -1., 1., .5, -1., 2.], np.float32), 3),
    (np.array([0., 0., 0., 0.], np.float32), 2),
    (np.array([3., -3., 3., -3., 3.], np.float32), 4),
    (np.round(np.random.RandomState(0).randn(2, 64) * 2).astype(np.float32),
     9),
    (np.random.RandomState(1).randn(100).astype(np.float32), 200),
]


@pytest.mark.parametrize("x,k", TIES)
def test_topk_mask_breaks_ties_as_lax_top_k(x, k):
    """Entries at the threshold are kept in index order, whatever order a
    top-k routine leaves them in (``lax.top_k`` on the JAX side)."""
    want = np.asarray(j_comp.topk_mask(jnp.asarray(x), k))
    got = t_comp.topk_mask(torch.as_tensor(x), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(got.sum(-1) == min(k, x.shape[-1]))
    cj, rj = j_comp.topk_compress(jnp.asarray(x), k)
    ct, rt = t_comp.topk_compress(torch.as_tensor(x), k)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qsgd_matches_jax(bits):
    """Round half to even on both sides: x/max|x|·s lands on .5 exactly
    for these inputs."""
    s = (1 << (bits - 1)) - 1
    x = np.array([0.5, -0.5, 1.5, 2.5, -2.5, 0.0, 4.0], np.float32) / s * 4
    for v in (x, _x(300, seed=bits), np.zeros(5, np.float32)):
        lj, sj = j_comp.qsgd_compress(jnp.asarray(v), bits)
        lt, st = t_comp.qsgd_compress(torch.as_tensor(v), bits)
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        assert float(st) == float(sj)
        np.testing.assert_array_equal(
            t_comp.qsgd_decompress(lt, st, bits).numpy(),
            np.asarray(j_comp.qsgd_decompress(lj, sj, bits)))


def test_wire_model_matches_jax():
    for d in (1, 24, 10_000):
        assert t_comp.wire_bytes(d, 7) == j_comp.wire_bytes(d, 7)
        assert t_comp.qsgd_bytes(d, 3) == j_comp.qsgd_bytes(d, 3)
        for method in t_comp.METHODS:
            for frac, bits in ((0.05, 4), (0.3, 2)):
                assert t_comp.message_bytes(
                    method, d, topk_frac=frac, qsgd_bits=bits) == \
                    j_comp.message_bytes(method, d, topk_frac=frac,
                                         qsgd_bits=bits)
        assert t_comp.message_bytes("topk", d, topk_k=3) == \
            j_comp.message_bytes("topk", d, topk_k=3)
    with pytest.raises(ValueError):
        t_comp.message_bytes("gzip", 10)


def test_error_feedback_matches_jax():
    xs = np.random.RandomState(2).randn(20, 64).astype(np.float32) * 0.1
    ej, et = j_comp.ef_init(64), t_comp.ef_init(64)
    for x in xs:
        cj, ej = j_comp.ef_compress_update(jnp.asarray(x), ej, 8)
        ct, et = t_comp.ef_compress_update(torch.as_tensor(x), et, 8)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


@pytest.mark.parametrize("method", ["topk", "qsgd"])
def test_omega_codec_matches_jax(method):
    """Rounds of encodes with a rollback of undelivered slots: every view
    equal bit for bit.  A snapshot is a copy: writing into a view the
    codec handed out does not change what a rollback restores."""
    d, WL = 40, 3
    cj = j_comp.OmegaCodec(method, d, topk_frac=0.1, qsgd_bits=3)
    ct = t_comp.OmegaCodec(method, d, topk_frac=0.1, qsgd_bits=3)
    rng = np.random.RandomState(4)
    for rnd in range(5):
        snap_j, snap_t = cj.snapshot(), ct.snapshot()
        kept = {}
        for lw in range(WL):
            om = rng.randn(d).astype(np.float32)
            vj = cj.encode(lw, jnp.asarray(om))
            vt = ct.encode(lw, torch.as_tensor(om))
            np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
            kept[lw] = vt
        delivered = {lw for lw in range(WL) if (lw + rnd) % 3}
        before = {lw: v.clone() for lw, v in snap_t.items()}
        for v in kept.values():
            v.add_(100.0)                    # a careless caller
        cj.rollback_except(snap_j, delivered)
        ct.rollback_except(snap_t, delivered)
        for lw in range(WL):
            if lw not in delivered and lw in before:
                assert torch.equal(ct._sent[lw], before[lw])
            assert (lw in ct._sent) == (lw in cj._sent)
            if lw not in delivered and lw in cj._sent:
                np.testing.assert_array_equal(ct._sent[lw].numpy(),
                                              np.asarray(cj._sent[lw]))
        for lw in delivered:                 # resync the careless writes
            ct._sent[lw] = torch.as_tensor(np.array(cj._sent[lw]))
    ct.reset()
    assert ct._sent == {}


def test_codec_none_passes_omega_and_rejects_unknown():
    c = t_comp.OmegaCodec("none", 5)
    om = torch.arange(5.0)
    assert c.encode(0, om) is om and c.snapshot() == {}
    with pytest.raises(ValueError):
        t_comp.OmegaCodec("gzip", 5)


# ---------------------------------------------------------------------------
# the ADMM driver (core/admm.py)
# ---------------------------------------------------------------------------


def _admm_instance(W=4, n=256, d=24, lam=0.3):
    """tests/test_admm_core.py's instance: dense logreg shards."""
    cfg = j_scaled(n, d, density=0.2, lam1=lam)
    with partitionable():
        shards = [j_data.worker_shard(cfg, w, W) for w in range(W)]
        A = np.stack([np.asarray(s[0]) for s in shards])
        b = np.stack([np.asarray(s[1]) for s in shards])
    return A, b, lam


# rounds held tight: before the first FISTA step whose outcome float32
# rounding decides (a backtracking or monotone test between two nearly
# equal losses; see test_torch_core and PERF.md §7)
ADMM_EARLY = 2


@pytest.mark.parametrize("admm_kw", [dict(max_iters=80),
                                     dict(max_iters=80, mu=2.0)])
def test_admm_solve_matches_jax(admm_kw):
    """float32 throughout, as the reference.  The first ADMM_EARLY rounds
    agree to 1e-5 with equal inner counts (measured 7.0e-8).  Past them,
    at eps_grad=1e-4, single FISTA steps are decided by rounding (its
    tests compare losses of about 44 that differ in the last bits), so the
    two runs drift like two correct float32 runs: measured 17 and 17
    rounds (mu=10), 19 and 16 (mu=2), z within 4.7e-4 and 2.1e-3 of JAX's,
    the objective within 2.6e-7 and 1.5e-6.  Held: rounds within 3, z
    within 1e-2, the objective within 1e-4, every trace entry past the
    last round NaN."""
    A, b, lam = _admm_instance()
    W, d = A.shape[0], A.shape[2]

    def vg_j(xs):
        def one(a, bb, x):
            m = -bb * (a @ x)
            return (jnp.sum(jnp.logaddexp(0.0, m)),
                    a.T @ (-bb * jax.nn.sigmoid(m)))
        return jax.vmap(one)(jnp.asarray(A), jnp.asarray(b), xs)

    At, bt = torch.as_tensor(A), torch.as_tensor(b)

    def vg_t(X):
        m = -bt * torch.bmm(At, X[..., None])[..., 0]
        return (torch.sum(torch.logaddexp(torch.zeros_like(m), m), dim=-1),
                torch.bmm((-bt * torch.sigmoid(m))[:, None, :], At)[:, 0])

    def objective(z):
        m = -b * (A @ np.asarray(z, np.float64))
        return np.logaddexp(0, m).sum() + lam * np.abs(z).sum()

    jo = j_admm.AdmmOptions(fista=JFista(eps_grad=1e-4), **admm_kw)
    zj, mj, trj = j_admm.admm_solve(vg_j, d, W, jo,
                                    lambda v, t: j_prox.prox_l1(v, t, lam))
    to = t_admm.AdmmOptions(fista=FistaOptions(eps_grad=1e-4), **admm_kw)
    zt, mt, trt = t_admm.admm_solve(vg_t, d, W, to,
                                    lambda v, t: t_prox.prox_l1(v, t, lam))
    assert t_admm.converged(mt, to) and mt.k < 80
    assert abs(mt.k - int(mj.k)) <= 3
    for got, want in ((trt.r_norms, trj.r_norms), (trt.s_norms, trj.s_norms),
                      (trt.rhos, trj.rhos)):
        np.testing.assert_allclose(got.numpy()[:ADMM_EARLY],
                                   np.asarray(want)[:ADMM_EARLY], rtol=1e-5,
                                   atol=1e-7)
        assert np.all(np.isnan(got.numpy()[mt.k:]))
        assert not np.any(np.isnan(got.numpy()[:mt.k]))
    np.testing.assert_array_equal(trt.inner_iters.numpy()[:ADMM_EARLY],
                                  np.asarray(trj.inner_iters)[:ADMM_EARLY])
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0,
                               atol=1e-2)
    assert objective(zt.numpy()) == pytest.approx(
        objective(np.asarray(zj)), rel=1e-4)


def test_worker_and_master_round_match_jax():
    A, b, lam = _admm_instance(W=1, n=64, d=8)
    A, b = A[0], b[0]
    x0, u0, z = (np.full(8, v, np.float32) for v in (0.1, 0.01, 0.05))

    def vg_j(x):
        m = -jnp.asarray(b) * (jnp.asarray(A) @ x)
        return (jnp.sum(jnp.logaddexp(0.0, m)),
                jnp.asarray(A).T @ (-jnp.asarray(b) * jax.nn.sigmoid(m)))

    def vg_t(x):
        m = -torch.as_tensor(b) * (torch.as_tensor(A) @ x)
        return (torch.sum(torch.logaddexp(torch.zeros_like(m), m)),
                torch.as_tensor(A).T @ (-torch.as_tensor(b)
                                        * torch.sigmoid(m)))

    for fixed in (7, None):
        sj, qj, oj, kj = j_admm.worker_round(
            vg_j, j_admm.WorkerState(jnp.asarray(x0), jnp.asarray(u0)),
            jnp.asarray(z), jnp.float32(1.0), JFista(), fixed_iters=fixed)
        st, qt, ot, kt = t_admm.worker_round(
            vg_t, t_admm.WorkerState(torch.as_tensor(x0),
                                     torch.as_tensor(u0)),
            torch.as_tensor(z), torch.tensor(1.0), FistaOptions(),
            fixed_iters=fixed)
        assert kt == int(kj) and (fixed is None or kt == fixed)
        for got, want in ((st.x, sj.x), (st.u, sj.u), (qt, qj), (ot, oj)):
            _close(got, want)
    omega = _x(8, seed=6)
    for r, s in ((5.0, 0.1), (0.1, 5.0), (1.0, 1.0)):
        mj = j_admm.init_master(8, 0.5)._replace(z=jnp.asarray(z))
        mt = t_admm.init_master(8, 0.5)._replace(z=torch.as_tensor(z))
        nj = j_admm.master_update(mj, jnp.asarray(omega),
                                  jnp.float32(r * r), 4,
                                  lambda v, t: j_prox.prox_l1(v, t, lam),
                                  j_admm.AdmmOptions(mu=s))
        nt = t_admm.master_update(mt, torch.as_tensor(omega),
                                  torch.tensor(r * r), 4,
                                  lambda v, t: t_prox.prox_l1(v, t, lam),
                                  t_admm.AdmmOptions(mu=s))
        for key in ("z", "z_prev", "rho", "r_norm", "s_norm"):
            _close(getattr(nt, key), getattr(nj, key))
        assert nt.k == int(nj.k) == 1
    assert t_admm.converged(t_admm.init_master(8, 1.0),
                            t_admm.AdmmOptions(max_iters=0))
    assert not t_admm.converged(t_admm.init_master(8, 1.0),
                                t_admm.AdmmOptions())


def test_admm_options_and_states_match_jax():
    assert dataclasses.asdict(t_admm.AdmmOptions()) == dataclasses.asdict(
        j_admm.AdmmOptions())
    assert t_admm.WorkerState._fields == j_admm.WorkerState._fields
    assert t_admm.MasterState._fields == j_admm.MasterState._fields
    assert t_admm.AdmmTrace._fields == j_admm.AdmmTrace._fields
    w = t_admm.init_worker(5)
    assert w.x.shape == (5,) and not torch.any(w.u != 0)


# ---------------------------------------------------------------------------
# the shard cache (REPRO_DATA_CACHE): one format for both packages
# ---------------------------------------------------------------------------


def test_each_package_reads_the_others_shard_cache(tmp_path, monkeypatch):
    """With ``REPRO_DATA_CACHE`` set, logreg's shards go to ``.npz`` files
    of the reference's names and keys.  The port reads the reference's
    files bit for bit (idx widened to its int64) and the reference the
    port's; the two packages write the same names, keys and dtypes (idx
    int32, vals and b float32); and one round on a cache the other package
    wrote equals that package's own round on it, at the slice's trace
    tolerances.  Unset, nothing is written."""
    from test_torch_slice import (GOLDEN_KW, assert_traces_close, jax_run,
                                  port_run)
    W = 4
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    monkeypatch.setenv("REPRO_DATA_CACHE", str(ref_dir))
    j_trace, _, j_shards = jax_run(GOLDEN_KW, W, "loop", "xla", rounds=1)
    t_trace, _ = port_run(GOLDEN_KW, W, "loop", "torch", rounds=1)
    monkeypatch.setenv("REPRO_DATA_CACHE", str(port_dir))
    t_own, _ = port_run(GOLDEN_KW, W, "loop", "torch", rounds=1)
    j_own, _, j_read = jax_run(GOLDEN_KW, W, "loop", "xla", rounds=1)
    names = sorted(p.name for p in ref_dir.iterdir())
    assert len(names) == W
    assert names == sorted(p.name for p in port_dir.iterdir())
    for name in names:
        with np.load(ref_dir / name) as a, np.load(port_dir / name) as b:
            assert sorted(a.files) == sorted(b.files) == ["b", "idx", "vals"]
            assert all(a[k].dtype == b[k].dtype for k in a.files)
            assert a["idx"].dtype == np.int32 and a["b"].dtype == np.float32
    p = t_problems.make("logreg", device="cpu", **GOLDEN_KW)
    monkeypatch.setenv("REPRO_DATA_CACHE", str(ref_dir))
    for w in range(W):
        idx, vals, b = p._load_or_gen(w, W)
        want = j_shards[w, W]
        assert idx.dtype == torch.int64
        for got, ref in zip((idx, vals, b), want):
            assert np.array_equal(got.numpy(), ref)
        wid = f"_w{w}of{W}.npz"
        with np.load(port_dir / next(n for n in names if n.endswith(wid))) \
                as z:
            for got, key in zip(j_read[w, W], ("idx", "vals", "b")):
                assert np.array_equal(got, z[key])
    assert_traces_close(j_trace, t_trace, W)
    assert_traces_close(t_own, j_own, W)
    monkeypatch.delenv("REPRO_DATA_CACHE")
    (tmp_path / "cwd").mkdir()
    monkeypatch.chdir(tmp_path / "cwd")
    port_run(GOLDEN_KW, W, "loop", "torch", rounds=1)
    assert not list((tmp_path / "cwd").iterdir())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cwd", "port",
                                                          "ref"]
    assert len(list(port_dir.iterdir())) == len(list(ref_dir.iterdir())) == W


if __name__ == "__main__":
    # the reference's svm at chip_smoke.py phase 6's size on the CPU (SVM_KW,
    # W=64, the batched engine, 2 rounds, float32): each round's FISTA
    # steps per worker, beside which PERF.md sets phase 6's card figures
    # for the port (about 80 s on an 8-core CPU)
    import json
    from repro.api import ExperimentSpec, run
    from repro.runtime import SchedulerConfig as JCfg
    from test_torch_slice import _chip_smoke
    smoke = _chip_smoke()
    with partitionable():
        res = run(ExperimentSpec(
            problem="svm", problem_kwargs=smoke.SVM_KW,
            scheduler=JCfg(n_workers=smoke.PAPER_W, engine="batched"),
            max_rounds=smoke.PAPER_ROUNDS))
    for m in res.history:
        print(json.dumps(dict(
            round=m.k, r_norm=m.r_norm, s_norm=m.s_norm,
            inner_mean=float(np.mean(m.inner_iters)),
            inner_max=int(np.max(m.inner_iters)),
            inner=np.asarray(m.inner_iters).tolist())))
