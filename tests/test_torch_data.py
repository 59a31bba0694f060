"""The port's data path against the JAX package: threefry draws, shards,
and the logistic value+grad oracles.  Also the port's no-JAX rule.

Inputs are drawn from the same seeds by both packages, or made with numpy
and handed to both.  JAX runs in its partitionable threefry layout, which
the port reproduces (``repro_torch/data/threefry.py``), whatever this
JAX's default is.
"""
import ast
import contextlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.configs.logreg_paper import scaled as j_scaled     # noqa: E402
from repro.data import logreg as j_data                       # noqa: E402
from repro_torch.configs.logreg_paper import scaled           # noqa: E402
from repro_torch.data import logreg as t_data                 # noqa: E402
from repro_torch.data import threefry as tf                   # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def jax_config(**options):
    """Set JAX config options for the enclosed block, then restore them."""
    old = {k: getattr(jax.config, k) for k in options}
    for k, v in options.items():
        jax.config.update(k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            jax.config.update(k, v)


def partitionable():
    return jax_config(jax_threefry_partitionable=True)


def _words(key_data) -> np.ndarray:
    return np.asarray(key_data).astype(np.int64)


SEEDS = [0, 1, 12345]
INDICES = np.array([0, 1, 5, 2047, 600_000, 2**31 + 5], np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_and_split_match_jax(seed):
    with partitionable():
        kj = jax.random.PRNGKey(seed)
        fj = _words(jax.vmap(lambda i: jax.random.fold_in(kj, i))(
            jnp.asarray(INDICES, jnp.uint32)))
        sj = _words(jax.vmap(lambda k: jax.random.split(k, 4))(
            jnp.asarray(fj, jnp.uint32)))
    kt = tf.prng_key(seed)
    assert [int(kt[0]), int(kt[1])] == _words(kj).tolist()
    ft = tf.fold_in(kt, torch.tensor(INDICES))
    np.testing.assert_array_equal(fj, np.stack([w.numpy() for w in ft], -1))
    st = tf.split(ft, 4)
    np.testing.assert_array_equal(sj, np.stack([w.numpy() for w in st], -1))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_bernoulli_bits_match_jax(seed):
    with partitionable():
        keys = jax.vmap(lambda i: jax.random.fold_in(
            jax.random.PRNGKey(seed), i))(jnp.arange(64, dtype=jnp.uint32))
        uj = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (1000,), dtype=jnp.float32))(keys))
        u0j = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, dtype=jnp.float32))(keys))
        bj = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, 0.5))(
            keys))
    kt = tf.fold_in(tf.prng_key(seed), torch.arange(64))
    np.testing.assert_array_equal(uj.view(np.int32),
                                  tf.uniform(kt, 1000).numpy().view(np.int32))
    np.testing.assert_array_equal(u0j, tf.uniform(kt).numpy())
    np.testing.assert_array_equal(bj, tf.bernoulli_half(kt).numpy())


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_normal_within_three_ulp_of_jax():
    """normal = sqrt(2)·erfinv(u): the port evaluates XLA's float32
    polynomial with float64 log1p and single-rounded multiply-adds, which
    lands within 2 ulp of XLA's erfinv and, after the sqrt(2) product,
    within 3 ulp of its normal on the CPU (measured: 3 ulp at most, on
    about 1% of draws); a plain float32 chain missed by up to 2602 ulp
    where it fell on the other side of the polynomial's w = 5 branch."""
    with partitionable():
        keys = jax.vmap(lambda i: jax.random.fold_in(
            jax.random.PRNGKey(7), i))(jnp.arange(32, dtype=jnp.uint32))
        nj = np.asarray(jax.vmap(lambda k: jax.random.normal(
            k, (4000,), dtype=jnp.float32))(keys))
    nt = tf.normal(tf.fold_in(tf.prng_key(7), torch.arange(32)), 4000)
    assert _ulps(nj, nt.numpy()).max() <= 3


@pytest.mark.parametrize("n,d,p,W,w", [(2048, 128, 0.05, 8, 3),
                                       (300, 10_000, 0.001, 2, 1),
                                       (50, 24, 0.2, 4, 0)])
def test_worker_shard_sparse_matches_jax(n, d, p, W, w):
    """idx and b bit-identical; vals = nu + normal carry the normal's few
    ulp (|normal| <= |v| + 1): |Δ| <= 3·spacing(|v| + 1) (measured:
    2·spacing; a count of ulps of v itself reads large where nu and the
    normal cancel)."""
    with partitionable():
        ij, vj, bj = (np.asarray(a) for a in j_data.worker_shard_sparse(
            j_scaled(n, d, density=p), w, W))
    it, vt, bt = (a.numpy() for a in t_data.worker_shard_sparse(
        scaled(n, d, density=p), w, W))
    np.testing.assert_array_equal(ij.astype(np.int64), it)
    np.testing.assert_array_equal(bj, bt)
    assert np.all(np.abs(vj - vt)
                  <= 3 * np.spacing(np.abs(vj) + np.float32(1)))


@pytest.mark.parametrize("n,d,p,W,w", [(2048, 128, 0.05, 8, 3),
                                       (300, 10_000, 0.001, 2, 1),
                                       (50, 24, 0.2, 4, 0)])
def test_worker_shard_dense_matches_jax(n, d, p, W, w):
    """The dense shard: b and the zero pattern of A bit-identical to the
    reference's, A's nonzeros the sparse shard's vals scattered bit for bit
    (so within the normal draw's few ulp of the reference's, as
    ``test_worker_shard_sparse_matches_jax`` bounds them)."""
    with partitionable():
        Aj, bj = (np.asarray(a) for a in j_data.worker_shard(
            j_scaled(n, d, density=p), w, W))
    cfg = scaled(n, d, density=p)
    At, bt = t_data.worker_shard(cfg, w, W)
    assert At.dtype == torch.float32 and tuple(At.shape) == Aj.shape
    np.testing.assert_array_equal(bj, bt.numpy())
    np.testing.assert_array_equal(Aj != 0, At.numpy() != 0)
    idx, vals, _ = t_data.worker_shard_sparse(cfg, w, W)
    assert torch.equal(At.gather(1, idx), vals)
    assert int((At != 0).sum()) == idx.numel()
    At = At.numpy()
    assert np.all(np.abs(Aj - At)
                  <= 3 * np.spacing(np.abs(Aj) + np.float32(1)))


def test_full_objective_matches_jax():
    rng = np.random.RandomState(2)
    shards = [((rng.randn(n, 40) * 0.3).astype(np.float32),
               np.sign(rng.randn(n)).astype(np.float32)) for n in (60, 37)]
    x = (rng.randn(40) * 0.1).astype(np.float32)
    want = j_data.full_objective(
        [(jnp.asarray(A), jnp.asarray(b)) for A, b in shards],
        jnp.asarray(x), 0.7)
    got = t_data.full_objective(
        [(torch.as_tensor(A), torch.as_tensor(b)) for A, b in shards],
        torch.as_tensor(x), 0.7)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_ops_logistic_value_and_grad_is_the_plain_oracle_on_the_cpu():
    """The margin kernel's drop-in on a CPU tensor runs the plain version:
    the value and gradient of ``data.logreg.logistic_value_and_grad`` on
    the same dense shard, to float32 summation order."""
    from repro_torch.kernels import ops
    rng = np.random.RandomState(3)
    A = torch.as_tensor((rng.randn(111, 70) * 0.3).astype(np.float32))
    b = torch.as_tensor(np.sign(rng.randn(111)).astype(np.float32))
    x = torch.as_tensor((rng.randn(70) * 0.1).astype(np.float32))
    f, g = ops.logistic_value_and_grad(A, b)(x)
    fw, gw = t_data.logistic_value_and_grad(A, b)(x)
    np.testing.assert_allclose(float(f), float(fw), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), gw.numpy(), rtol=1e-6, atol=1e-6)


def test_chunked_generation_equals_one_chunk(monkeypatch):
    """Row chunking (how the paper instance is generated on the card) does
    not change a bit."""
    cfg = scaled(100, 64, density=0.1)
    whole = t_data.worker_shard_sparse(cfg, 1, 3)
    monkeypatch.setattr(t_data, "CHUNK_ELEMENTS", 64 * 7)
    chunked = t_data.worker_shard_sparse(cfg, 1, 3)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,W", [(2048, 8), (50, 4), (600_000, 64), (7, 3)])
def test_shard_rows_matches_jax(n, W):
    got = [t_data.shard_rows(n, W, w) for w in range(W)]
    assert got == [j_data.shard_rows(n, W, w) for w in range(W)]
    assert got[0][0] == 0 and got[-1][1] == n


def test_sparse_logistic_value_and_grad_matches_jax():
    rng = np.random.RandomState(0)
    n, d, k = 200, 40, 5
    idx = np.stack([rng.choice(d, k, replace=False) for _ in range(n)])
    vals = rng.randn(n, k).astype(np.float32)
    b = np.sign(rng.randn(n)).astype(np.float32)
    x = (rng.randn(d) * 0.3).astype(np.float32)
    fj, gj = j_data.sparse_logistic_value_and_grad(
        jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(b), d)(
        jnp.asarray(x))
    ft, gt = t_data.sparse_logistic_value_and_grad(
        torch.as_tensor(idx), torch.as_tensor(vals), torch.as_tensor(b), d)(
        torch.as_tensor(x))
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_add_at_sums_in_a_fixed_order(dtype):
    """``add_at`` (the plain sparse path's gradient sum) gives on the CPU
    what one serial pass in element order gives, bit for bit, for a single
    shard and for lanes flattened by ``lane_flat_indices``, every time; it
    leaves the process's deterministic-algorithms setting as it found
    it."""
    rng = np.random.RandomState(1)
    W, N, k, d = 3, 500, 6, 17                 # many duplicate indices
    idx = torch.as_tensor(rng.randint(0, d, (W, N, k)))
    src = torch.as_tensor(rng.randn(W, N, k)).to(dtype)
    want = torch.zeros((W, d), dtype=dtype)
    for w in range(W):                         # the serial pass
        for i, v in zip(idx[w].reshape(-1).tolist(),
                        src[w].reshape(-1).tolist()):
            want[w, i] += v
    got = [t_data.add_at(torch.zeros((W, d), dtype=dtype),
                         t_data.lane_flat_indices(idx, d), src.reshape(-1))
           for _ in range(3)]
    assert all(torch.equal(g, want) for g in got)
    one = t_data.add_at(torch.zeros(d, dtype=dtype), idx[1].reshape(-1),
                        src[1].reshape(-1))
    assert torch.equal(one, want[1])
    for on in (False, True):
        torch.use_deterministic_algorithms(on, warn_only=True)
        try:
            t_data.add_at(torch.zeros(d, dtype=dtype), idx[0].reshape(-1),
                          src[0].reshape(-1))
            assert torch.are_deterministic_algorithms_enabled() is on
            assert torch.is_deterministic_algorithms_warn_only_enabled()
        finally:
            torch.use_deterministic_algorithms(False)


def test_dense_logistic_value_and_grad_matches_jax():
    rng = np.random.RandomState(1)
    A = (rng.randn(111, 70) * 0.3).astype(np.float32)
    b = np.sign(rng.randn(111)).astype(np.float32)
    x = (rng.randn(70) * 0.1).astype(np.float32)
    fj, gj = j_data.logistic_value_and_grad(jnp.asarray(A),
                                            jnp.asarray(b))(jnp.asarray(x))
    ft, gt = t_data.logistic_value_and_grad(torch.as_tensor(A),
                                            torch.as_tensor(b))(
        torch.as_tensor(x))
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the no-JAX rule
# ---------------------------------------------------------------------------


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    twins = sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(twins) == 6
    files += twins
    assert len(files) > 20
    bad = [(f.relative_to(ROOT).as_posix(), m)
           for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"the port imports JAX or the reference: {bad}"
