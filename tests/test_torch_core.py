"""The port's solver core against the JAX package: prox operators, the
lane-batched FISTA against ``jax.vmap(fista)``, and the penalty rule.

Inputs are made with numpy from fixed seeds and handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import admm as j_admm                         # noqa: E402
from repro.core import fista as j_fista                       # noqa: E402
from repro.core import prox as j_prox                         # noqa: E402
from repro_torch.core import admm as t_admm                   # noqa: E402
from repro_torch.core import fista as t_fista                 # noqa: E402
from repro_torch.core import prox as t_prox                   # noqa: E402
from test_torch_data import jax_config                        # noqa: E402


def _vec(seed, n=257):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("soft_threshold", (0.37,)), ("prox_l1", (0.5, 0.3)),
    ("prox_l2sq", (0.5, 2.0)), ("prox_zero", (0.5,)),
    ("prox_elastic_net", (0.5, 0.3, 2.0)), ("prox_box", (0.5, -0.2, 0.4)),
])
def test_prox_matches_jax(name, args):
    v = _vec(len(name))
    got = getattr(t_prox, name)(torch.as_tensor(v), *args).numpy()
    want = np.asarray(getattr(j_prox, name)(jnp.asarray(v), *args))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["l1_value", "l2sq_value", "zero_value"])
def test_prox_values_match_jax(name):
    v = _vec(3)
    got = float(getattr(t_prox, name)(torch.as_tensor(v), 0.7))
    want = float(getattr(j_prox, name)(jnp.asarray(v), 0.7))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _lanes(seed, L=5, n=48, d=10):
    """L logistic problems + the augmented quadratic, one per lane."""
    rng = np.random.RandomState(seed)
    A = (rng.randn(L, n, d) * rng.uniform(0.3, 2.0, (L, 1, 1))).astype(
        np.float32)
    b = np.sign(rng.randn(L, n)).astype(np.float32)
    c = (rng.randn(L, d) * 0.1).astype(np.float32)
    rho = np.float32(0.5)
    return A, b, c, rho


def _jax_vg(A, b, c, rho):
    def vg(x):
        m = -b * (A @ x)
        f = jnp.sum(jnp.logaddexp(0.0, m))
        g = A.T @ (-b * jax.nn.sigmoid(m))
        dx = x - c
        return f + 0.5 * rho * jnp.vdot(dx, dx), g + rho * dx
    return vg


def _torch_vg(A, b, c, rho):
    A, b, c = (torch.as_tensor(a) for a in (A, b, c))

    def vg(X):
        m = -b * (A @ X[..., None])[..., 0]
        f = torch.sum(torch.logaddexp(torch.zeros_like(m), m), dim=-1)
        g = ((-b * torch.sigmoid(m))[..., None, :] @ A)[..., 0, :]
        dx = X - c
        return f + 0.5 * rho * torch.sum(dx * dx, dim=-1), g + rho * dx
    return vg


OPTS = [
    dict(min_iters=1, eps_grad=1e-2),
    dict(min_iters=5, eps_grad=1e-2, l0=1e-3),      # forces backtracking
    dict(min_iters=1, eps_grad=1e-3, max_iters=7),  # the iteration cap
]


@pytest.mark.parametrize("opts", OPTS)
def test_batched_fista_matches_vmapped_jax(opts):
    """Every lane's k equals its ``lax.while_loop`` count under vmap, and
    the iterates agree; finished lanes freeze exactly."""
    A, b, c, rho = _lanes(0)
    o_j = j_fista.FistaOptions(**opts)
    xj, sj = jax.vmap(lambda a, bb, cc: j_fista.fista(
        _jax_vg(a, bb, cc, rho), jnp.zeros(10, jnp.float32), o_j))(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
    xt, st = t_fista.fista(_torch_vg(A, b, c, rho),
                           torch.zeros(5, 10), t_fista.FistaOptions(**opts))
    np.testing.assert_array_equal(st.k.numpy(), np.asarray(sj.k))
    assert len(set(st.k.tolist())) > 1 or opts.get("max_iters") == 7
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(st.lip.numpy(), np.asarray(sj.lip))


def _per_lane_vg(A, b, c, rho):
    """Each lane evaluated on its own, so a lane's arithmetic does not
    depend on how many lanes ride along."""
    vgs = [_torch_vg(A[i:i + 1], b[i:i + 1], c[i:i + 1], rho)
           for i in range(len(A))]

    def vg(X):
        out = [f(X[i:i + 1]) for i, f in enumerate(vgs)]
        return (torch.cat([o[0] for o in out]),
                torch.cat([o[1] for o in out]))
    return vg


def test_lanes_equal_single_lane_solves():
    """A lane of a batch and the same problem solved alone agree bit for
    bit: the active-lane mask leaves nothing of the other lanes behind."""
    A, b, c, rho = _lanes(1)
    opts = t_fista.FistaOptions(min_iters=1, eps_grad=1e-2)
    xb, sb = t_fista.fista(_per_lane_vg(A, b, c, rho), torch.zeros(5, 10),
                           opts)
    assert len(set(sb.k.tolist())) > 1
    for lane in range(5):
        x1, s1 = t_fista.fista(
            _per_lane_vg(A[lane:lane + 1], b[lane:lane + 1],
                         c[lane:lane + 1], rho), torch.zeros(1, 10), opts)
        assert int(s1.k[0]) == int(sb.k[lane])
        torch.testing.assert_close(x1[0], xb[lane], rtol=0, atol=0)


def test_fista_fixed_matches_jax():
    """float64: with l0 = 0.01 every lane backtracks, and in float32 the
    sufficient-decrease test near the optimum is decided by rounding
    (measured: 8e-3 relative apart after 12 steps), so the float64 path
    is the one held tight."""
    A, b, c, rho = (a.astype(np.float64) for a in _lanes(2))
    o = dict(l0=0.01)
    with jax_config(jax_enable_x64=True):
        xj, sj = jax.vmap(lambda a, bb, cc: j_fista.fista_fixed(
            _jax_vg(a, bb, cc, rho), jnp.zeros(10, jnp.float64), 12,
            j_fista.FistaOptions(**o)))(jnp.asarray(A), jnp.asarray(b),
                                        jnp.asarray(c))
        xj = np.asarray(xj)
    xt, st = t_fista.fista_fixed(_torch_vg(A, b, c, float(rho)),
                                 torch.zeros(5, 10, dtype=torch.float64), 12,
                                 t_fista.FistaOptions(**o))
    assert st.k.tolist() == [12] * 5
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-10, atol=1e-12)


def test_fista_float64_lanes_match_jax():
    A, b, c, rho = _lanes(3)
    A, b, c = A.astype(np.float64), b.astype(np.float64), c.astype(np.float64)
    opts = dict(min_iters=1, eps_grad=1e-6, eps_fval=1e-14)
    with jax_config(jax_enable_x64=True):
        xj, sj = jax.vmap(lambda a, bb, cc: j_fista.fista(
            _jax_vg(a, bb, cc, float(rho)), jnp.zeros(10, jnp.float64),
            j_fista.FistaOptions(**opts)))(jnp.asarray(A), jnp.asarray(b),
                                           jnp.asarray(c))
        xj, kj = np.asarray(xj), np.asarray(sj.k)
    xt, st = t_fista.fista(_torch_vg(A, b, c, float(rho)),
                           torch.zeros(5, 10, dtype=torch.float64),
                           t_fista.FistaOptions(**opts))
    np.testing.assert_array_equal(st.k.numpy(), kj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("rho,r,s", [(1.0, 5.0, 0.1), (0.5, 0.1, 5.0),
                                     (0.7, 1.0, 1.0), (3.0, 1e-3, 0.0)])
def test_new_penalty_matches_jax(rho, r, s):
    opts = t_admm.AdmmOptions()
    want = float(j_admm.new_penalty(jnp.float32(rho), r, s,
                                    j_admm.AdmmOptions()))
    got = t_admm.new_penalty(rho, r, s, opts)
    assert isinstance(got, np.float32) and float(got) == want


def test_options_defaults_match_jax():
    import dataclasses
    for t_cls, j_cls in [(t_fista.FistaOptions, j_fista.FistaOptions),
                         (t_admm.AdmmOptions, j_admm.AdmmOptions)]:
        t_d = dataclasses.asdict(t_cls())
        j_d = dataclasses.asdict(j_cls())
        assert t_d == j_d
