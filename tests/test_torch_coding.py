"""The port's gradient coding (``repro_torch.core.coding``) against the JAX
package's, live, in the same process.

The constructions and the decode coefficients are numpy in both packages,
so ``B`` (FRS and cyclic, over the reference tests' parameter grids) and
``decode_coeffs`` over every straggler subset must be bitwise equal (or
raise alike: some cyclic subsets cannot decode).  ``encode``/``decode``
combine torch tensors: held to the reference's jnp products elementwise
within ``tol`` times the sum of the terms' magnitudes, ``tol`` 1e-12 in
float64 (x64 on the JAX side) and 2e-6 in float32 (summation order only:
R terms of one rounding each; measured 2.4e-16 and 1.1e-7).
"""
import contextlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from repro.core import coding as j_coding                     # noqa: E402
from repro_torch.core import coding as t_coding               # noqa: E402

FRS_GRID = [(4, 2), (8, 2), (8, 4), (12, 3)]
CYCLIC_GRID = [(W, r) for W in (4, 5, 6, 8, 10, 12, 16, 20)
               for r in (2, 3, 4)]
TOL = {"float64": 1e-12, "float32": 2e-6}


@contextlib.contextmanager
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def coeffs(mod, B, resp):
    """decode_coeffs' bytes, or its error message."""
    try:
        return mod.decode_coeffs(B, resp).tobytes()
    except ValueError as err:
        return str(err)


def assert_sums_close(got, want, a, terms, tol):
    """|got - want| <= tol · Σ_r |a_r| |terms_r|, elementwise."""
    bound = np.abs(a).astype(np.float64) @ np.abs(terms).astype(np.float64)
    assert np.all(np.abs(got.astype(np.float64) - want) <= tol * bound)


def subsets(W, s):
    for drop in itertools.combinations(range(W), s):
        yield np.array([i for i in range(W) if i not in drop])


@pytest.mark.parametrize("W,r", FRS_GRID)
def test_frs_matrix_and_coeffs_bitwise_equal(W, r):
    B = t_coding.frs_matrix(W, r)
    Bj = j_coding.frs_matrix(W, r)
    assert B.dtype == Bj.dtype and np.array_equal(B, Bj)
    assert t_coding._frs_groups(B) is not None
    for resp in subsets(W, r - 1):
        a = t_coding.decode_coeffs(B, resp)
        aj = j_coding.decode_coeffs(Bj, resp)
        assert a.dtype == aj.dtype and a.tobytes() == aj.tobytes()


@pytest.mark.parametrize("W,r", CYCLIC_GRID)
def test_cyclic_matrix_and_coeffs_bitwise_equal(W, r):
    B = t_coding.cyclic_matrix(W, r)
    Bj = j_coding.cyclic_matrix(W, r)
    assert B.dtype == Bj.dtype and B.tobytes() == Bj.tobytes()
    outcomes = [(coeffs(t_coding, B, resp), coeffs(j_coding, Bj, resp))
                for resp in subsets(W, r - 1)]
    assert all(a == b for a, b in outcomes)


@pytest.mark.parametrize("scheme,W,r", [("frs", W, r) for W, r in FRS_GRID]
                         + [("cyclic", W, r) for W, r in FRS_GRID])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_encode_decode_match_jax(scheme, W, r, dtype):
    """Messages and every straggler subset's decoded sum against the
    reference's, on the same numpy gradients."""
    B = (t_coding.frs_matrix(W, r) if scheme == "frs"
         else t_coding.cyclic_matrix(W, r))
    g = np.random.RandomState(W * 10 + r).randn(W, 16).astype(dtype)
    tol = TOL[dtype]
    with x64():
        msgs_j = np.asarray(j_coding.encode(B, jnp.asarray(g)))
        msgs = t_coding.encode(B, torch.as_tensor(g))
        assert msgs.dtype == getattr(torch, dtype)
        assert_sums_close(msgs.numpy(), msgs_j, B, g, tol)
        for resp in subsets(W, r - 1):
            want = np.asarray(j_coding.decode(B, resp,
                                              jnp.asarray(msgs_j[resp])))
            got = t_coding.decode(B, resp, torch.as_tensor(msgs_j[resp]))
            assert_sums_close(got.numpy(), want,
                              j_coding.decode_coeffs(B, resp),
                              msgs_j[resp], tol)


def test_structure_detection_and_errors_match_jax():
    ragged = np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]], np.float32)
    zero_row = np.array([[1, 1, 0], [0, 0, 0], [0, 0, 1]], np.float32)
    for B in (t_coding.frs_matrix(8, 4), np.eye(5, dtype=np.float32),
              t_coding.cyclic_matrix(8, 3), ragged, zero_row):
        assert ((t_coding._frs_groups(B) is None)
                == (j_coding._frs_groups(B) is None))
    for mod in (t_coding, j_coding):
        with pytest.raises(ValueError, match="FRS needs r"):
            mod.frs_matrix(6, 4)
        B = mod.frs_matrix(12, 3)
        resp = np.array([i for i in range(12) if i not in (3, 4, 5)])
        with pytest.raises(ValueError, match="cannot reconstruct"):
            mod.decode_coeffs(B, resp)
        B = mod.cyclic_matrix(8, 3)
        with pytest.raises(ValueError, match="cannot reconstruct"):
            mod.decode_coeffs(B, np.arange(5))
        with pytest.raises(np.linalg.LinAlgError):
            mod._build_cyclic(np.zeros((1, 4)), 4, 2)
        assert mod.max_stragglers(3) == 2


@pytest.mark.parametrize("fails", [2, 9])
def test_cyclic_retry_matches_jax(monkeypatch, fails):
    """Poisoned first attempts: both packages reseed the same way, land on
    the same B, or raise alike when every attempt fails."""
    outcomes = []
    for mod in (t_coding, j_coding):
        real = mod._build_cyclic
        calls = []

        def flaky(H, W, r, _real=real, _calls=calls):
            _calls.append(1)
            if len(_calls) <= fails:
                raise np.linalg.LinAlgError("poisoned attempt")
            return _real(H, W, r)

        monkeypatch.setattr(mod, "_build_cyclic", flaky)
        try:
            outcomes.append(mod.cyclic_matrix(6, 3, max_retries=4).tobytes())
        except ValueError as err:
            outcomes.append(str(err))
    assert outcomes[0] == outcomes[1]
    assert isinstance(outcomes[0], str) == (fails == 9)
