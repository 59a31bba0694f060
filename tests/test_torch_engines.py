"""The slice on the engine suite's logreg instance (``tests/test_engine.py``,
n=50, d=24): every engine/kernel/mode pair of the port against the JAX
package, with shards carried across, and a mid-run rescale.  The
tolerances and their measured gaps are set out in ``test_torch_slice``.
Then the float64 kernel path against the reference's (x64, Pallas in
interpret mode).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import logistic_vjp as t_lv          # noqa: E402
from test_torch_slice import (GOLDEN_KW, PORT_KERNEL,          # noqa: E402
                              assert_traces_close, jax_run, port_run)


GOLDEN_CASES = [
    (4, "loop", "xla", "sync", "flat"),
    (6, "loop", "xla", "drop_slowest", "flat"),
    (4, "batched", "xla", "sync", "flat"),
    (4, "batched", "pallas", "sync", "flat"),
    (4, "batched", "pallas", "sync", "tree"),
    (6, "batched", "pallas", "drop_slowest", "flat"),
    (8, "batched", "pallas", "replicated", "flat"),
]


@pytest.mark.parametrize("W,engine,kernel,mode,fanin", GOLDEN_CASES,
                         ids=["-".join(map(str, c)) for c in GOLDEN_CASES])
def test_engine_instance_matches_jax(W, engine, kernel, mode, fanin):
    """Under drop_slowest the arrival times, and so the one ω the master
    does not wait for, follow the per-worker counts too: a one-iteration
    flip swaps the dropped worker (measured 8.5e-4 on s_norm), so that
    mode's residuals are held at 5e-3."""
    ref, zj, shards = jax_run(GOLDEN_KW, W, engine, kernel, mode=mode,
                              fanin=fanin)
    got, zt = port_run(GOLDEN_KW, W, engine, PORT_KERNEL[kernel], shards,
                       mode=mode, fanin=fanin)
    dropped = mode == "drop_slowest"
    assert_traces_close(ref, got, W, rtol=5e-3 if dropped else 1e-4)
    np.testing.assert_allclose(zt, zj, rtol=1e-4,
                               atol=2e-3 if dropped else 2e-5)
    want_nnz = kernel == "pallas"
    assert all((r["z_nnz"] >= 0) == want_nnz for r in got)


def test_rescale_matches_jax():
    """A mid-run rescale to a W that divides nothing re-stacks (and, on
    the kernel path, re-densifies) the batch."""
    ref, zj, shards = jax_run(GOLDEN_KW, 4, "batched", "pallas",
                              rescale_to=3)
    got, zt = port_run(GOLDEN_KW, 4, "batched", "cuda", shards,
                       rescale_to=3)
    assert [r["n_workers"] for r in got] == [4, 4, 4, 3, 3, 3]
    assert_traces_close(ref, got, 3)
    np.testing.assert_allclose(zt, zj, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("problem,kw", [
    ("logreg", GOLDEN_KW), ("svm", dict(n_samples=50, n_features=16))])
def test_float64_kernel_path_matches_jax_interpret(problem, kw):
    """A float64 problem with kernel="cuda": the margin calls run in
    float32 under the float64 FISTA (the reference casts A, b, mask and x
    to float32 in its wrapper; the port stages A, b and mask in float32
    once and casts x), the z-update takes the plain float64 prox (z_nnz
    -1).  Held at float32's tolerance, the kernel engine's: rtol 1e-4,
    inner_mean 2/W, z atol 1e-4.  Measured: logreg 4.5e-8 (r_norm), svm
    3.5e-5 (r_norm) and 2.5e-5 on z, equal inner counts in both."""
    kw = dict(kw, dtype="float64")
    ref, zj, shards = jax_run(kw, 4, "batched", "pallas", problem=problem,
                              x64=True)
    t_lv.reset_launches()
    got, zt = port_run(kw, 4, "batched", "cuda", shards, problem=problem)
    assert t_lv.LAUNCHES == {"logistic": 0, "hinge": 0,
                             "logistic_rows": 0, "hinge_rows": 0}
    assert_traces_close(ref, got, 4)
    np.testing.assert_allclose(zt, zj, rtol=1e-4, atol=1e-4)
    assert zt.dtype == np.float64
    assert all(r["z_nnz"] == -1 for r in got + ref)
