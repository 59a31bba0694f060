"""Phase-structured (DAG) jobs in the port: ``DagSpec`` validation,
admission, gating, phase against peak reservations, the ``StageResult``
handoff, and ``double_ml`` against the JAX package's.

The DAG machinery is held against the reference by
``test_torch_cluster`` (DAG mixes under both reservations, report for
report); here its own contracts, as ``tests/test_phases.py`` states them
for the reference, on the same small lasso instance (n=64, d=8).

double_ml: the port draws its rows through ``data.threefry`` (normals
within 3 ulp of the reference's) and multiplies them in its own summation
order, so in float32 the stages' data differ from the reference's by a few
ulp and a FISTA stop may move by one iteration.  The debiased estimate
theta-hat is held to the live reference's at 1e-4 relative (measured
3.5e-6 on the tests/test_phases.py DAG); the port's own estimate is
bitwise the same across engines and reruns.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro import api as j_api                                # noqa: E402
from repro import problems as j_problems                      # noqa: E402
from repro import runtime as j_rt                             # noqa: E402
from repro_torch import api as t_api                          # noqa: E402
from repro_torch import problems as t_problems                # noqa: E402
from repro_torch.runtime.cluster import (ENGINES,             # noqa: E402
                                         RESERVATIONS)
from test_torch_cluster import PORT, REF, fingerprint         # noqa: E402

THETA_RTOL = 1e-4


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


KW = dict(n_samples=64, n_features=8)


def _spec(w=2, rounds=1, seed=0, label=""):
    return PORT.Spec(
        problem="lasso", problem_kwargs=KW,
        scheduler=PORT.Sched(
            n_workers=w, replication=1, admm=PORT.Admm(max_iters=rounds),
            pool=PORT.Pool(seed=seed, provider=PORT.Provider())),
        max_rounds=rounds, label=label)


@pytest.fixture(scope="module")
def lasso():
    return t_problems.make("lasso", device="cpu", **KW)


def _stage_problems(dag, problem):
    return {s.name: problem for s in dag.stages}


def _diamond(w_fan=4, w_join=1, rounds=1, join_rounds=None):
    """a -> (b, c) -> d : one fan-out level of width 2."""
    return PORT.Dag(stages=(
        PORT.Stage("a", _spec(w_join, rounds, seed=1, label="a")),
        PORT.Stage("b", _spec(w_fan, rounds, seed=2, label="b"),
                   after=("a",)),
        PORT.Stage("c", _spec(w_fan, rounds, seed=3, label="c"),
                   after=("a",)),
        PORT.Stage("d", _spec(w_join, join_rounds or rounds, seed=4,
                              label="d"), after=("b", "c")),
    ), label="diamond")


# ---------------------------------------------------------------------------
# DagSpec validation and admission
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stages,match", [
    ((), "at least one stage"),
    ((("a", ()), ("a", ())), "duplicate"),
    ((("a", ("ghost",)),), "unknown"),
    ((("a", ("a",)),), "itself"),
    ((("a", ("b",)), ("b", ("a",))), "cycle"),
])
def test_invalid_dags_rejected(stages, match):
    dag = PORT.Dag(stages=tuple(PORT.Stage(n, _spec(), after=a)
                                for n, a in stages))
    with pytest.raises(ValueError, match=match):
        dag.validate()


def test_levels_and_peak_demand_match_reference():
    dag = _diamond(w_fan=4, w_join=1)
    assert dag.validate() == [["a"], ["b", "c"], ["d"]]
    assert dag.peak_demand() == 8        # the fan-out level: 4 + 4
    ref = REF.Dag(stages=tuple(
        REF.Stage(s.name, REF.Spec(scheduler=REF.Sched(
            n_workers=s.spec.scheduler.n_workers)), after=s.after)
        for s in dag.stages))
    assert ref.validate() == dag.validate()
    assert ref.peak_demand() == dag.peak_demand()
    with pytest.raises(ValueError, match="reservation"):
        PORT.cluster(reservation="both")


def test_stage_demand_over_cap_rejects_whole_dag(lasso):
    c = PORT.cluster(max_active_workers=3)
    dag = _diamond(w_fan=4)
    h = c.submit_dag(dag, problems=_stage_problems(dag, lasso))
    assert h.state == "rejected" and "caps at 3" in h.reject_reason
    assert all(j.state == "rejected" for j in h.jobs.values())
    assert c.run_all().report.n_rejected == 4


def test_peak_over_cap_rejected_only_in_peak_mode(lasso):
    dag = _diamond(w_fan=4)              # peak 8, widest single stage 4
    probs = _stage_problems(dag, lasso)
    h = PORT.cluster(max_active_workers=6, reservation="peak").submit_dag(
        dag, problems=probs)
    assert h.state == "rejected" and "peak level demand" in h.reject_reason
    c = PORT.cluster(max_active_workers=6, reservation="phase")
    h2 = c.submit_dag(dag, problems=probs)
    assert h2.state == "queued"
    c.run_all()
    assert h2.state == "done"


def test_async_stage_rejects_whole_dag():
    bad = PORT.Spec(problem="lasso", problem_kwargs=KW,
                    scheduler=PORT.Sched(n_workers=2, replication=1,
                                         mode="async_"))
    dag = PORT.Dag(stages=(PORT.Stage("a", _spec()),
                           PORT.Stage("b", bad, after=("a",))))
    h = PORT.cluster().submit_dag(dag)
    assert h.state == "rejected" and "async" in h.reject_reason


def test_held_stages_not_visible_to_admission(lasso):
    c = PORT.cluster()
    dag = _diamond()
    h = c.submit_dag(dag, problems=_stage_problems(dag, lasso))
    assert h.jobs["a"].state == "queued"
    assert all(h.jobs[n].state == "held" for n in ("b", "c", "d"))
    c.run_all()
    with pytest.raises(RuntimeError, match="already ran"):
        c.submit_dag(_diamond())


# ---------------------------------------------------------------------------
# gating and reservations
# ---------------------------------------------------------------------------


def _run_dags(engine, reservation, problem, *, n_dags=2, w_fan=4, cap=8,
              slots=6, gap=1.0, join_rounds=None):
    c = PORT.cluster(engine=engine, reservation=reservation,
                     max_concurrent_jobs=slots, max_active_workers=cap)
    handles = []
    for i in range(n_dags):
        dag = _diamond(w_fan=w_fan, join_rounds=join_rounds)
        handles.append(c.submit_dag(dag, tenant=f"t{i}", at=gap * i,
                                    problems=_stage_problems(dag, problem)))
    return c, handles, c.run_all()


@pytest.mark.parametrize("reservation", RESERVATIONS)
def test_gating_and_heap_matches_scan(lasso, reservation):
    fps = []
    for engine in ENGINES:
        _, handles, res = _run_dags(engine, reservation, lasso)
        for h in handles:
            assert h.state == "done"
            for s in h.spec.stages:
                for pred in s.after:
                    assert (h.jobs[s.name].started_at
                            >= h.jobs[pred].finished_at)
        fps.append(fingerprint(res))
    assert fps[0] == fps[1]


def test_phase_beats_peak_makespan_and_p50(lasso):
    """Cap equal to one DAG's peak, a staggered stream with a long narrow
    join: peak serializes the DAGs, phase overlaps the next fan-out with
    the current join."""
    kw = dict(n_dags=4, gap=2.0, join_rounds=3)
    _, _, phase = _run_dags("heap", "phase", lasso, **kw)
    _, peaks, peak = _run_dags("heap", "peak", lasso, **kw)
    assert phase.report.makespan_s < peak.report.makespan_s
    assert phase.report.dag_p50_latency_s < peak.report.dag_p50_latency_s
    assert (peaks[1].jobs["a"].started_at
            >= peaks[0].jobs["d"].finished_at)


def test_plain_jobs_byte_identical_across_reservations(lasso):
    fps = []
    for engine in ENGINES:
        for reservation in RESERVATIONS:
            c = PORT.cluster(engine=engine, reservation=reservation,
                             max_concurrent_jobs=2, max_active_workers=6)
            for i in range(6):
                c.submit(_spec(w=2 + 2 * (i % 2), seed=i, label=f"j{i}"),
                         tenant=f"t{i % 2}", at=float(i), problem=lasso)
            fps.append(fingerprint(c.run_all()))
    assert all(fp == fps[0] for fp in fps[1:])


def test_billing_rollup_and_report(lasso):
    _, handles, res = _run_dags("heap", "phase", lasso)
    rep = res.report
    assert rep.n_dags == 2
    assert rep.dag_p95_latency_s >= rep.dag_p50_latency_s > 0
    for h in handles:
        s = h.summary()
        assert set(s["stages"]) == {"a", "b", "c", "d"}
        assert sum(v["cost_usd"] for v in s["stages"].values()) == \
            pytest.approx(h.total_cost_usd)
        assert rep.dag_cost_usd[h.uid] == pytest.approx(h.total_cost_usd)
    assert len(res.to_dict()["dags"]) == 2


def _random_dag(edges_seed, demands):
    """Forward-edge DAG: stage j depends on stage i < j with probability
    0.4 (``tests/test_phases.py``'s generator)."""
    rng = np.random.default_rng(edges_seed)
    stages = []
    for j, w in enumerate(demands):
        after = tuple(f"s{i}" for i in range(j) if rng.random() < 0.4)
        stages.append(PORT.Stage(f"s{j}", _spec(w=w, seed=30 + j,
                                                label=f"s{j}"), after=after))
    return PORT.Dag(stages=tuple(stages), label=f"rand{edges_seed}")


@pytest.mark.parametrize("edges_seed,demands,reservation", [
    (7, (1, 2, 4, 2), "phase"), (1234, (4, 4, 1, 2, 2), "phase"),
    (99, (2, 1, 4), "peak"), (4321, (1, 2, 2, 1, 1), "peak"),
    (5, (2, 2, 1, 4), "peak"),
])
def test_random_dags_heap_scan_and_invariants(lasso, edges_seed, demands,
                                              reservation):
    dag = _random_dag(edges_seed, demands)
    cap = 6
    fps, handles = [], []
    for engine in ENGINES:
        c = PORT.cluster(engine=engine, reservation=reservation,
                         max_concurrent_jobs=4, max_active_workers=cap)
        h = c.submit_dag(dag, problems=_stage_problems(dag, lasso))
        if h.state == "rejected":       # the peak level is over the cap
            assert reservation == "peak" and dag.peak_demand() > cap
            return
        fps.append(fingerprint(c.run_all()))
        handles.append(h)
    assert fps[0] == fps[1]
    h = handles[0]
    jobs = list(h.jobs.values())
    for s in dag.stages:
        for pred in s.after:
            assert h.jobs[s.name].started_at >= h.jobs[pred].finished_at
    for j in jobs:
        t = j.started_at
        if reservation == "phase":
            reserved = sum(k.worker_demand for k in jobs
                           if k.started_at <= t < k.finished_at)
        else:
            first = min(k.started_at for k in jobs)
            last = max(k.finished_at for k in jobs)
            reserved = h.peak_demand if first <= t < last else 0
        assert reserved <= cap


# ---------------------------------------------------------------------------
# double_ml: the StageResult handoff
# ---------------------------------------------------------------------------

DML_KW = dict(n_samples=256, n_features=12, n_folds=2, theta=1.5, seed=5,
              nuisance_workers=2, combine_workers=1, nuisance_rounds=3,
              combine_rounds=3)


def _run_dml(engine, reservation="phase"):
    c = PORT.cluster(engine=engine, reservation=reservation,
                     max_concurrent_jobs=4, max_active_workers=8)
    h = t_api.submit_dag(t_problems.double_ml_dag(**DML_KW), cluster=c,
                         tenant="alice")
    c.run_all()
    return h


@pytest.fixture(scope="module")
def ref_theta():
    """The reference's estimate on the same DAG (float32, partitionable
    threefry)."""
    with jax_config(jax_threefry_partitionable=True):
        c = j_rt.Cluster(j_rt.ClusterConfig(max_concurrent_jobs=4,
                                            max_active_workers=8))
        h = j_api.submit_dag(j_problems.double_ml_dag(**DML_KW), cluster=c,
                             tenant="alice")
        c.run_all()
        naive = j_problems.make(
            "double_ml", role="combine", n_samples=256, n_features=12,
            n_folds=2, theta=1.5, seed=5).closed_form_theta()
    return float(h.stage_results["combine"].z[0]), naive


def test_dml_theta_matches_reference(ref_theta):
    h = _run_dml("heap")
    assert h.state == "done"
    theta = float(h.stage_results["combine"].z[0])
    np.testing.assert_allclose(theta, ref_theta[0], rtol=THETA_RTOL)
    naive = t_problems.make(
        "double_ml", device="cpu", role="combine", n_samples=256,
        n_features=12, n_folds=2, theta=1.5, seed=5).closed_form_theta()
    np.testing.assert_allclose(naive, ref_theta[1], rtol=THETA_RTOL)


def test_dml_handoff_debiases_and_is_deterministic():
    runs = [_run_dml(e, r) for e, r in (("heap", "phase"), ("heap", "phase"),
                                        ("scan", "phase"), ("heap", "peak"))]
    thetas = [float(h.stage_results["combine"].z[0]) for h in runs]
    assert thetas[1:] == thetas[:1] * 3
    combine = runs[0].jobs["combine"]
    for t in ("y", "d"):
        assert np.all(np.abs(combine.problem._beta[t]).sum(axis=1) > 0)
    assert thetas[0] == pytest.approx(combine.problem.closed_form_theta(),
                                      abs=1e-3)
    naive = t_problems.make(
        "double_ml", device="cpu", role="combine", n_samples=256,
        n_features=12, n_folds=2, theta=1.5, seed=5).closed_form_theta()
    assert abs(thetas[0] - 1.5) < abs(naive - 1.5)


@pytest.mark.parametrize("role,target,fold", [
    ("nuisance", "y", 0), ("nuisance", "d", 1), ("combine", "y", 0)])
def test_dml_shards_match_reference(role, target, fold):
    """Stage data against the reference's, float32: X and the targets
    within a few ulp (the normals' 3 ulp, then float32 products in another
    summation order)."""
    kw = dict(n_samples=48, n_features=6, n_folds=3, role=role,
              target=target, fold=fold, seed=11)
    with jax_config(jax_threefry_partitionable=True):
        jp = j_problems.make("double_ml", **kw)
        want = [tuple(np.asarray(a) for a in jp._shard(w, 2))
                for w in range(2)]
        g, m = (np.asarray(a) for a in jp.coefs())
    tp = t_problems.make("double_ml", device="cpu", **kw)
    got = [tuple(a.numpy() for a in tp._shard(w, 2)) for w in range(2)]
    np.testing.assert_array_equal(tp.coefs()[0].numpy() != 0, g != 0)
    np.testing.assert_allclose(tp.coefs()[0].numpy(), g, rtol=1e-6)
    np.testing.assert_allclose(tp.coefs()[1].numpy(), m, rtol=1e-6)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)


def test_dml_kwarg_validation():
    with pytest.raises(ValueError, match="role"):
        t_problems.make("double_ml", device="cpu", role="other")
    with pytest.raises(ValueError, match="target"):
        t_problems.make("double_ml", device="cpu", target="z")
    with pytest.raises(ValueError, match="fold"):
        t_problems.make("double_ml", device="cpu", fold=4, n_folds=4)
    with pytest.raises(ValueError, match="n_folds"):
        t_problems.make("double_ml", device="cpu", n_folds=1)
    with pytest.raises(RuntimeError, match="combine"):
        t_problems.make("double_ml",
                        device="cpu").consume_stage_results({})
